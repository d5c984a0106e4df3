"""Gradients through the port's generated pipeline (``repro_torch.kernels.
codegen``): its residual VJP (``codegen/backward.py``) against the JAX
package's, autograd through ``codegen.build``/``build_batched`` against
``jax.grad`` of the sort-oracle schedule, ``grad`` plan keys,
``multilevel_project(method="auto")`` on an input that requires grad, and
the kernels without a backward refusing such an input instead of cutting
it from the graph.

On the CPU the pipeline runs its plain versions under the same
``torch.autograd.Function`` as on the card. Inputs are float32 from numpy
generators seeded with fixed integers (crc32 of the design's name, never
``hash()``). Tolerance: 1e-5 absolute, the bar of
``tests/test_codegen_backward.py``.
"""

import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import multilevel as jmultilevel, schedule as jschedule
from repro.kernels.codegen import backward as jbackward
from repro_torch.core import bilevel, multilevel, plan, schedule
from repro_torch.kernels import codegen, l1ball, plan_backends
from repro_torch.kernels.codegen import backward, lowering, tiling
from test_codegen_backward import DESIGNS, EXTRA_DESIGNS

ALL = DESIGNS + EXTRA_DESIGNS
RADIUS = 1.5
ATOL = 1e-5
BILEVEL = [("inf", 1), ("1", 1)]
TRILEVEL = [("inf", 1), ("inf", 1), ("1", 1)]


def _rand(shape, name, scale=2.0):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _accepted(shape, levels):
    return tiling.plan_tiles(schedule.compile_schedule(shape, levels),
                             torch.float32) is not None


@functools.lru_cache(maxsize=None)
def _oracle_fn(shape, levels):
    sched = jschedule.compile_schedule(shape, levels)

    def loss(v, r, cot):
        return jnp.sum(jschedule.execute(v, sched, r, method="sort") * cot)

    return jax.jit(jax.grad(loss, argnums=(0, 1)))


def _oracle(y, levels, cot, radius=RADIUS):
    """``jax.grad`` of ⟨cot, execute(y, method="sort")⟩ in y and the radius."""
    dy, dr = _oracle_fn(y.shape, tuple(map(tuple, levels)))(
        jnp.asarray(y), jnp.float32(radius), jnp.asarray(cot))
    return np.asarray(dy), float(dr)


def _residuals(ys, levels, radii):
    """The forward's residuals of a bucket ``ys`` in the batched canonical
    layout, from the port's plain versions: ``(norms, stages, u, x)``."""
    sched = schedule.compile_schedule(ys.shape[1:], levels)
    tp = tiling.plan_tiles(sched, torch.float32)
    norms = [q for q, _ in sched.levels]
    yc = torch.from_numpy(ys).reshape((len(ys),) + tp.canon_shape)
    radii = torch.tensor(radii)
    if len(norms) == 1:
        x = l1ball.project_l1_plain(yc, radii)
        return norms, [yc], x, x
    aggs, vfin = lowering.reduce_plain(yc, norms[:-1])
    u = lowering._solve_outer_batched(vfin, norms[-1], radii, "bisect")
    x = lowering.apply_plain(yc, aggs, vfin, u, norms[:-1])
    return norms, [yc, *aggs, vfin], u, x


@pytest.mark.parametrize("name,shape,levels", ALL)
def test_schedule_vjp_matches_jax(name, shape, levels):
    """The port's VJP of a bucket of three items (radii inside and outside
    their balls) against JAX's ``backward.schedule_vjp`` of each item on
    the same residuals and cotangent."""
    ys = np.stack([_rand(shape, f"{name}/{i}") for i in range(3)])
    radii = [RADIUS, 0.3, 1e4]
    norms, stages, u, x = _residuals(ys, levels, radii)
    g = torch.from_numpy(_rand(x.shape, name + "/g", 1.0))
    dy, dr = backward.schedule_vjp(norms, stages, u, x, torch.tensor(radii), g)
    jvjp = jax.jit(functools.partial(jbackward.schedule_vjp, norms))
    for i, r in enumerate(radii):
        want_dy, want_dr = jvjp(
            [jnp.asarray(s[i].numpy()) for s in stages],
            jnp.asarray(u[i].numpy()), jnp.asarray(x[i].numpy()),
            jnp.float32(r), jnp.asarray(g[i].numpy()))
        np.testing.assert_allclose(dy[i].numpy(), np.asarray(want_dy),
                                   atol=ATOL)
        np.testing.assert_allclose(float(dr[i]), float(want_dr), atol=ATOL)


@pytest.mark.parametrize("name,shape,levels", ALL)
def test_build_grad_matches_jax_sort_oracle(name, shape, levels):
    """``torch.autograd.grad`` through ``codegen.build`` (y and a tensor
    radius) equals ``jax.grad`` of the sort-oracle schedule."""
    assert _accepted(shape, levels)
    y = _rand(shape, name)
    cot = _rand(shape, name + "/c", 1.0)
    want_dy, want_dr = _oracle(y, levels, cot)
    fn = codegen.build(shape, levels, torch.float32, device="cpu")
    yt = torch.from_numpy(y).requires_grad_(True)
    rt = torch.tensor(RADIUS, requires_grad=True)
    x = fn(yt, rt)
    assert x.grad_fn is not None
    dy, dr = torch.autograd.grad((x * torch.from_numpy(cot)).sum(), (yt, rt))
    np.testing.assert_allclose(dy.numpy(), want_dy, atol=ATOL)
    np.testing.assert_allclose(float(dr), want_dr, atol=ATOL)


@pytest.mark.parametrize("name,shape,levels", ALL)
def test_build_batched_grad_matches_jax_sort_oracle(name, shape, levels):
    """A bucket of three items with their own radii through
    ``codegen.build_batched``: each item's gradients equal ``jax.grad`` of
    its own sort-oracle schedule."""
    ys = np.stack([_rand(shape, f"{name}/{i}") for i in range(3)])
    cots = np.stack([_rand(shape, f"{name}/{i}/c", 1.0) for i in range(3)])
    radii = [RADIUS, 0.5, 4.0]
    fn = codegen.build_batched(shape, levels, torch.float32, device="cpu")
    yt = torch.from_numpy(ys).requires_grad_(True)
    rt = torch.tensor(radii, requires_grad=True)
    x = fn(yt, rt)
    dy, dr = torch.autograd.grad((x * torch.from_numpy(cots)).sum(), (yt, rt))
    for i, r in enumerate(radii):
        want_dy, want_dr = _oracle(ys[i], levels, cots[i], r)
        np.testing.assert_allclose(dy[i].numpy(), want_dy, atol=ATOL)
        np.testing.assert_allclose(float(dr[i]), want_dr, atol=ATOL)


@pytest.mark.parametrize("name,shape,levels", [
    d for d in ALL if d[0] in ("l1inf_cols", "l1infinf_mid", "l12_rows",
                               "flat_l1", "rank4_mixed")])
def test_backward_never_executes_the_schedule(monkeypatch, name, shape, levels):
    """The backward reads residuals only: with ``schedule.execute`` stubbed
    out, forward and backward still run and give the same gradient."""
    y = torch.from_numpy(_rand(shape, name)).requires_grad_(True)
    fn = codegen.build(shape, levels, torch.float32, device="cpu")
    want = torch.autograd.grad(fn(y, RADIUS).square().sum(), y)[0]

    def stub(*args, **kwargs):
        raise AssertionError("schedule.execute was called")

    monkeypatch.setattr(schedule, "execute", stub)
    got = torch.autograd.grad(fn(y, RADIUS).square().sum(), y)[0]
    assert torch.equal(got, want)


def test_out_with_grad_raises_and_grad_free_calls_are_unchanged():
    fn = codegen.build((8, 16), BILEVEL, torch.float32, device="cpu")
    y = torch.from_numpy(_rand((8, 16), "out"))
    with pytest.raises(ValueError, match="out="):
        fn(y.clone().requires_grad_(True), 1.0, out=torch.empty(8, 16))
    out = torch.empty(8, 16)
    x = fn(y, 1.0, out=out)
    assert x.data_ptr() == out.data_ptr() and x.grad_fn is None
    with torch.no_grad():
        xn = fn(y.clone().requires_grad_(True), 1.0)
    assert xn.grad_fn is None and torch.equal(xn, out)


def test_grad_plan_key():
    """A grad key keeps its own verdict, times forward + backward, offers no
    backend without a backward (``exact_l1inf``), and its plan's output is
    differentiable with JAX's gradient; on a CUDA key ``codegen`` competes
    (availability is a function of the key alone)."""
    plan.clear_cache()
    shape, levels = (12, 20), BILEVEL
    fwd = plan.make_plan(shape, torch.float32, levels, device="cpu")
    trn = plan.make_plan(shape, torch.float32, levels, device="cpu", grad=True)
    assert trn.key.grad and not fwd.key.grad and trn is not fwd
    assert "exact_l1inf" in fwd.timings_us
    assert "exact_l1inf" not in trn.timings_us
    assert set(trn.timings_us) == {"sort", "bisect", "filter"}
    assert plan.cache_info()["auto_winners"] == 2
    y = _rand(shape, "grad_key")
    cot = _rand(shape, "grad_key/c", 1.0)
    yt = torch.from_numpy(y).requires_grad_(True)
    dy = torch.autograd.grad((trn(yt, RADIUS) * torch.from_numpy(cot)).sum(),
                             yt)[0]
    np.testing.assert_allclose(dy.numpy(), _oracle(y, levels, cot)[0],
                               atol=ATOL)
    with pytest.raises(ValueError, match="not available"):
        plan.make_plan(shape, torch.float32, levels, "scalar", "exact_l1inf",
                       device="cpu", grad=True)
    assert plan.make_plan(shape, torch.float32, levels, "scalar",
                          "exact_l1inf", device="cpu").method == "exact_l1inf"
    cuda_key = plan.PlanKey(shape, "float32", plan.canonical_levels(levels),
                            "scalar", "cuda", grad=True)
    assert plan_backends._codegen_available(cuda_key)
    assert not plan._exact_l1inf_available(cuda_key)
    assert plan.best_l1_method(20, torch.float32, device="cpu", grad=True) \
        in ("sort", "bisect", "filter")
    plan.clear_cache()


def test_per_item_backend_under_a_batch_grad_key(monkeypatch):
    """A scalar backend served to a ``radius_kind="batch"`` grad key runs
    per item without ``out=`` (which autograd refuses), so the bucket keeps
    its graph: here the generated pipeline's plain versions, registered as
    a CPU backend."""
    shape = (12, 20)

    def build(key):
        fn = codegen.build(key.shape, key.levels, key.dtype, device="cpu")
        return lambda y, r, out=None: fn(y, r, out=out)

    plan._maybe_register_kernel_backends()
    monkeypatch.setitem(plan._SPECIALIZED, "probe", plan.PlanBackend(
        "probe", lambda key: key.device == "cpu", build))
    p = plan.make_plan(shape, torch.float32, BILEVEL, radius_kind="batch",
                       method="probe", device="cpu", grad=True)
    ys = np.stack([_rand(shape, f"probe/{i}") for i in range(2)])
    cots = np.stack([_rand(shape, f"probe/{i}/c", 1.0) for i in range(2)])
    yt = torch.from_numpy(ys).requires_grad_(True)
    dy = torch.autograd.grad((p(yt, RADIUS) * torch.from_numpy(cots)).sum(),
                             yt)[0]
    for i in range(2):
        np.testing.assert_allclose(dy[i].numpy(),
                                   _oracle(ys[i], BILEVEL, cots[i])[0],
                                   atol=ATOL)
    with torch.no_grad():
        out = torch.empty_like(yt)
        assert p(yt, RADIUS, out=out).data_ptr() == out.data_ptr()
    plan.clear_cache()


@pytest.mark.parametrize("name,shape,levels", [
    ("bilevel", (16, 24), BILEVEL), ("trilevel", (3, 8, 20), TRILEVEL),
    ("l12", (10, 14), [("2", 1), ("1", 1)])])
def test_auto_on_a_tensor_that_requires_grad(name, shape, levels):
    """``multilevel_project(method="auto")`` on an input autograd records
    runs the planner's ``grad`` key (forward plus backward timed) and gives
    JAX's gradient; ``bilevel_project`` goes the same way."""
    plan.clear_cache()
    y = _rand(shape, name)
    cot = _rand(shape, name + "/c", 1.0)
    yt = torch.from_numpy(y).requires_grad_(True)
    x = multilevel.multilevel_project(yt, levels, RADIUS, method="auto")
    assert x.grad_fn is not None and plan.cache_info()["plans"] == 1
    assert [k.grad for k, _ in plan._PLANS] == [True]
    dy = torch.autograd.grad((x * torch.from_numpy(cot)).sum(), yt)[0]
    want = jax.grad(lambda v: jnp.sum(jmultilevel.multilevel_project(
        v, levels, RADIUS, method="sort") * cot))(jnp.asarray(y))
    np.testing.assert_allclose(dy.numpy(), np.asarray(want), atol=ATOL)
    if len(shape) == 2:
        (q, _), (p, _) = levels
        xb = bilevel.bilevel_project(yt, RADIUS, p=int(p), q=float(q),
                                     method="auto")
        db = torch.autograd.grad((xb * torch.from_numpy(cot)).sum(), yt)[0]
        np.testing.assert_allclose(db.numpy(), np.asarray(want), atol=ATOL)
    plan.clear_cache()


def test_auto_with_grad_runs_the_grad_keys_winner(monkeypatch):
    """The ``grad`` key's verdict is what runs: with the generated pipeline
    (its plain versions, registered as a CPU backend) the winner, the
    result carries the pipeline's residual-VJP backward and JAX's gradient;
    without grad the forward key is planned apart."""
    shape = (12, 20)

    def build(key):
        return codegen.build(key.shape, key.levels, key.dtype, device="cpu")

    plan._maybe_register_kernel_backends()
    plan.clear_cache()
    monkeypatch.setitem(plan._SPECIALIZED, "probe", plan.PlanBackend(
        "probe", lambda key: key.device == "cpu" and key.grad, build))
    monkeypatch.setattr(plan, "_autotune", lambda key, names=None: (
        "probe" if key.grad else "sort", {}))
    y = _rand(shape, "auto_probe")
    cot = _rand(shape, "auto_probe/c", 1.0)
    yt = torch.from_numpy(y).requires_grad_(True)
    x = multilevel.multilevel_project(yt, BILEVEL, RADIUS, method="auto")
    fn = x.grad_fn
    while type(fn).__name__ == "ViewBackward0":  # the pipeline's reshapes
        fn = fn.next_functions[0][0]
    assert type(fn).__name__ == "_PipelineBackward"
    dy = torch.autograd.grad((x * torch.from_numpy(cot)).sum(), yt)[0]
    np.testing.assert_allclose(dy.numpy(), _oracle(y, BILEVEL, cot)[0],
                               atol=ATOL)
    with torch.no_grad():
        xn = multilevel.multilevel_project(yt, BILEVEL, RADIUS, method="auto")
    assert xn.grad_fn is None
    assert sorted((k.grad, p.method) for (k, _), p in plan._PLANS.items()) \
        == [(False, "sort"), (True, "probe")]
    plan.clear_cache()


# --------------------------------------------------------------------------- #
# The CUDA branches, reached with meta tensors and stand-in launches
# --------------------------------------------------------------------------- #


@pytest.fixture
def launches(monkeypatch):
    """Every kernel's export bound to a stand-in that counts its calls, and
    the CUDA gate opened for meta tensors (``test_torch_no_fallback.py``'s
    launch-path stand-ins)."""
    from test_torch_no_fallback import _reach_the_launch, _stand_in

    from repro_torch.kernels import _build

    _reach_the_launch(monkeypatch)
    calls = {}
    for name, kern in _build.KERNELS.items():
        if len(kern.functions) == 1:
            calls[name] = _stand_in(monkeypatch, kern, 0)[1]
    return calls


def _meta(*shape):
    return torch.empty(shape, device="meta")


def test_golden_wrappers_and_l1ball_refuse_an_input_that_requires_grad(launches):
    """On the card each kernel without a backward raises on an input
    autograd would record, and launches nothing; under ``no_grad`` the same
    call launches once."""
    from repro_torch.kernels import bilevel_l1inf as bi, trilevel_l1infinf as tri

    y2, y3 = _meta(8, 16), _meta(3, 8, 16)
    v2, u = _meta(8, 16), _meta(16)
    cases = [
        ("colmax", lambda t: bi.colmax(t), lambda: (y2,)),
        ("clip", lambda t, w: bi.clip(t, w), lambda: (y2, u)),
        ("trilevel_reduce", lambda t: tri.trilevel_reduce(t), lambda: (y3,)),
        ("trilevel_apply", lambda t, a, w: tri.trilevel_apply(t, a, w),
         lambda: (y3, v2, u)),
        ("l1ball", lambda t, r: l1ball.project_l1_batched(t, r),
         lambda: (_meta(2, 16), _meta(2))),
        ("l1ball", lambda t: l1ball.project_l1(t, 1.0), lambda: (_meta(16),)),
        ("l1ball", lambda t, r: l1ball.project_l1(t, r),
         lambda: (_meta(16), _meta())),
    ]
    for kernel, call, args in cases:
        for i in range(len(args())):
            ops = list(args())
            ops[i] = ops[i].clone().requires_grad_(True)
            before = len(launches[kernel])
            with pytest.raises(ValueError, match="no backward.*codegen"):
                call(*ops)
            assert len(launches[kernel]) == before
            with torch.no_grad():
                call(*ops)
            assert len(launches[kernel]) == before + 1, kernel
    for fused, y in ((bi.bilevel_l1inf_fused, y2),
                     (tri.trilevel_l1infinf_fused, y3)):
        total = sum(map(len, launches.values()))
        with pytest.raises(ValueError, match="no backward"):
            fused(y.clone().requires_grad_(True), 1.0)
        assert sum(map(len, launches.values())) == total


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("levels,shape", [(BILEVEL, (8, 16)),
                                          (TRILEVEL, (3, 8, 16)),
                                          ([("1", 2)], (8, 16))])
def test_generated_pipeline_on_the_card_keeps_the_graph(monkeypatch, launches,
                                                        batched, levels, shape):
    """The generated pipeline's CUDA branch on an input that requires grad:
    the same launches as without grad (the outer ``l1ball`` included, under
    the Function's grad-free forward), and a result with a ``grad_fn``
    whose backward gives y and the radius their cotangents."""
    from repro_torch import _device

    monkeypatch.setattr(_device, "resolve", lambda device=None: torch.device("meta"))
    sched = schedule.compile_schedule(shape, levels)
    gen = lowering.generate_batched if batched else lowering.generate
    fn = gen(sched, torch.float32)
    y = _meta(2, *shape) if batched else _meta(*shape)
    r = _meta(2) if batched else _meta()
    names = ["l1ball"] if len(levels) == 1 else ["codegen_reduce", "l1ball",
                                                 "codegen_apply"]

    def counts():
        return [len(launches[k]) for k in names]

    start = counts()
    x = fn(y, r)
    plain_counts = counts()
    assert x.grad_fn is None and [b - a for a, b in zip(start, plain_counts)] \
        == [1] * len(names)
    yg, rg = y.clone().requires_grad_(True), r.clone().requires_grad_(True)
    xg = fn(yg, rg)
    assert xg.grad_fn is not None and xg.shape == y.shape
    assert [b - a for a, b in zip(plain_counts, counts())] == [1] * len(names)
    dy, dr = torch.autograd.grad(xg.sum(), (yg, rg))
    assert dy.shape == y.shape and dr.shape == r.shape
    assert counts() == [c + 1 for c in plain_counts]  # backward launches none
