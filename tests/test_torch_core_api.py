"""The rest of the port's core API against the JAX package: ``ball_norm``,
``bilevel_project_axes``, ``trilevel_l111``, ``work_depth``, the names
``repro_torch.core`` exports, and ``method="auto"`` in the projection hook
(resolved once per hook through the planner).

Inputs are float32 from numpy generators with fixed seeds; the parity
targets are ``tests/test_core_projections.py``'s. Tolerance: 1e-5 absolute
(θ-solvers of other summation orders), the norms within 1e-6 relative,
``work_depth`` exactly (integer and float arithmetic in the same order).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.configs.types import ProjectionSpec as JSpec
from repro.optim import projection_hook as jhook
import repro_torch.core as tcore
from repro_torch.configs.types import ProjectionSpec
from repro_torch.core import plan
from repro_torch.optim import projection_hook as thook

ATOL = 1e-5
METHODS = ("sort", "bisect", "filter", "auto")


def _rand(shape, seed, scale=2.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL)


def test_core_exports_the_jax_names():
    want = {n for n in dir(jcore) if not n.startswith("_")}
    assert want <= set(dir(tcore))


@pytest.mark.parametrize("norm", [1, 2, math.inf, "inf"])
@pytest.mark.parametrize("axis", [-1, 0, 1])
def test_ball_norm(norm, axis):
    y = _rand((7, 9, 5), 31)
    got = tcore.ball_norm(torch.from_numpy(y), norm, axis=axis)
    want = jcore.ball_norm(jnp.asarray(y), norm, axis=axis)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("p,q,inner,shape", [
    (1, math.inf, (0,), (12, 20)),
    (1, 1, (0, 1), (6, 10, 14)),
    (1, 2, (1,), (9, 13)),
    (2, 1, (-1,), (5, 8, 11)),
    (1, math.inf, (0, 2), (4, 7, 6)),
])
def test_bilevel_project_axes(method, p, q, inner, shape):
    plan.clear_cache()
    y = _rand(shape, 18 + len(shape))
    for radius in (0.7, 2.0, 1e3):
        got = tcore.bilevel_project_axes(torch.from_numpy(y), radius, p=p, q=q,
                                         inner_axes=inner, method=method)
        want = jcore.bilevel_project_axes(jnp.asarray(y), radius, p=p, q=q,
                                          inner_axes=inner, method="sort")
        _close(got, want)
    plan.clear_cache()


def test_bilevel_project_axes_auto_under_grad_times_a_grad_key():
    """``auto`` on an input autograd records takes ``best_l1_method``'s
    ``grad`` verdict (forward plus backward timed) and gives JAX's
    gradient; without grad the forward verdict is cached apart."""
    import jax

    plan.clear_cache()
    y = _rand((4, 7, 6), 40)
    cot = _rand((4, 7, 6), 41, 1.0)
    yt = torch.from_numpy(y).requires_grad_(True)
    x = tcore.bilevel_project_axes(yt, 1.3, inner_axes=(0, 2), method="auto")
    dy = torch.autograd.grad((x * torch.from_numpy(cot)).sum(), yt)[0]
    want = jax.grad(lambda v: jnp.sum(jcore.bilevel_project_axes(
        v, 1.3, inner_axes=(0, 2), method="sort") * cot))(jnp.asarray(y))
    _close(dy, want)
    with torch.no_grad():
        tcore.bilevel_project_axes(yt, 1.3, inner_axes=(0, 2), method="auto")
    assert sorted(k.grad for k in plan._L1_WINNERS) == [False, True]
    plan.clear_cache()


def test_bilevel_project_axes_matches_2d():
    y = _rand((12, 20), 18)
    a = tcore.bilevel_l1inf(torch.from_numpy(y), 1.3)
    b = tcore.bilevel_project_axes(torch.from_numpy(y), 1.3, p=1, q=math.inf,
                                   inner_axes=(0,))
    _close(a, b.numpy())


@pytest.mark.parametrize("method", METHODS)
def test_trilevel_l111(method):
    plan.clear_cache()
    t = _rand((3, 8, 10), 23)
    for radius in (0.5, 1.2, 50.0):
        got = tcore.trilevel_l111(torch.from_numpy(t), radius, method=method)
        want = jcore.trilevel_l111(jnp.asarray(t), radius, method="sort")
        _close(got, want)
        norm = tcore.multilevel_norm(got, [(1, 1), (1, 1), (1, 1)])
        assert float(norm) <= radius * (1 + 2e-3)
    with pytest.raises(ValueError, match="order-3"):
        tcore.trilevel_l111(torch.zeros(3, 4), 1.0)
    plan.clear_cache()


@pytest.mark.parametrize("shape,levels", [
    ((64, 64, 64), [(math.inf, 1), (math.inf, 1), (1, 1)]),
    ((1000, 10000), [(math.inf, 1), (1, 1)]),
    ((32, 1000, 2000), [("inf", 1), ("1", 2)]),
    ((9, 11), [(1, 2)]),
    ((3, 4, 5, 32), [("inf", 1), ("2", 1), ("1", 1), ("1", 1)]),
])
def test_work_depth(shape, levels):
    assert tcore.work_depth(shape, levels) == jcore.work_depth(shape, levels)
    with pytest.raises(ValueError):
        tcore.work_depth(shape + (2,), levels)


def _leaves():
    """Two same-shape encoder leaves, a transposed-shape one and a leaf the
    pattern misses."""
    return {"a": {"w": _rand((10, 24), 1)}, "b": {"w": _rand((10, 24), 2)},
            "c": {"w": _rand((24, 10), 3)}, "d": {"bias": _rand((24,), 4)}}


def test_hook_auto_resolves_once():
    """``method="auto"`` asks the planner once per (final-level length,
    dtype, device): two hook calls over two same-shape leaves and a
    transposed-shape leaf run two shoot-outs (lengths 24 and 10), and
    nothing after; each leaf equals JAX's sort projection."""
    plan.clear_cache()
    spec = ProjectionSpec(pattern=r"/w$", radius=1.5, method="auto")
    hook = thook.make_projection_hook(spec)
    params = {k: {n: torch.from_numpy(v) for n, v in leaf.items()}
              for k, leaf in _leaves().items()}
    out = hook(params, 0)
    out = hook(out, 1)
    info = plan.cache_info()
    assert info["autotune_runs"] == 2 and info["autotune_hits"] == 0
    assert sorted(k.shape for k in plan._L1_WINNERS) == [(10,), (24,)]
    jout = jhook.apply_projection(
        {k: {n: jnp.asarray(v) for n, v in leaf.items()}
         for k, leaf in _leaves().items()},
        JSpec(pattern=r"/w$", radius=1.5, method="sort"), 0)
    for k in ("a", "b", "c"):
        _close(out[k]["w"], jout[k]["w"])
    assert torch.equal(out["d"]["bias"], params["d"]["bias"])
    plan.clear_cache()


def test_hook_auto_transpose_reverses_the_trailing_axes():
    """Under ``transpose`` the final level is the leading axis of the leaf:
    a (10, 24) leaf's solver is timed at length 10."""
    plan.clear_cache()
    spec = ProjectionSpec(pattern=r"/w$", radius=1.5, method="auto",
                          transpose=True)
    leaf = _rand((10, 24), 5)
    got = thook.project_tree({"e": {"w": torch.from_numpy(leaf)}}, spec)
    assert [k.shape for k in plan._L1_WINNERS] == [(10,)]
    want = jhook.project_tree({"e": {"w": jnp.asarray(leaf)}},
                              JSpec(pattern=r"/w$", radius=1.5,
                                    method="sort", transpose=True))
    _close(got["e"]["w"], want["e"]["w"])
    plan.clear_cache()


def test_fused_step_auto_matches_the_hook():
    """The fused AdamW+project step resolves ``auto`` through the same
    resolver as the hook: with a zero gradient and lr 0 the step is the
    projection alone."""
    from repro_torch.configs.types import TrainConfig
    from repro_torch.optim import adamw, fused_step

    plan.clear_cache()
    spec = ProjectionSpec(pattern=r"/w$", radius=1.5, method="auto")
    tcfg = TrainConfig(lr=0.0, weight_decay=0.0, grad_clip=0.0, warmup=1,
                       total_steps=1, master_dtype="", projection=spec)
    params = {"a": {"w": torch.from_numpy(_rand((10, 24), 6))}}
    want = thook.project_tree(params, spec)["a"]["w"]
    state = adamw.init(params, tcfg)
    grads = {"a": {"w": torch.zeros(10, 24)}}
    new, _, _ = fused_step.fused_update(
        grads, state, {"a": {"w": params["a"]["w"].clone()}}, tcfg)
    torch.testing.assert_close(new["a"]["w"], want, atol=ATOL, rtol=0)
    assert plan.cache_info()["autotune_runs"] == 1
    plan.clear_cache()


def test_hook_auto_on_a_sharded_leaf_takes_rank_0s_verdict():
    """A sharded leaf's ``auto`` is resolved on its global shape through
    the mesh's ``broadcast_choice`` (rank 0 times, every rank takes its
    verdict), once per hook, apart from the single-device verdicts."""
    plan.clear_cache()

    class OneRankMesh:
        calls = []

        def broadcast_choice(self, choices, pick):
            self.calls.append(list(choices))
            return pick()

    mesh = OneRankMesh()
    resolve = thook._method_resolver(ProjectionSpec(pattern=r"/w$",
                                                    method="auto"))
    for _ in range(2):
        got = resolve((4, 10, 24), torch.float32, "cpu", mesh)
        assert got in ("sort", "bisect", "filter")
    assert mesh.calls == [["bisect", "filter", "sort"]]
    assert resolve((4, 10, 24), torch.float32, "cpu") in ("sort", "bisect",
                                                          "filter")
    assert len(mesh.calls) == 1
    assert plan.cache_info()["autotune_runs"] == 1   # one length, one dtype
    fixed = thook._method_resolver(ProjectionSpec(method="filter"))
    assert fixed((3, 4), torch.float32, "cpu", mesh) == "filter"
    plan.clear_cache()
