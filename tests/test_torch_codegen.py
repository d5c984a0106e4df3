"""Parity of the port's generated pipeline (``repro_torch.kernels.codegen``
and ``kernels/l1ball``) with the JAX package's Pallas kernels run in
interpret mode, and the Hopper tile planner.

On the CPU the port's wrappers run each kernel's plain PyTorch version; the
CUDA kernels themselves are held against those versions on the card by
``chip_smoke.py``. Inputs are float32 from a seeded numpy generator, with
ragged n and m. Tolerance: atol = 1e-5 * max|y|, rtol = 1e-5 (64-step
float32 bisection and another summation order move θ by a few ulps).
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import schedule as jschedule
from repro.kernels import codegen as jcodegen
from repro.kernels import l1ball as jl1ball
from repro.kernels import ops as jops
from repro.kernels.codegen import lowering as jlowering
from repro.kernels.codegen import tiling as jtiling
from repro_torch.core import schedule as tschedule
from repro_torch.kernels import codegen as tcodegen
from repro_torch.kernels import l1ball as tl1ball
from repro_torch.kernels import ops as tops
from repro_torch.kernels.codegen import lowering as tlowering
from repro_torch.kernels.codegen import tiling as ttiling
from test_codegen import DESIGNS, EXTRA_DESIGNS

BILEVEL = [("inf", 1), ("1", 1)]
TRILEVEL = [("inf", 1), ("inf", 1), ("1", 1)]

# a handful of designs (interpret mode is slow): bi-, tri-, l1,2, l1,1 with
# the resident l1 apply, the flat solve and depth 4, with ragged n and m
CASES = [
    ("bilevel_ragged", (37, 61), BILEVEL),
    ("trilevel_ragged", (3, 9, 45), TRILEVEL),
    ("l12_ragged", (29, 50), [("2", 1), ("1", 1)]),
    ("l11_ragged", (23, 41), [("1", 1), ("1", 1)]),
    ("flat_l1", (7, 19), [("1", 2)]),
    ("rank4_mixed", (3, 4, 5, 33), [("inf", 1), ("2", 1), ("1", 1), ("1", 1)]),
]


def _rand(shape, name):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    return (rng.normal(size=shape) * 2.0).astype(np.float32)


def _close(got, want, y):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * float(np.abs(y).max()))


@pytest.mark.parametrize("name,shape,levels", CASES)
def test_generate_matches_pallas_interpret(name, shape, levels):
    y = _rand(shape, name)
    sched = tschedule.compile_schedule(shape, levels)
    fn = tlowering.generate(sched, torch.float32, device="cpu")
    radius = 0.3 * float(np.abs(y).sum()) ** 0.5
    got = fn(torch.from_numpy(y), radius)
    want = jcodegen.codegen_project(jnp.asarray(y), levels, radius,
                                    interpret=True)
    _close(got, want, y)


@pytest.mark.parametrize("name,shape,levels", [
    d for d in DESIGNS + EXTRA_DESIGNS if any(q == "1" for q, _ in d[2])])
def test_generate_matches_pallas_interpret_on_nonfinite(name, shape, levels):
    """A NaN, +inf and -inf in Y (where chip_smoke.py's phase 1 puts them in
    item 0) through every design with an ℓ1 level: the same NaN mask as JAX's
    interpret-mode pipeline, the same infinities, finite values within the
    file's tolerance."""
    y = _rand(shape, name)
    flat, m = y.reshape(-1), shape[-1]
    flat[[5 % flat.size, (7 * m + 3) % flat.size, flat.size - 2]] = [
        np.nan, np.inf, -np.inf]
    radius = 0.3 * float(np.nansum(np.abs(y[np.isfinite(y)]))) ** 0.5
    sched = tschedule.compile_schedule(shape, levels)
    got = tlowering.generate(sched, torch.float32, device="cpu")(
        torch.from_numpy(y), radius).numpy()
    want = np.asarray(jcodegen.codegen_project(jnp.asarray(y), levels, radius,
                                               interpret=True))
    assert np.isnan(got).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[np.isinf(want)], want[np.isinf(want)])
    fin = np.isfinite(want)
    assert np.isfinite(got[fin]).all()
    _close(got[fin], want[fin], y[np.isfinite(y)])


@pytest.mark.parametrize("radius", [0.0, 1e6])
def test_generate_edge_radii(radius):
    y = _rand((37, 61), "edge")
    fn = tcodegen.build((37, 61), BILEVEL, torch.float32, device="cpu")
    got = fn(torch.from_numpy(y), radius)
    want = jcodegen.codegen_project(jnp.asarray(y), BILEVEL, radius,
                                    interpret=True)
    _close(got, want, y)


@pytest.mark.parametrize("name,shape,levels", [CASES[0], CASES[1], CASES[3]])
def test_generate_batched_matches_pallas_interpret(name, shape, levels):
    ys = np.stack([_rand(shape, f"{name}{i}") for i in range(3)])
    radii = np.array([0.5, 4.0, 1e6], np.float32)
    sched = tschedule.compile_schedule(shape, levels)
    got = tlowering.generate_batched(sched, torch.float32, device="cpu")(
        torch.from_numpy(ys), torch.from_numpy(radii))
    jsched = jschedule.compile_schedule(shape, levels)
    want = jlowering.generate_batched(jsched, jnp.float32, interpret=True)(
        jnp.asarray(ys), jnp.asarray(radii))
    _close(got, want, ys)
    # in place: out= the stacked input
    buf = torch.from_numpy(ys.copy())
    tcodegen.build_batched(shape, levels, torch.float32, device="cpu")(
        buf, torch.from_numpy(radii), out=buf)
    _close(buf, want, ys)


@pytest.mark.parametrize("name,shape,levels", [CASES[1], CASES[5]])
def test_reduce_and_apply_match_pallas_kernels(name, shape, levels):
    """Each kernel wrapper (plain version here) against its Pallas kernel."""
    y = _rand(shape, name)
    tsched = tschedule.compile_schedule(shape, levels)
    jsched = jschedule.compile_schedule(shape, levels)
    ttp = ttiling.plan_tiles(tsched, torch.float32)
    jtp = jtiling.plan_tiles(jsched, jnp.float32)
    norms = [q for q, _ in tsched.levels]
    yc = y.reshape(ttp.canon_shape)
    aggs, vfin = tlowering.codegen_reduce(torch.from_numpy(yc)[None], ttp,
                                          norms[:-1])
    jaggs, acc = jlowering._reduce_call(jnp.asarray(yc), jtp, norms[:-1], True)
    jvfin = jlowering.MONOIDS[norms[-2]].finalize(acc)
    for a, ja in zip(aggs, jaggs):
        _close(a[0], ja, np.asarray(ja))
    _close(vfin[0], jvfin, np.asarray(jvfin))
    u = np.array(jl1ball.project_l1_pallas(jvfin, 0.4 * float(jvfin.sum()),
                                             interpret=True))
    got = tlowering.codegen_apply(
        torch.from_numpy(yc)[None], [torch.from_numpy(np.array(a))[None]
                                     for a in jaggs],
        torch.from_numpy(np.array(jvfin))[None], torch.from_numpy(u)[None],
        ttp, norms[:-1])
    want = jlowering._apply_call(jnp.asarray(yc), jaggs, jvfin, jnp.asarray(u),
                                 jtp, norms[:-1], True)
    _close(got[0], want, y)


@pytest.mark.parametrize("method", ["bisect", "filter"])
@pytest.mark.parametrize("n", [1, 127, 300])
def test_l1ball_matches_pallas_interpret(method, n):
    v = _rand((3, n), f"l1ball{n}")
    radii = np.array([0.5, float(np.abs(v[1]).sum()) * 0.3,
                      float(np.abs(v[2]).sum()) * 2.0], np.float32)
    got = tl1ball.project_l1_batched(torch.from_numpy(v),
                                     torch.from_numpy(radii), method=method)
    want = jl1ball.project_l1_pallas_batched(jnp.asarray(v), jnp.asarray(radii),
                                             method=method, interpret=True)
    _close(got, want, v)
    one = jl1ball.project_l1_pallas(jnp.asarray(v[1]), float(radii[1]),
                                    method=method, interpret=True)
    _close(got[1], one, v)


def test_tiler_accepts_the_design_matrix_like_jax():
    for name, shape, levels in DESIGNS + EXTRA_DESIGNS:
        t = ttiling.plan_tiles(tschedule.compile_schedule(shape, levels),
                               torch.float32)
        j = jtiling.plan_tiles(jschedule.compile_schedule(shape, levels),
                               jnp.float32)
        assert t is not None and j is not None, name
        assert (t.canon_shape, t.lead, t.n, t.m, t.n_resident) == \
            (j.canon_shape, j.lead, j.n, j.m, j.n_resident), name
        assert tcodegen.supported(shape, levels, torch.float32)
    # the full-width serving shapes
    for shape, levels in [((8192, 2048), BILEVEL), ((256, 32, 2048), TRILEVEL)]:
        tp = ttiling.plan_tiles(tschedule.compile_schedule(shape, levels),
                                torch.float32)
        assert tp is not None and not tp.n_resident and tp.smem_bytes == 0


@pytest.mark.parametrize("shape,levels,dtype", [
    ((2, 2, 2, 3, 8), [("inf", 1)] * 4 + [("1", 1)], jnp.float32),  # depth 5
    ((32, 64), BILEVEL, jnp.bfloat16),                               # type
    ((1601, 8), [("1", 1), ("1", 1)], jnp.float32),    # l1 apply over > 1600 rows
    ((2, 600000), BILEVEL, jnp.float32),                # l1 solve over > 524288
])
def test_tiler_rejects_what_jax_accepts(shape, levels, dtype):
    """The designs the Hopper tiler rejects though JAX's accepts them (the
    list ROADMAP.md keeps)."""
    assert jtiling.plan_tiles(jschedule.compile_schedule(shape, levels),
                              dtype) is not None
    tdtype = getattr(torch, jnp.dtype(dtype).name)
    assert ttiling.plan_tiles(tschedule.compile_schedule(shape, levels),
                              tdtype) is None
    assert not tcodegen.supported(shape, levels, tdtype)
    with pytest.raises(ValueError):
        tcodegen.build(shape, levels, tdtype, device="cpu")


@pytest.mark.parametrize("n,m,batch", [(8192, 2048, 1), (8192, 2048, 8),
                                       (32, 2048, 8), (5, 7, 1), (1, 40, 2)])
def test_row_split_covers_rows_and_fills_the_card(n, m, batch):
    rows, splits = ttiling.row_split(n, m, batch)
    assert rows % ttiling.BLOCK_ROWS == 0
    assert (splits - 1) * rows < n <= splits * rows
    ctas = -(-m // ttiling.BLOCK_M) * batch * splits
    assert ctas >= ttiling.TARGET_CTAS or rows == ttiling.BLOCK_ROWS


def test_build_is_cached_and_ops_match_jax():
    assert tcodegen.build((12, 20), BILEVEL, torch.float32, device="cpu") is \
        tcodegen.build((12, 20), BILEVEL, "float32", device="cpu")
    y = _rand((12, 20), "ops2")
    _close(tops.bilevel_l1inf(torch.from_numpy(y), 3.0),
           jops.bilevel_l1inf(jnp.asarray(y), 3.0), y)
    y3 = _rand((3, 5, 20), "ops3")
    _close(tops.trilevel_l1infinf(torch.from_numpy(y3), 3.0),
           jops.trilevel_l1infinf(jnp.asarray(y3), 3.0), y3)
    _close(tcodegen.codegen_project(torch.from_numpy(y), BILEVEL, 3.0),
           jcodegen.codegen_project(jnp.asarray(y), BILEVEL, 3.0,
                                    interpret=True), y)


def test_ref_oracles_match_jax():
    from repro.kernels import ref as jref
    from repro_torch.kernels import ref as tref

    y = _rand((20, 33), "ref2")
    u = np.abs(_rand((33,), "refu"))
    _close(tref.colmax_ref(torch.from_numpy(y)), jref.colmax_ref(jnp.asarray(y)), y)
    _close(tref.clip_ref(torch.from_numpy(y), torch.from_numpy(u)),
           jref.clip_ref(jnp.asarray(y), jnp.asarray(u)), y)
    _close(tref.bilevel_l1inf_ref(torch.from_numpy(y), 5.0),
           jref.bilevel_l1inf_ref(jnp.asarray(y), 5.0), y)
    y3 = _rand((3, 6, 10), "ref3")
    _close(tref.trilevel_l1infinf_ref(torch.from_numpy(y3), 5.0),
           jref.trilevel_l1infinf_ref(jnp.asarray(y3), 5.0), y3)


def test_generate_folds_schedule_batch_dims_into_the_kernel_batch():
    ys = np.stack([_rand((9, 14), f"bd{i}") for i in range(3)])
    sched = tschedule.compile_schedule(ys.shape, BILEVEL, batch_dims=1)
    got = tlowering.generate(sched, torch.float32, device="cpu")(
        torch.from_numpy(ys), 2.0)
    for i in range(3):
        want = jcodegen.codegen_project(jnp.asarray(ys[i]), BILEVEL, 2.0,
                                        interpret=True)
        _close(got[i], want, ys)
