"""The partial apply (kernel row 9: JAX ``_partial_apply_call``, the port's
``codegen_partial_apply``) against the JAX package.

The mesh executor resumes the apply chain at level L-2 from radii ``w``
solved across ranks. Here the same numpy inputs go through JAX's
``_partial_apply_call`` in interpret mode and the port's wrapper, which on a
CPU tensor runs its plain version (``partial_apply_plain``): the aggregates
come from JAX's ``_reduce_call`` (interpret mode), ``w`` is a random
non-negative tensor shaped like the last aggregate, and the tile plan is
JAX's. Tolerance: atol 1e-6 (ℓ1 groups bisect 64 steps in float32, in
another summation order).
"""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from repro.core.schedule import compile_schedule as jax_compile  # noqa: E402
from repro.kernels.codegen import lowering as jax_lowering  # noqa: E402
from repro.kernels.codegen.tiling import plan_tiles as jax_plan_tiles  # noqa: E402
from repro_torch.core.schedule import compile_schedule  # noqa: E402
from repro_torch.kernels.codegen import lowering, tiling  # noqa: E402

CASES = [
    ("l1l1inf", (4, 16, 64), (("inf", 1), ("1", 1), ("1", 1))),
    ("l2l1l1", (16, 8, 256), (("2", 1), ("1", 1), ("1", 1))),
    ("l1l1infinf", (2, 4, 8, 64), (("inf", 1), ("inf", 1), ("1", 1), ("1", 1))),
]


def _inputs(shape, levels, seed):
    rng = np.random.default_rng(seed)
    y = (rng.normal(size=shape) * 2).astype(np.float32)
    sched = jax_compile(shape, levels)
    tp = jax_plan_tiles(sched, jnp.float32)
    assert tp is not None
    norms = [q for q, _ in sched.levels]
    yc = jnp.asarray(y.reshape(tp.canon_shape))
    aggs, _ = jax_lowering._reduce_call(yc, tp, norms[:-1], True)
    aggs = [np.array(a) for a in aggs]
    # radii around the groups' own norms: some groups shrink, some stay
    w = (rng.uniform(0.0, 1.5, size=aggs[-1].shape)
         * aggs[-1].mean()).astype(np.float32)
    return y, tp, norms, aggs, w


@pytest.mark.parametrize("name,shape,levels", CASES)
def test_partial_apply_matches_jax(name, shape, levels):
    y, jtp, norms, aggs, w = _inputs(shape, levels, seed=len(name))
    want = np.asarray(jax_lowering._partial_apply_call(
        jnp.asarray(y.reshape(jtp.canon_shape)), [jnp.asarray(a) for a in aggs],
        jnp.asarray(w), jtp, norms[:-1], True))
    tp = tiling.plan_tiles(compile_schedule(shape, levels), torch.float32)
    assert tp.canon_shape == jtp.canon_shape and tp.lead == jtp.lead
    got = lowering.codegen_partial_apply(
        torch.from_numpy(y.reshape((1,) + tp.canon_shape)),
        [torch.from_numpy(a)[None] for a in aggs], torch.from_numpy(w)[None],
        tp, norms[:-1])
    np.testing.assert_allclose(got[0].numpy(), want, atol=1e-6)
    # the chain really moved Y: some groups were cut
    assert np.abs(want - y.reshape(jtp.canon_shape)).max() > 1e-3


@pytest.mark.parametrize("name,shape,levels", CASES)
def test_apply_is_partial_apply_after_the_last_level(name, shape, levels):
    # apply_plain = the level-(L-1) shrink, then partial_apply_plain: the
    # port's full apply resumed through the partial one equals it exactly
    y, _, norms, _, _ = _inputs(shape, levels, seed=7)
    tp = tiling.plan_tiles(compile_schedule(shape, levels), torch.float32)
    yc = torch.from_numpy(y.reshape((1,) + tp.canon_shape))
    aggs, vfin = lowering.codegen_reduce(yc, tp, norms[:-1])
    u = 0.5 * vfin
    w = lowering._shrink(norms[-2], aggs[-1], u[:, None], vfin[:, None])
    full = lowering.codegen_apply(yc, aggs, vfin, u, tp, norms[:-1])
    resumed = lowering.codegen_partial_apply(yc, aggs, w, tp, norms[:-1])
    assert torch.equal(full, resumed)


def test_raw_reduce_is_the_unfinalized_accumulator():
    shape, levels = (16, 8, 256), (("2", 1), ("2", 1), ("1", 1))
    tp = tiling.plan_tiles(compile_schedule(shape, levels), torch.float32)
    yc = torch.randn((2,) + tp.canon_shape, generator=torch.Generator().manual_seed(0))
    aggs, vfin = lowering.codegen_reduce(yc, tp, ["2", "2"])
    aggs_r, acc = lowering.codegen_reduce(yc, tp, ["2", "2"], raw=True)
    assert all(torch.equal(a, b) for a, b in zip(aggs, aggs_r))
    torch.testing.assert_close(lowering.finalize("2", acc), vfin, rtol=1e-6, atol=0)
    torch.testing.assert_close(acc, (aggs[0] ** 2).sum(1), rtol=1e-6, atol=0)


def test_partial_apply_rejects_mismatched_radii():
    shape, levels = CASES[0][1], CASES[0][2]
    tp = tiling.plan_tiles(compile_schedule(shape, levels), torch.float32)
    yc = torch.zeros((1,) + tp.canon_shape)
    aggs, _ = lowering.codegen_reduce(yc, tp, ["inf", "1"])
    with pytest.raises(ValueError, match="w must be"):
        lowering.codegen_partial_apply(yc, aggs, torch.zeros(1, 3, 3), tp,
                                       ["inf", "1"])
