"""Parity of the port's exact ℓ1,∞ projection (``repro_torch.core.exact_l1inf``,
the paper's baseline of Chu et al.) with the JAX package's, and its planner
backend.

Inputs are float32 from a seeded numpy generator, normal and uniform(0, 1)
as in ``tests/test_core_projections.py``. Tolerance: 1e-5 · max|Y| + 1e-5 |b|
(float32 sorts and prefix sums in another order move λ and the caps by a
few ulps).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import exact_l1inf as jexact
from repro.core import plan as jplan
from repro_torch import core as tcore
from repro_torch.core import bilevel as tbilevel
from repro_torch.core import plan as tplan

BILEVEL = [("inf", 1), ("1", 1)]


def _rand(shape, seed=0, scale=1.0, dist="normal"):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=shape) * scale if dist == "normal" \
        else rng.uniform(0.0, scale, size=shape)
    return a.astype(np.float32)


def _close(got, want, y):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * float(np.abs(y).max()))


CASES = [((40, 60), 3.0, "uniform"), ((25, 30), 1.5, "normal"),
         ((7, 200), 0.5, "normal"), ((1, 50), 2.0, "normal")]


@pytest.mark.parametrize("method", ["newton", "bisect"])
@pytest.mark.parametrize("shape,radius,dist", CASES)
def test_exact_matches_jax(shape, radius, dist, method):
    y = _rand(shape, seed=sum(shape), scale=2.0, dist=dist)
    got = tcore.project_l1inf_exact(torch.from_numpy(y), radius, method=method)
    want = jexact.project_l1inf_exact(jnp.asarray(y), radius, method=method)
    assert got.dtype == torch.float32 and got.shape == shape
    _close(got.numpy(), want, y)
    assert float(tcore.l1inf_norm(got)) <= radius * (1 + 1e-5)


def test_bisect_brackets_the_root_of_long_few_columns():
    """At (300, 17) the dual root λ* exceeds Σ_j max_i |Y_ij|, the JAX
    bisection's upper end; the port brackets with the largest column mass,
    so both its solvers land on JAX's Newton solution."""
    y = _rand((300, 17), seed=317, scale=2.0, dist="uniform")
    want = jexact.project_l1inf_exact(jnp.asarray(y), 10.0, method="newton")
    assert float(np.abs(y).sum(0).max()) > 10.0
    for method in ("newton", "bisect"):
        got = tcore.project_l1inf_exact(torch.from_numpy(y), 10.0,
                                        method=method)
        _close(got.numpy(), want, y)
        assert float(tcore.l1inf_norm(got)) <= 10.0 * (1 + 1e-5)


def test_bisect_variant_and_iters_match_jax():
    y = _rand((30, 40), seed=2, scale=2.0)
    got = tcore.project_l1inf_exact_bisect(torch.from_numpy(y), 2.0, iters=30)
    want = jexact.project_l1inf_exact_bisect(jnp.asarray(y), 2.0, iters=30)
    _close(got.numpy(), want, y)
    got = tcore.project_l1inf_exact(torch.from_numpy(y), 2.0, iters=3)
    want = jexact.project_l1inf_exact(jnp.asarray(y), 2.0, iters=3)
    _close(got.numpy(), want, y)


@pytest.mark.parametrize("shape", [(5, 8), (64, 33), (300, 700)])
def test_l1inf_norm_matches_jax(shape):
    y = _rand(shape, seed=7, scale=3.0)
    np.testing.assert_allclose(float(tcore.l1inf_norm(torch.from_numpy(y))),
                               float(jexact.l1inf_norm(jnp.asarray(y))),
                               rtol=1e-6)


def test_feasible_input_is_returned_unchanged():
    y = _rand((20, 20), seed=9) * 1e-4
    for method in ("newton", "bisect"):
        x = tcore.project_l1inf_exact(torch.from_numpy(y), 5.0, method=method)
        np.testing.assert_array_equal(x.numpy(), y)


def test_returns_the_input_type_and_works_in_float32():
    y = torch.from_numpy(_rand((16, 24), seed=4, scale=2.0)).to(torch.bfloat16)
    x = tcore.project_l1inf_exact(y, 1.0)
    assert x.dtype == torch.bfloat16
    want = tcore.project_l1inf_exact(y.float(), 1.0).to(torch.bfloat16)
    torch.testing.assert_close(x, want, rtol=0, atol=0)


def test_exact_is_closer_than_bilevel():
    # the exact projection is the Euclidean-optimal point of the ball;
    # bi-level is feasible but generally farther (the paper's trade-off)
    for seed in range(4):
        y = torch.from_numpy(_rand((40, 60), seed=seed, dist="uniform"))
        xe = tcore.project_l1inf_exact(y, 3.0)
        xb = tbilevel.bilevel_l1inf(y, 3.0)
        assert float((xe - y).norm()) <= float((xb - y).norm()) + 1e-5


def test_kkt_structure():
    # every column of the solution is a clip of the input at a cap t_j >= 0
    y = torch.from_numpy(_rand((30, 15), seed=11, scale=2.0))
    x = tcore.project_l1inf_exact(y, 2.0)
    caps = x.abs().amax(dim=0)
    torch.testing.assert_close(x, torch.sign(y) * torch.minimum(y.abs(), caps),
                               rtol=0, atol=1e-6)


def test_unknown_dual_solver_raises():
    from repro_torch.core import exact_l1inf

    y = torch.ones(4, 5)
    with pytest.raises(ValueError, match="unknown l1inf dual solver"):
        tcore.project_l1inf_exact(y, 1.0, method="secant")
    assert exact_l1inf.resolve_dual_solver("bisect") == "bisect"
    assert sorted(exact_l1inf._DUAL_SOLVERS) == sorted(jexact._DUAL_SOLVERS)
    assert {k: v[1] for k, v in exact_l1inf._DUAL_SOLVERS.items()} == \
        {k: v[1] for k, v in jexact._DUAL_SOLVERS.items()}


KEYS = [
    ((6, 10), BILEVEL, "scalar", "float32"),
    ((6, 10), BILEVEL, "scalar", "bfloat16"),
    ((6, 10), BILEVEL, "batch", "float32"),
    ((2, 6, 10), [("inf", 1), ("inf", 1), ("1", 1)], "scalar", "float32"),
    ((3, 6, 10), [("inf", 2), ("1", 1)], "scalar", "float32"),
    ((6, 10), [("2", 1), ("1", 1)], "scalar", "float32"),
    ((6, 10), [("1", 1), ("inf", 1)], "scalar", "float32"),
    ((6, 10), [("1", 2)], "scalar", "float32"),
]


@pytest.mark.parametrize("shape,levels,radius_kind,dtype", KEYS)
def test_planner_offers_exact_on_the_keys_jax_does(shape, levels, radius_kind,
                                                   dtype):
    tplan._maybe_register_kernel_backends()
    lv = tplan.canonical_levels(levels)
    tkey = tplan.PlanKey(shape, dtype, lv, radius_kind, "cpu")
    jkey = jplan.PlanKey(shape=shape, dtype=dtype,
                         levels=jplan.canonical_levels(levels),
                         radius_kind=radius_kind, device="cpu")
    assert ("exact_l1inf" in tplan._candidates(tkey)) == \
        ("exact_l1inf" in jplan._candidates(jkey))
    # the card's keys see the same rule
    ckey = tkey._replace(device="cuda")
    assert ("exact_l1inf" in tplan._candidates(ckey)) == \
        ("exact_l1inf" in tplan._candidates(tkey))


def test_explicit_exact_plan_matches_jax():
    y = _rand((6, 10), seed=31)
    p = tplan.make_plan((6, 10), torch.float32, BILEVEL, method="exact_l1inf",
                        device="cpu")
    assert p.method == "exact_l1inf"
    out = torch.empty(6, 10)
    got = p(torch.from_numpy(y), 2.0, out=out)
    assert got is out
    _close(got.numpy(), jexact.project_l1inf_exact(jnp.asarray(y), 2.0), y)
    with pytest.raises(ValueError, match="not available"):
        tplan.make_plan((2, 6, 10), torch.float32,
                        [("inf", 1), ("inf", 1), ("1", 1)],
                        method="exact_l1inf", device="cpu")
