"""Parity of the port's ``core/ball.py`` with the JAX package's.

The same float32 inputs, made with a seeded numpy generator, go through
``repro.core.ball`` and ``repro_torch.core.ball`` on the CPU. Tolerance:
atol = 1e-5 * max|y|, rtol = 1e-5 — 64-step float32 bisection and a
different summation order move θ by a few ulps.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ball as jball
from repro_torch.core import ball as tball

METHODS = ["sort", "bisect", "filter", "michelot", "condat"]
RADII = [0.0, 0.5, 3.0, 1e6]


def _rand(shape, seed):
    return (np.random.default_rng(seed).normal(size=shape) * 2.0).astype(np.float32)


def _close(got, want, y):
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), rtol=1e-5,
        atol=1e-5 * max(float(np.abs(y).max()), 1e-30))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("radius", RADII)
def test_project_l1_matches_jax(method, radius):
    y = _rand((5, 37), seed=1)
    got = tball.project_l1(torch.from_numpy(y), radius, method=method)
    want = jball.project_l1(jnp.asarray(y), radius, method=method)
    _close(got, want, y)
    # feasibility of every row
    assert (got.abs().sum(-1) <= radius * (1 + 1e-5) + 1e-5).all()


@pytest.mark.parametrize("method", ["sort", "bisect", "filter"])
def test_project_l1_per_row_radii(method):
    y = _rand((4, 50), seed=2)
    radii = np.array([0.1, 1.0, 10.0, 1e4], np.float32)
    got = tball.project_l1(torch.from_numpy(y), torch.from_numpy(radii),
                           method=method)
    want = jball.project_l1(jnp.asarray(y), jnp.asarray(radii), method=method)
    _close(got, want, y)


@pytest.mark.parametrize("method", ["sort", "bisect", "filter"])
def test_ball_contract(method):
    """θ <= 0 inside the ball (identity); outside θ > 0 and the soft
    threshold lands on the sphere."""
    a = np.abs(_rand((3, 40), seed=3))
    solver = tball.method_info(method).ball_theta
    inside = solver(torch.from_numpy(a), float(a.sum(-1).max()) + 1.0)
    assert (inside <= 0).all()
    r = 0.25 * float(a.sum(-1).min())
    theta = solver(torch.from_numpy(a), r)
    assert (theta > 0).all()
    mass = torch.clamp(torch.from_numpy(a) - theta[:, None], min=0).sum(-1)
    np.testing.assert_allclose(mass.numpy(), r, rtol=1e-5)
    want = jball.method_info(method).ball_theta(jnp.asarray(a), r)
    _close(theta, want, a)


@pytest.mark.parametrize("method", ["sort", "bisect", "filter"])
def test_project_simplex_matches_jax(method):
    y = _rand((3, 30), seed=4)
    got = tball.project_simplex(torch.from_numpy(y), 2.0, method=method)
    want = jball.project_simplex(jnp.asarray(y), 2.0, method=method)
    _close(got, want, y)


@pytest.mark.parametrize("radius", [0.0, 1.0, 1e6])
def test_project_l2_and_linf_match_jax(radius):
    y = _rand((6, 20), seed=5)
    _close(tball.project_l2(torch.from_numpy(y), radius),
           jball.project_l2(jnp.asarray(y), radius), y)
    _close(tball.project_linf(torch.from_numpy(y), radius),
           jball.project_linf(jnp.asarray(y), radius), y)
    radii = np.linspace(0.1, 3.0, 6).astype(np.float32)
    _close(tball.project_linf(torch.from_numpy(y), torch.from_numpy(radii)),
           jball.project_linf(jnp.asarray(y), jnp.asarray(radii)), y)


@pytest.mark.parametrize("norm", [1, 2, math.inf, "inf", "1", "2"])
def test_project_ball_and_norm_reduce_match_jax(norm):
    y = _rand((4, 6, 9), seed=6)
    _close(tball.project_ball(torch.from_numpy(y), norm, 1.5),
           jball.project_ball(jnp.asarray(y), norm, 1.5), y)
    for axes in (0, (0, 1), (1, 2)):
        _close(tball.norm_reduce(torch.from_numpy(y), norm, axes),
               jball.norm_reduce(jnp.asarray(y), norm, axes), y)


@pytest.mark.parametrize("norm", ["1", "2", "inf"])
@pytest.mark.parametrize("inner_axes", [(0,), (1,), (0, 2)])
def test_project_grouped_matches_jax(norm, inner_axes):
    y = _rand((5, 4, 7), seed=7)
    outer = [d for a, d in enumerate(y.shape) if a not in inner_axes]
    radii = np.random.default_rng(8).uniform(0.1, 3.0, outer).astype(np.float32)
    got = tball.project_grouped(torch.from_numpy(y), norm,
                                torch.from_numpy(radii), inner_axes,
                                method="bisect")
    want = jball.project_grouped(jnp.asarray(y), norm, jnp.asarray(radii),
                                 inner_axes, method="bisect")
    _close(got, want, y)


def test_registry_and_norm_names_match_jax():
    assert tball.available_methods() == jball.available_methods()
    for alias in ["sort", "bisect", "filter", "michelot", "condat", None]:
        assert tball.resolve_method(alias) == jball.resolve_method(alias)
    with pytest.raises(ValueError):
        tball.resolve_method("nope")
    for norm in [1, 2, "1", "2", "inf", math.inf]:
        assert tball.canonical_norm(norm) == jball.canonical_norm(norm)
    with pytest.raises(ValueError):
        tball.canonical_norm(3)
