"""Parity of the port's schedule IR and multi-level projections
(``repro_torch.core.schedule``/``multilevel``/``bilevel``) with the JAX
package's, over the codegen design matrix.

Inputs are float32 from a seeded numpy generator, fed to both packages on
the CPU. Tolerance: atol = 1e-5 * max|y|, rtol = 1e-5 (64-step float32
bisection and a different summation order move θ by a few ulps).
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bilevel as jbilevel
from repro.core import multilevel as jmultilevel
from repro.core import schedule as jschedule
from repro_torch.core import bilevel as tbilevel
from repro_torch.core import multilevel as tmultilevel
from repro_torch.core import schedule as tschedule
from test_codegen import DESIGNS, EXTRA_DESIGNS

ALL = DESIGNS + EXTRA_DESIGNS


def _rand(shape, name):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    return (rng.normal(size=shape) * 2.0).astype(np.float32)


def _close(got, want, y):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * float(np.abs(y).max()))


@pytest.mark.parametrize("name,shape,levels", ALL)
@pytest.mark.parametrize("batch_dims", [0, 1])
def test_compile_schedule_metadata_matches_jax(name, shape, levels, batch_dims):
    shape = ((3,) if batch_dims else ()) + tuple(shape)
    t = tschedule.compile_schedule(shape, levels, batch_dims)
    j = jschedule.compile_schedule(shape, levels, batch_dims)
    assert t.levels == j.levels
    assert t.stage_shapes == j.stage_shapes
    assert [(type(s).__name__,) + tuple(s) for s in t.steps] == \
        [(type(s).__name__,) + tuple(s) for s in j.steps]
    assert t.solve_size == j.solve_size
    assert t.level_group_sizes == j.level_group_sizes
    assert t.canonical_shape == j.canonical_shape
    assert t.canonical_stage_shapes == j.canonical_stage_shapes


def _check_execute(name, shape, levels, radius, method):
    y = _rand(shape, name)
    got = tmultilevel.multilevel_project(torch.from_numpy(y), levels, radius,
                                         method=method)
    want = jmultilevel.multilevel_project(jnp.asarray(y), levels, radius,
                                          method=method)
    _close(got, want, y)
    nrm = float(tmultilevel.multilevel_norm(got, levels))
    assert nrm <= radius * (1 + 1e-5) + 1e-5 * float(np.abs(y).max())


@pytest.mark.parametrize("name,shape,levels", ALL)
@pytest.mark.parametrize("radius", [0.0, 2.5, 1e6])
def test_execute_matches_jax_and_is_feasible(name, shape, levels, radius):
    # bisect: the θ-solver the served plans and the kernels use
    _check_execute(name, shape, levels, radius, "bisect")


@pytest.mark.parametrize("name,shape,levels",
                         [d for d in ALL if d[0] in ("l1inf_cols", "l1infinf_mid",
                                                     "l11_uneven", "rank4_mixed")])
@pytest.mark.parametrize("method", ["sort", "filter"])
def test_execute_other_solvers_match_jax(name, shape, levels, method):
    _check_execute(name, shape, levels, 2.5, method)


def test_execute_batch_dims_per_item_radii():
    """A leading batch axis with one radius per item equals projecting each
    item on its own (the planner's generic batch path)."""
    levels = [("inf", 1), ("1", 1)]
    y = _rand((4, 12, 20), "batch")
    radii = np.array([0.5, 2.0, 8.0, 1e6], np.float32)
    sched = tschedule.compile_schedule(y.shape, levels, batch_dims=1)
    got = tschedule.execute(torch.from_numpy(y), sched,
                            torch.from_numpy(radii), method="bisect")
    for i in range(4):
        want = jmultilevel.multilevel_project(jnp.asarray(y[i]), levels,
                                              float(radii[i]), method="bisect")
        _close(got[i], want, y)


def test_check_levels_errors_match_jax():
    for shape, levels in [((4, 5), [("inf", 1)]), ((4, 5), [("1", 0), ("1", 2)])]:
        with pytest.raises(ValueError):
            tschedule.check_levels(shape, levels)
        with pytest.raises(ValueError):
            jschedule.check_levels(shape, levels)


@pytest.mark.parametrize("fn", ["bilevel_l1inf", "bilevel_l11", "bilevel_l12",
                                "bilevel_l21"])
def test_bilevel_family_matches_jax(fn):
    y = _rand((24, 30), fn)
    got = getattr(tbilevel, fn)(torch.from_numpy(y), 3.0, method="bisect")
    want = getattr(jbilevel, fn)(jnp.asarray(y), 3.0, method="bisect")
    _close(got, want, y)


def test_trilevel_l1infinf_matches_jax():
    y = _rand((3, 10, 16), "tri")
    got = tmultilevel.trilevel_l1infinf(torch.from_numpy(y), 4.0, "filter")
    want = jmultilevel.trilevel_l1infinf(jnp.asarray(y), 4.0, "filter")
    _close(got, want, y)
