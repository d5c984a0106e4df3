"""Parity of the port's golden kernels (``repro_torch.kernels.bilevel_l1inf``
and ``trilevel_l1infinf``: paper Algorithms 2 and 5) with the JAX package's
Pallas kernels run in interpret mode, the golden pin of the generated
pipeline, and the outer θ-solve's routing.

On the CPU the wrappers run each kernel's plain PyTorch version; the CUDA
kernels are held against those versions on the card by ``chip_smoke.py``.
Inputs are made as ``tests/test_kernels.py`` makes them (seeded numpy
normals, cast to the type in JAX) and handed to the port as the same values.
Tolerances: the column max, clip, reduce and apply do not round, so their
plain versions equal JAX's kernels exactly in float32 and bf16; the fused
pipelines agree within JAX's own 1e-5 (a 64-step float32 bisection or
another solver order moves θ by a few ulps); the golden pin within JAX's
1e-6 (expected 0: the same solve of the same exact maxima).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import l1ball as jl1ball
from repro.kernels.bilevel_l1inf import (bilevel_l1inf_pallas, clip_pallas,
                                         colmax_pallas)
from repro.kernels.trilevel_l1infinf import (trilevel_apply_pallas,
                                             trilevel_l1infinf_pallas,
                                             trilevel_reduce_pallas)
from repro_torch import kernels as tkernels
from repro_torch.kernels import bilevel_l1inf as tbi
from repro_torch.kernels import codegen as tcodegen
from repro_torch.kernels import l1ball as tl1ball
from repro_torch.kernels import trilevel_l1infinf as ttri

BILEVEL = [("inf", 1), ("1", 1)]
TRILEVEL = [("inf", 1), ("inf", 1), ("1", 1)]
DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


def _rand(shape, seed=0, dtype=jnp.float32, scale=1.0):
    """tests/test_kernels.py's inputs: (the JAX array, the same values as a
    torch tensor of the matching type)."""
    rng = np.random.default_rng(seed)
    y = jnp.asarray(rng.normal(size=shape) * scale, dtype)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    return y, torch.from_numpy(np.array(y, np.float32)).to(tdt)


def _equal(got, want):
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


# ------------------------------------------------------ plain kernels, exact


@pytest.mark.parametrize("jdt,tdt", DTYPES)
@pytest.mark.parametrize(
    "shape", [(8, 128), (256, 512), (300, 700), (1024, 257), (7, 1000), (1, 128)])
def test_colmax_matches_pallas_exactly(shape, jdt, tdt):
    y, ty = _rand(shape, seed=sum(shape), dtype=jdt, scale=3.0)
    got = tbi.colmax(ty)
    assert got.dtype == tdt and got.shape == (shape[1],)
    _equal(got, colmax_pallas(y, interpret=True))


@pytest.mark.parametrize("jdt,tdt", DTYPES)
@pytest.mark.parametrize("shape", [(8, 128), (250, 333), (1024, 512)])
def test_clip_matches_pallas_exactly(shape, jdt, tdt):
    y, ty = _rand(shape, seed=11, dtype=jdt, scale=3.0)
    u, tu = _rand((shape[1],), seed=12, dtype=jdt)
    u, tu = jnp.abs(u), tu.abs()
    got = tbi.clip(ty, tu)
    assert got.dtype == tdt
    _equal(got, clip_pallas(y, u, interpret=True))


def test_clip_rounds_a_float32_radius_to_the_input_type():
    y, ty = _rand((16, 130), seed=13, dtype=jnp.bfloat16, scale=3.0)
    u = np.abs(np.random.default_rng(14).normal(size=130)).astype(np.float32)
    got = tbi.clip(ty, torch.from_numpy(u))
    assert got.dtype == torch.bfloat16
    _equal(got, clip_pallas(y, jnp.asarray(u), interpret=True))


TRI_SHAPES = [(2, 8, 128), (3, 17, 130), (8, 250, 64), (1, 64, 257),
              (4, 300, 700)]


@pytest.mark.parametrize("jdt,tdt", DTYPES)
@pytest.mark.parametrize("shape", TRI_SHAPES)
def test_trilevel_reduce_matches_pallas_exactly(shape, jdt, tdt):
    y, ty = _rand(shape, seed=sum(shape), dtype=jdt, scale=2.0)
    v2, v1 = ttri.trilevel_reduce(ty)
    jv2, jv1 = trilevel_reduce_pallas(y, interpret=True)
    assert v2.dtype == v1.dtype == tdt
    _equal(v2, jv2)
    _equal(v1, jv1)


@pytest.mark.parametrize("jdt,tdt", DTYPES)
@pytest.mark.parametrize("shape", TRI_SHAPES)
def test_trilevel_apply_matches_pallas_exactly(shape, jdt, tdt):
    y, ty = _rand(shape, seed=sum(shape), dtype=jdt, scale=2.0)
    jv2, _ = trilevel_reduce_pallas(y, interpret=True)
    u1 = np.abs(np.random.default_rng(5).normal(size=shape[2])).astype(np.float32)
    got = ttri.trilevel_apply(ty, torch.from_numpy(np.asarray(jv2, np.float32)
                                                   ).to(tdt),
                              torch.from_numpy(u1))
    assert got.dtype == tdt
    _equal(got, trilevel_apply_pallas(y, jv2, jnp.asarray(u1), interpret=True))


def test_nan_and_inf_propagate_as_in_jax():
    y = np.random.default_rng(3).normal(size=(3, 9, 130)).astype(np.float32)
    y[1, 4, 7] = np.nan
    y[0, 2, 9] = np.inf
    y[2, 5, 11] = -np.inf
    v2, v1 = ttri.trilevel_reduce(torch.from_numpy(y))
    jv2, jv1 = trilevel_reduce_pallas(jnp.asarray(y), interpret=True)
    _equal(v2, jv2)
    _equal(v1, jv1)
    y2 = y[0]
    _equal(tbi.colmax(torch.from_numpy(y2)),
           colmax_pallas(jnp.asarray(y2), interpret=True))
    u = np.abs(y2[0])
    _equal(tbi.clip(torch.from_numpy(y2), torch.from_numpy(u)),
           clip_pallas(jnp.asarray(y2), jnp.asarray(u), interpret=True))


# -------------------------------------------------------- fused pipelines


@pytest.mark.parametrize("method", ["sort", "bisect", "filter"])
def test_bilevel_fused_matches_pallas(method):
    y, ty = _rand((300, 700), seed=9, scale=2.0)
    got = tkernels.bilevel_l1inf_fused(ty, 2.0, method=method)
    want = bilevel_l1inf_pallas(y, 2.0, method=method, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("method", ["sort", "bisect", "filter"])
def test_trilevel_fused_matches_pallas(method):
    y, ty = _rand((3, 64, 200), seed=18, scale=2.0)
    got = tkernels.trilevel_l1infinf_fused(ty, 1.5, method=method)
    want = trilevel_l1infinf_pallas(y, 1.5, method=method, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_fused_pipelines_take_float32_only():
    """Named for the float32-only pipelines they were: the fused pipelines
    take bf16 as well now, as JAX's do (bf16 in, bf16 out, equal to the
    plain bf16 chain colmax → l1ball → clip); another type and a Y of the
    wrong order still raise."""
    _, ty = _rand((8, 128), dtype=jnp.bfloat16)
    x = tbi.bilevel_l1inf_fused(ty, 1.0)
    u = tl1ball.project_l1_plain(tbi.colmax_plain(ty)[None], torch.tensor([1.0]))
    assert x.dtype == torch.bfloat16
    torch.testing.assert_close(x, tbi.clip_plain(ty, u[0]), rtol=0, atol=0)
    assert ttri.trilevel_l1infinf_fused(ty[None], 1.0).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tbi.bilevel_l1inf_fused(ty.half(), 1.0)
    with pytest.raises(ValueError, match="order-3"):
        ttri.trilevel_l1infinf_fused(torch.ones(8, 128), 1.0)


# ------------------------------------------------------------ the golden pin


@pytest.mark.parametrize("shape", [(64, 128), (300, 700), (16, 130)])
def test_bilevel_pins_the_generated_pipeline(shape):
    _, ty = _rand(shape, seed=sum(shape))
    got = tcodegen.codegen_project(ty, BILEVEL, 2.0)
    want = tbi.bilevel_l1inf_fused(ty, 2.0, method="bisect")
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("shape", [(2, 8, 128), (3, 17, 130), (8, 250, 64)])
def test_trilevel_pins_the_generated_pipeline(shape):
    _, ty = _rand(shape, seed=sum(shape))
    got = tcodegen.codegen_project(ty, TRILEVEL, 2.0)
    want = ttri.trilevel_l1infinf_fused(ty, 2.0, method="bisect")
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)


# -------------------------------------------------- the outer θ-solve route


@pytest.mark.parametrize("method", ["sort", "bisect", "filter"])
@pytest.mark.parametrize("n", [16, 129, 1000])
def test_outer_l1_solve_matches_jax(n, method):
    v, tv = _rand((n,), seed=n, scale=2.0)
    got = tl1ball.outer_l1_solve(tv.abs(), 1.0, method=method)
    want = jl1ball.outer_l1_solve(jnp.abs(v), 1.0, method=method,
                                  interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_outer_l1_solve_routes_by_method_and_length(monkeypatch):
    from repro_torch.kernels import ref

    calls = []
    monkeypatch.setattr(tl1ball, "project_l1",
                        lambda v, r, method: calls.append(("kernel", method)))
    monkeypatch.setattr(ref, "project_l1_ref",
                        lambda v, r, method: calls.append(("ref", method)))
    short = torch.ones(tl1ball.REF_ROUTE_ABOVE)
    long = torch.ones(tl1ball.REF_ROUTE_ABOVE + 1)
    for v, method in [(short, "bisect"), (short, "filter"), (short, "sort"),
                      (long, "bisect"), (long, "filter")]:
        tl1ball.outer_l1_solve(v, 1.0, method=method)
    assert calls == [("kernel", "bisect"), ("kernel", "filter"),
                     ("ref", "sort"), ("ref", "bisect"), ("ref", "filter")]
    assert tl1ball.REF_ROUTE_ABOVE == jl1ball.L1_KERNEL_MAX


def test_kernel_method_past_the_shared_memory_limit_raises(monkeypatch):
    """Past one CTA's shared memory (51,201 … 524,288 values, JAX's limit)
    a kernel method on a device vector reaches the cluster kernel's launch
    (recorded here in its place), and ``project_l1`` past 524,288 raises
    (no quiet plain run); the launch gate is lifted so the length checks
    are what a CUDA tensor would reach."""
    monkeypatch.setattr(tl1ball._device, "require_cuda", lambda t, what: None)
    calls = []
    monkeypatch.setattr(tl1ball.CLUSTER_KERNEL, "launch",
                        lambda fn, *args: calls.append((fn, *args)))
    for n in (tl1ball.L1_ONE_CTA_MAX + 1, tl1ball.L1_KERNEL_MAX):
        tl1ball.outer_l1_solve(torch.empty(n, device="meta"), 1.0)
        assert calls[-1][0] == "l1ball_cluster_project" and calls[-1][6] == n
    n = tl1ball.L1_KERNEL_MAX + 1
    with pytest.raises(ValueError, match=f"n <= {tl1ball.L1_KERNEL_MAX}"):
        tl1ball.project_l1(torch.empty(n, device="meta"), 1.0)
    assert len(calls) == 2 and tl1ball.KERNEL.launches == 0


def test_project_l1_is_the_batched_kernel_at_one_item():
    _, tv = _rand((300,), seed=4, scale=2.0)
    got = tl1ball.project_l1(tv, 1.5, method="filter")
    want = tl1ball.project_l1_plain(tv[None], torch.tensor([1.5]), "filter")[0]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="vector"):
        tl1ball.project_l1(tv[None], 1.5)
