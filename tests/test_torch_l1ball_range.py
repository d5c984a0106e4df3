"""The ℓ1-ball θ-solve over the whole length range of JAX's kernel and in
bf16 (``repro_torch.kernels.l1ball``), and the golden pipelines in bf16, on
the CPU, against the JAX package's Pallas kernels in interpret mode.

On the CPU the wrappers run the plain version, ``project_l1_plain``; the
CUDA kernels (``l1ball`` up to ``L1_ONE_CTA_MAX`` values, ``l1ball_cluster``
up to ``L1_KERNEL_MAX``) are held to it on the card by ``chip_smoke.py``
(phase 15). A bf16 vector is solved as the kernels solve it: |v| in
float32, the radius rounded to bf16 first (JAX's ``jnp.asarray(radius,
v.dtype)``), the bisection or the filter in float32 and the output rounded
to bf16 once. JAX's kernel runs the solve in bf16 itself. Inputs come from a
seeded numpy generator, cast to the type in JAX and handed to the port as
the same values.

Tolerances: float32 within JAX's own 1e-5 (another summation order moves θ
by a few ulps). bf16 within one bf16 ulp of max|v| (or of max|Y| for the
pipelines: their X is Y clipped to the solve's output), 2^(⌊log2 max⌋ - 7):
the two solves differ by the precision of their sums, and measured over
three seeds and three radii at n = 300, 2048 and 100,352 the outputs lie at
most one such ulp apart (half an ulp or less in most cases).
"""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import l1ball as jl1ball
from repro.kernels.bilevel_l1inf import bilevel_l1inf_pallas
from repro.kernels.trilevel_l1infinf import trilevel_l1infinf_pallas
from repro_torch.kernels import bilevel_l1inf as tbi
from repro_torch.kernels import l1ball as tl1ball
from repro_torch.kernels import ref as tref
from repro_torch.kernels import trilevel_l1infinf as ttri
from repro_torch.kernels.codegen import tiling

SOURCE = Path(tl1ball.__file__).resolve().parent.parent / "csrc" / "l1ball.cu"
METHODS = ["bisect", "filter"]


def _rand(shape, seed, dtype=jnp.float32, scale=2.0, uniform=False):
    """(the JAX array, the same values as a torch tensor of the type)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, shape) if uniform else rng.normal(size=shape) * scale
    y = jnp.asarray(x, dtype)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    return y, torch.from_numpy(np.array(y, np.float32)).to(tdt)


def _bf16_ulp(x):
    """The spacing of bf16 numbers at max|x|: 8 significant bits."""
    return 2.0 ** (math.floor(math.log2(float(np.abs(x).max()))) - 7)


# ------------------------------------------------ the plain version vs JAX


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("n", [300, 51201, 100352])
def test_plain_float32_matches_pallas_over_the_range(n, method):
    """Past one CTA's shared memory (51,201 values) up to a vocabulary's
    length (stablelm-1.6b's 100,352), float32."""
    v, tv = _rand((n,), seed=n)
    r = 0.25 * float(np.abs(np.asarray(v)).sum())
    got = tl1ball.project_l1(tv, r, method=method)
    want = jl1ball.project_l1_pallas(v, r, method=method, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("frac", [0.05, 0.5, 0.999])
@pytest.mark.parametrize("n", [300, 2048, 100352])
def test_plain_bf16_within_one_ulp_of_pallas(n, frac, method):
    v, tv = _rand((n,), seed=n + 1, dtype=jnp.bfloat16)
    r = frac * float(np.abs(np.asarray(v, np.float32)).sum())
    got = tl1ball.project_l1(tv, r, method=method)
    assert got.dtype == torch.bfloat16
    want = np.asarray(jl1ball.project_l1_pallas(v, r, method=method,
                                                interpret=True), np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=_bf16_ulp(want))


def test_plain_bf16_rounds_the_radius_and_the_output_once():
    """The bf16 solve is the float32 solve of the same values with the
    radius rounded to bf16, its output rounded to bf16 once; a float32
    radius and its bf16 rounding give the same result."""
    _, tv = _rand((3, 500), seed=7, dtype=jnp.bfloat16)
    radii = torch.tensor([1.3, 40.7, 1e4])
    rb = radii.to(torch.bfloat16)
    for method in METHODS:
        got = tl1ball.project_l1_batched(tv, radii, method=method)
        f32 = tl1ball.project_l1_plain(tv.float(), rb.float(), method)
        torch.testing.assert_close(got, f32.to(torch.bfloat16), rtol=0, atol=0)
        torch.testing.assert_close(
            tl1ball.project_l1_batched(tv, rb, method=method), got, rtol=0, atol=0)
    assert torch.equal(got[2], tv[2])  # inside its ball: unchanged


def test_plain_bf16_keeps_nan_and_inf_as_float32_does():
    _, tv = _rand((4, 64), seed=8, dtype=jnp.bfloat16)
    tv[0, 3], tv[1, 5], tv[2, 9] = float("nan"), float("inf"), -float("inf")
    radii = torch.full((4,), 3.0)
    for method in METHODS:
        got = tl1ball.project_l1_plain(tv, radii, method)
        want = tl1ball.project_l1_plain(tv.float(), radii, method)
        assert torch.equal(got.isnan(), want.isnan())
        fin = want.isfinite()
        torch.testing.assert_close(got.float()[fin], want[fin].to(
            torch.bfloat16).float(), rtol=0, atol=0)


# ------------------------------------------------- the golden pipelines, bf16


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("shape,radius", [((300, 700), 2.0), ((64, 2048), 30.0)])
def test_bilevel_fused_bf16_within_one_ulp_of_pallas(shape, radius, method):
    y, ty = _rand(shape, seed=sum(shape), dtype=jnp.bfloat16)
    got = tbi.bilevel_l1inf_fused(ty, radius, method=method)
    assert got.dtype == torch.bfloat16 and got.shape == shape
    want = np.asarray(bilevel_l1inf_pallas(y, radius, method=method,
                                           interpret=True), np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=_bf16_ulp(np.asarray(y, np.float32)))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("shape,radius", [((3, 64, 200), 1.5), ((8, 32, 512), 40.0)])
def test_trilevel_fused_bf16_within_one_ulp_of_pallas(shape, radius, method):
    y, ty = _rand(shape, seed=sum(shape), dtype=jnp.bfloat16)
    got = ttri.trilevel_l1infinf_fused(ty, radius, method=method)
    assert got.dtype == torch.bfloat16 and got.shape == shape
    want = np.asarray(trilevel_l1infinf_pallas(y, radius, method=method,
                                               interpret=True), np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=_bf16_ulp(np.asarray(y, np.float32)))


def test_bilevel_fused_bf16_over_a_vocabulary():
    """The ℓ1 over 100,352 columns (stablelm-1.6b's vocabulary, W5's
    aggregate on the card), uniform Y as W5's, bf16."""
    y, ty = _rand((4, 100352), seed=5, dtype=jnp.bfloat16, uniform=True)
    radius = 0.25 * float(np.abs(np.asarray(y, np.float32)).max(0).sum())
    got = tbi.bilevel_l1inf_fused(ty, radius)
    want = np.asarray(bilevel_l1inf_pallas(y, radius, interpret=True), np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=_bf16_ulp(np.asarray(y, np.float32)))


# ------------------------------------------------------------ the contract


def test_outer_l1_solve_sends_every_kernel_length_to_a_kernel(monkeypatch):
    """A kernel method on a device vector goes to a kernel for every length
    JAX's kernel takes (``l1ball`` up to 51,200 values, ``l1ball_cluster``
    beyond, both types), and one value past JAX's limit to the PyTorch-ops
    solver, as in JAX; the launches are recorded in place of the kernels'
    (the launch gate lifted, ``meta`` tensors)."""
    monkeypatch.setattr(tl1ball._device, "require_cuda", lambda t, what: None)
    calls = []
    for kern in (tl1ball.KERNEL, tl1ball.CLUSTER_KERNEL):
        monkeypatch.setattr(kern, "launch", lambda fn, *a, k=kern:
                            calls.append((k.name, fn, a[5], a[8])))
    monkeypatch.setattr(tref, "project_l1_ref",
                        lambda v, r, method: calls.append(("ref", method, v.shape[0])))
    assert tl1ball.L1_KERNEL_MAX == tl1ball.REF_ROUTE_ABOVE == 524288
    want = []
    for n in (2048, 51200, 51201, 100352, 524288, 524289):
        for dtype in (torch.float32, torch.bfloat16):
            for method in METHODS:
                tl1ball.outer_l1_solve(torch.empty(n, device="meta", dtype=dtype),
                                       1.0, method=method)
                if n > tl1ball.L1_KERNEL_MAX:
                    want.append(("ref", method, n))
                    continue
                code = int(dtype == torch.bfloat16)
                want.append(("l1ball", "l1ball_project", n, code)
                            if n <= tl1ball.L1_ONE_CTA_MAX else
                            ("l1ball_cluster", "l1ball_cluster_project", n, code))
    assert calls == want


def test_the_tiler_and_the_mesh_take_every_kernel_length():
    """``plan_tiles`` and ``distributed.shardable`` take an ℓ1 outer solve
    up to 524,288 values and refuse one past it."""
    from repro_torch.core import schedule
    from repro_torch.kernels.codegen import distributed

    class Mesh:
        shape = {"data": 1, "model": 1}

    levels = [("inf", 1), ("1", 1)]
    for m, ok in ((51201, True), (524288, True), (524289, False)):
        tp = tiling.plan_tiles(schedule.compile_schedule((2, m), levels),
                               torch.float32)
        assert (tp is not None) == ok
        assert distributed.shardable((2, m), levels, (None, None), Mesh,
                                     torch.float32) == ok


def test_the_cluster_holds_every_length_in_shared_memory():
    """The cluster path's geometry (``cluster_ctas`` in ``csrc/l1ball.cu``):
    CTAs a power of two from 2 to CLUSTER_MAX, the smallest whose chunks
    hold CHUNK_TARGET values, and every chunk of every length up to
    L1_MAX within one CTA's shared memory."""
    text = SOURCE.read_text()

    def const(name):
        m = re.search(rf"constexpr int {name} = ([\d\s*]+);", text)
        return eval(m.group(1))  # a product of integer literals

    cmax, target, smem = const("CLUSTER_MAX"), const("CHUNK_TARGET"), const("SMEM_MAX")
    assert const("L1_MAX") == tl1ball.L1_KERNEL_MAX
    assert smem == tiling.SMEM_BUDGET_BYTES

    def ctas(n):
        c = 2
        while c < cmax and -(-n // c) > target:
            c *= 2
        return c

    for n in (1, 51201, 100352, 262144, 524288):
        c = ctas(n)
        assert c & (c - 1) == 0 and 2 <= c <= cmax
        assert -(-n // c) * 4 <= smem
    assert [ctas(n) for n in (51201, 100352, 262144, 524288)] == [4, 8, 16, 16]
