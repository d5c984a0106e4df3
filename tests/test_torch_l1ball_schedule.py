"""A CPU model of the ``l1ball`` kernel's θ-solve schedule
(``src/repro_torch/csrc/l1ball.cu``), held against the 64-step bisection
and the filter of the plain version (``kernels/l1ball.project_l1_plain``)
and against the JAX package's Pallas kernel in interpret mode.

The kernel runs on the card only; what it changes in the algorithm is
modelled here with the same float32 arithmetic:

- the bisection stops where mid equals lo or hi (its float fixed point);
- one block reduction evaluates φ at the 2^LEVELS - 1 midpoints of the
  next LEVELS steps, each computed as (lo + hi) / 2 from the bounds the
  steps before it leave, and the walk through them takes the same
  decisions as step by step;
- φ's clamp is ``fmaxf`` (NaN dropped), read only while mid is finite;
- the filter folds the active sum and the active count (as a float) in
  one reduction.

With the same φ the model's θ equals the 64-step θ bit for bit, and its
projection equals the plain version's exactly.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import l1ball as jl1ball
from repro_torch.kernels import l1ball as tl1ball

SOURCE = Path(tl1ball.__file__).resolve().parent.parent / "csrc" / "l1ball.cu"
F32 = np.float32
HALF = F32(0.5)
ITERS = 64


def _constant(name):
    m = re.search(rf"constexpr int {name} = (\d+);", SOURCE.read_text())
    assert m, f"{name} not found in {SOURCE}"
    return int(m.group(1))


LEVELS = _constant("LEVELS")   # the kernel's speculated steps per reduction


def _phi(a, fmax=False):
    """φ(θ) = Σ max(|v| - θ, 0) as the plain version sums it, one fixed
    order for every θ; ``fmax`` drops a NaN of |v| - θ as ``fmaxf`` does."""
    row = a[None]
    zero = torch.zeros((), dtype=a.dtype)

    def phi(theta):
        d = row - torch.tensor([[theta]], dtype=a.dtype)
        d = torch.fmax(d, zero) if fmax else torch.clamp(d, min=0.0)
        return F32(d.sum(dim=1, keepdim=True).item())
    return phi


def bisect_steps(phi, r, hi, iters=ITERS):
    """The plain version's loop: ``iters`` steps, θ = (lo + hi) / 2."""
    lo, hi = F32(0.0), F32(hi)
    for _ in range(iters):
        mid = HALF * (lo + hi)
        if phi(mid) > r:
            lo = mid
        else:
            hi = mid
    return HALF * (lo + hi)


def bisect_schedule(phi, r, hi, levels=LEVELS, iters=ITERS):
    """The kernel's loop: ``(θ, steps, reductions)``. Each reduction
    evaluates φ at the heap of midpoints of the next ``levels`` steps; the
    walk stops at the float fixed point or after ``iters`` steps."""
    lo, hi = F32(0.0), F32(hi)
    points = (1 << levels) - 1
    it = reductions = 0
    stop = False
    while not stop and it < iters:
        nlo, nhi, mid = [lo] + [None] * (points - 1), [hi] + [None] * (points - 1), []
        for j in range(points):
            mid.append(HALF * (nlo[j] + nhi[j]))
            if 2 * j + 2 < points:
                nlo[2 * j + 1], nhi[2 * j + 1] = nlo[j], mid[j]
                nlo[2 * j + 2], nhi[2 * j + 2] = mid[j], nhi[j]
        values = [phi(m) for m in mid]   # one block reduction
        reductions += 1
        j = level = 0
        while level < levels and it < iters:
            m = mid[j]
            if m == lo or m == hi:
                stop = True
                break
            if values[j] > r:
                lo, j = m, 2 * j + 2
            else:
                hi, j = m, 2 * j + 1
            level += 1
            it += 1
    return HALF * (lo + hi), it, reductions


def kernel_theta(v, r, levels=LEVELS, fmax=True):
    """The kernel's bisect θ of one float32 vector (θ = 0 inside, as the
    kernel skips the solve there) with its steps and reductions."""
    a = v.abs()
    if bool(a.sum() <= r):
        return F32(0.0), 0, 0
    return bisect_schedule(_phi(a, fmax), F32(r), F32(a.max().item()), levels)


def _vec(n, seed, scale=2.0):
    return torch.from_numpy(
        (np.random.default_rng(seed).normal(size=n) * scale).astype(np.float32))


def _cases():
    """(name, v, r): seeded vectors at n = 1, 127, 2048 and the corners."""
    out = []
    for n in (1, 127, 2048):
        v = _vec(n, n)
        s = float(v.abs().sum())
        for name, r in (("mid", 0.3 * s), ("inside", 2.0 * s), ("zero", 0.0),
                        ("just_under", s * (1 - 1e-6)), ("tiny", 1e-3 * s)):
            out.append((f"n{n}_{name}", v, F32(r)))
    out.append(("equal", torch.full((300,), 0.75), F32(10.0)))
    out.append(("equal_2048", torch.full((2048,), 1.5), F32(1000.0)))
    v = _vec(127, 7)
    v[5] = float("nan")
    out.append(("nan", v, F32(3.0)))
    v = _vec(127, 8)
    v[9] = float("inf")
    out.append(("inf", v, F32(3.0)))
    v = _vec(127, 9)
    v[9] = -float("inf")
    out.append(("minus_inf", v, F32(3.0)))
    return out


CASES = _cases()


def _same(a, b):
    np.testing.assert_array_equal(np.asarray(a, np.float32),
                                  np.asarray(b, np.float32))


@pytest.mark.parametrize("levels", [1, 2, 3])
@pytest.mark.parametrize("name,v,r", CASES, ids=[c[0] for c in CASES])
def test_schedule_theta_is_the_64_step_theta(name, v, r, levels):
    """Early stop and speculation give the 64-step θ bit for bit, with the
    same φ (the plain version's clamp) and with the kernel's fmaxf."""
    a = v.abs()
    hi = F32(a.max().item())
    want = bisect_steps(_phi(a), r, hi)
    for fmax in (False, True):
        got, steps, reductions = bisect_schedule(_phi(a, fmax), r, hi, levels)
        _same(got, want)
        assert steps <= ITERS and reductions <= -(-ITERS // levels)


@pytest.mark.parametrize("name,v,r", CASES, ids=[c[0] for c in CASES])
def test_model_projection_equals_the_plain_version(name, v, r):
    """θ = 0 inside, else the schedule's θ: the projection equals
    ``project_l1_plain(..., "bisect")`` exactly, NaN and ±inf included."""
    theta, _, _ = kernel_theta(v, r)
    got = torch.sign(v) * torch.clamp(v.abs() - torch.tensor(theta), min=0.0)
    want = tl1ball.project_l1_plain(v[None], torch.tensor([r]), "bisect")[0]
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


def test_w1_like_aggregate_stops_well_before_64_steps():
    """On the column maxima of a W1-like request, (8192, 2048) normals × 2
    at its radius fraction, and with r just under Σ|v|, the early stop
    leaves most of the 64 steps out: the kernel's reductions per call (one
    for Σ|v| and max|v|, one per speculated round) against the 65 of the
    step-by-step kernel."""
    rng = np.random.default_rng(0)
    y = rng.standard_normal((8192, 2048), dtype=np.float32) * 2.0
    v = torch.from_numpy(np.abs(y).max(axis=0))
    s = float(v.sum())
    counts = {}
    for name, r in (("w1", F32(0.3 * s)), ("just_under", F32(s * (1 - 1e-6)))):
        theta, steps, reductions = kernel_theta(v, r)
        want = bisect_steps(_phi(v), r, F32(v.max().item()))
        _same(theta, want)
        counts[name] = (steps, 1 + reductions)
        assert steps < ITERS
    print(f"LEVELS={LEVELS}: (steps, block reductions) per call {counts} "
          f"against (64, 65)")
    for steps, reductions in counts.values():
        # a round per LEVELS steps, one more where the stop opens a round
        assert reductions <= 2 + steps // LEVELS
    assert counts["w1"][0] <= 30 and counts["w1"][1] <= 16


def _filter_fused(v, r):
    """The filter with the kernel's one reduction per sweep: the active sum
    and the active count (as float32) folded together."""
    a = v.abs()[None]
    rr = torch.tensor([[r]])
    s0 = a.sum(dim=1, keepdim=True)
    n = a.shape[1]
    theta = (s0 - rr) / n
    count, changed, it = n, True, 0
    while changed and it < n + 2:
        active = a > theta
        both = torch.stack([torch.where(active, a, torch.zeros_like(a)),
                            active.to(a.dtype)]).sum(dim=-1, keepdim=True)
        ssum, new_count = both[0], int(both[1].item())
        new_theta = (ssum - rr) / new_count if new_count > 0 else theta
        changed = new_count != count and new_count > 0
        theta, count = new_theta, new_count
        it += 1
    theta = torch.clamp(theta, min=0.0)
    theta = torch.where(s0 <= rr, torch.zeros_like(theta), theta)
    return torch.sign(v) * torch.clamp(v.abs() - theta[0], min=0.0)


@pytest.mark.parametrize("name,v,r", [c for c in CASES
                                      if c[0] not in ("nan", "inf", "minus_inf")],
                         ids=[c[0] for c in CASES
                              if c[0] not in ("nan", "inf", "minus_inf")])
def test_fused_filter_reduction_equals_the_plain_filter(name, v, r):
    want = tl1ball.project_l1_plain(v[None], torch.tensor([r]), "filter")[0]
    torch.testing.assert_close(_filter_fused(v, r), want, rtol=0, atol=0)


@pytest.mark.parametrize("n", [127, 2048])
def test_model_matches_pallas_interpret(n):
    """The model's projection against JAX's bisection kernel in interpret
    mode: within JAX's own 1e-5 (another summation order of φ)."""
    v = _vec(n, 100 + n)
    r = F32(0.25 * float(v.abs().sum()))
    theta, _, _ = kernel_theta(v, r)
    got = torch.sign(v) * torch.clamp(v.abs() - torch.tensor(theta), min=0.0)
    want = np.asarray(jl1ball.project_l1_pallas(jnp.asarray(v.numpy()), float(r),
                                                method="bisect", interpret=True))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_register_and_shared_memory_limits_cover_the_main_path():
    """The kernel holds the main path's 2048-value aggregate in registers,
    its one-CTA shared-memory path the lengths up to L1_ONE_CTA_MAX, and
    its cluster path (up to CLUSTER_MAX CTAs of shared memory) every
    length the tiler lets through, JAX's L1_KERNEL_MAX."""
    from repro_torch.kernels.codegen import tiling

    assert _constant("THREADS") * _constant("REG_ELEMS") >= 2048
    assert f"constexpr int SMEM_MAX = {tiling.SMEM_BUDGET_BYTES // 1024} * 1024;" \
        in SOURCE.read_text()
    assert tl1ball.L1_ONE_CTA_MAX * 4 <= tiling.SMEM_BUDGET_BYTES
    assert "constexpr int L1_MAX = 512 * 1024;" in SOURCE.read_text()
    assert tl1ball.L1_KERNEL_MAX == jl1ball.L1_KERNEL_MAX == 512 * 1024
    assert tl1ball.L1_KERNEL_MAX * 4 <= _constant("CLUSTER_MAX") * tiling.SMEM_BUDGET_BYTES


def test_reductions_per_call_on_the_paper_workloads():
    """Block reductions per bisect call (one for Σ|v| and max|v|, one per
    speculated round) on the outer aggregates of phase 3's W3 (Fig. 1,
    (1000, 10000) uniform from seed 0, at its five η) and W4 (Fig. 3,
    (32, 1000, 2000) uniform from seed 2, η = 1), printed beside the 65 of
    a 64-step kernel; each θ equals the 64-step θ."""
    counts = {}
    y3 = np.random.default_rng(0).uniform(0.0, 1.0, (1000, 10000)).astype(np.float32)
    v3 = torch.from_numpy(np.abs(y3).max(axis=0))
    for eta in (0.25, 0.5, 1.0, 2.0, 4.0):
        theta, steps, reductions = kernel_theta(v3, F32(eta))
        _same(theta, bisect_steps(_phi(v3), F32(eta), F32(v3.max().item())))
        counts[f"W3 η={eta}"] = (steps, 1 + reductions)
    del y3
    y4 = np.random.default_rng(2).uniform(0.0, 1.0, (32, 1000, 2000)).astype(np.float32)
    v4 = torch.from_numpy(np.abs(y4).max(axis=(0, 1)))
    del y4
    theta, steps, reductions = kernel_theta(v4, F32(1.0))
    _same(theta, bisect_steps(_phi(v4), F32(1.0), F32(v4.max().item())))
    counts["W4 η=1"] = (steps, 1 + reductions)
    print(f"LEVELS={LEVELS}: (steps, block reductions) per call {counts} "
          f"against (64, 65)")
    assert all(r <= 2 + s // LEVELS and s < ITERS for s, r in counts.values())
