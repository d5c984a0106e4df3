"""A CPU model of the bf16 tensor-core flash kernels' arithmetic
(``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu``, namespace ``tc``), held
against the port's plain versions at ``chip_smoke.py``'s bf16 bars.

The model repeats, in PyTorch on the CPU, what the kernels do with bf16
operands: products of bf16 values summed in float32; logits scaled by
scale · log2(e) and exponentiated base 2, with the TPU kernel's sentinels
(a masked slot is -1e30, a key past the live blocks -inf, lse = m · ln 2 +
log(l) or -1e30 + log(l) while m is the sentinel); the forward walks
key tiles of 64 from the q block's first live slot and moves a row's
reference max m only when the tile's max passes it by more than 8;
every register operand of a second product (P in the forward, Pᵀ and dSᵀ
in dK/dV, dS in dQ) is split into two bf16 terms, hi = x with its low 16 bits
dropped (bf16 rounded toward zero) and lo = bf16(x - hi) rounded to
nearest, so |x - hi - lo| <= 2**-16 |x|; dQ subtracts rowsum(dS) · k̄ (the
mean key, float32) from its float32 sum before · scale; o, dq, dk and dv
are rounded to bf16 once. The plain versions run at the kernels' default TPU blocks (128), the
blocks the kernels take.

Bars (``chip_smoke.py``: ``hold_attention``, ``BF16_RTOL`` = 2**-7): o
within 1e-5 · 2 + 2**-7 |want|, lse within 1e-5 + 1e-5 |want|, dq, dk and dv
within 1e-5 · max|want| + 2**-7 |want|: one bf16 rounding of a float32
result that the two versions sum in another order. The model makes no
claim about the kernels themselves; ``chip_smoke.py`` holds those on the
card.

Cases: ``tests/test_torch_flash_backward.py``'s, plus granite-3-2b's head
layout cut to (1, 4, 256, 64) / (1, 1, 256, 64) causal (GQA group 4).
"""

import math
import sys

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as tflash
from test_torch_flash_backward import CASES

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
NEG = -1e30
RTOL = 2.0 ** -7

SPLIT_CASES = [(name, qs, ks, causal, window)
               for name, qs, ks, causal, window, _, _ in CASES] + [
    ("granite_heads_gqa", (1, 4, 256, 64), (1, 1, 256, 64), True, None)]


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _split(x):
    hi = (x.view(torch.int32) & -65536).view(torch.float32)  # low 16 bits dropped
    return hi, _bf16(x - hi)


def _valid(qpos, kpos, sk, causal, window):
    ok = (kpos < sk) & (qpos < sk)
    if causal:
        ok = ok & (kpos <= qpos)
    if window is not None:
        ok = ok & (kpos > qpos - window)
    return ok


def _live_slots(r0, sq, sk, causal, window, bq, bk):
    """The key slots [lo, hi) of the live TPU blocks of the q block at r0."""
    qs = (r0 // bq) * bq + sk - sq
    nkb = -(-sk // bk)
    lo, hi = 0, nkb
    if causal:
        last = qs + bq - 1
        hi = 0 if last < 0 else min(nkb, last // bk + 1)
    if window is not None:
        lo = max(0, math.floor((qs - window - bk + 1) / bk) + 1)
    return (lo * bk, hi * bk) if hi > lo else (0, 0)


def model_forward(q, k, v, *, causal, window, block_q=128, block_k=128):
    """(o, lse) as the tensor-core forward computes them."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    tile = 64
    scale2 = d ** -0.5 * LOG2E
    bq, bk = min(block_q, sq), min(block_k, sk)
    pad = -(-sk // tile) * tile + tile
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, pad - sk))
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, pad - sk))
    kf, vf = (x.repeat_interleave(hq // hkv, dim=1) for x in (kf, vf))
    o = torch.zeros(b, hq, sq, d)
    lse = torch.zeros(b, hq, sq)
    for r0 in range(0, sq, bq):
        n = min(bq, sq - r0)
        qb = q[:, :, r0:r0 + n].float()
        qpos = torch.arange(r0, r0 + n)[:, None] + sk - sq
        lo, hi = _live_slots(r0, sq, sk, causal, window, bq, bk)
        m = torch.full((b, hq, n), NEG)
        l = torch.zeros(b, hq, n)
        acc = torch.zeros(b, hq, n, d)
        for k0 in range(lo, hi, tile):
            kpos = torch.arange(k0, k0 + tile)[None, :]
            s = torch.einsum("bhqd,bhkd->bhqk", qb, kf[:, :, k0:k0 + tile])
            slot = (kpos >= lo) & (kpos < hi)
            x = torch.where(_valid(qpos, kpos, sk, causal, window),
                            s * scale2, torch.tensor(NEG))
            x = torch.where(slot, x, torch.tensor(-math.inf))
            # the reference max moves only past a jump of 8 (p <= 2**8)
            mc = x.amax(-1)
            move = mc > m + 8
            corr = torch.where(move, torch.exp2(m - mc), torch.ones_like(m))
            m = torch.where(move, mc, m)
            p = torch.exp2(x - m[..., None])
            l = corr * l + p.sum(-1)
            p_hi, p_lo = _split(p)
            vt = vf[:, :, k0:k0 + tile]
            acc = acc * corr[..., None] + p_hi @ vt + p_lo @ vt
        denom = torch.where(l == 0, torch.ones_like(l), l)
        o[:, :, r0:r0 + n] = acc / denom[..., None]
        lse[:, :, r0:r0 + n] = torch.where(m == NEG, m, m * LN2) + torch.log(denom)
    return o.to(q.dtype), lse


def model_dkv(q, k, v, do, lse, delta, *, causal, window):
    """(dk, dv) as the tensor-core dK/dV kernel computes them."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = d ** -0.5
    kf, vf = (x.float().repeat_interleave(g, dim=1) for x in (k, v))
    qf, dof = q.float(), do.float()
    qpos = torch.arange(sq)[:, None] + sk - sq
    ok = _valid(qpos, torch.arange(sk)[None, :], sk, causal, window)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    # selected, not multiplied: a row no key reaches overflows exp2
    p = torch.where(ok, torch.exp2(s * (scale * LOG2E) - (lse * LOG2E)[..., None]), 0.0)
    ds = torch.where(ok, p * (dp - delta[..., None]), 0.0)
    p_hi, p_lo = _split(p)
    ds_hi, ds_lo = _split(ds)
    dv = torch.einsum("bhqk,bhqd->bhkd", p_hi, dof) + torch.einsum("bhqk,bhqd->bhkd", p_lo, dof)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds_hi, qf) + torch.einsum("bhqk,bhqd->bhkd", ds_lo, qf)
    dk = dk.reshape(b, hkv, g, sk, d).sum(2) * scale
    dv = dv.reshape(b, hkv, g, sk, d).sum(2)
    return dk.to(k.dtype), dv.to(v.dtype)


def model_dq(q, k, v, do, lse, delta, *, causal, window, centre=True):
    """dq as the tensor-core dQ kernel computes it: S = Q Kᵀ and dP = dO Vᵀ
    in float32 from bf16 operands, dS selected to 0 where a pair is not
    valid, dS split into hi + lo, each times bf16 K, less rowsum(dS) · k̄
    (``centre``; the float32 sum of dS, k̄ the float32 mean of each kv
    head's keys); dq · scale rounded to bf16 once."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = d ** -0.5
    kf, vf = (x.float().repeat_interleave(g, dim=1) for x in (k, v))
    qpos = torch.arange(sq)[:, None] + sk - sq
    ok = _valid(qpos, torch.arange(sk)[None, :], sk, causal, window)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), vf)
    p = torch.exp2(s * (scale * LOG2E) - (lse * LOG2E)[..., None])
    # selected, not multiplied: a row no key reaches overflows exp2
    ds = torch.where(ok, p * (dp - delta[..., None]), 0.0)
    ds_hi, ds_lo = _split(ds)
    dq = ds_hi @ kf + ds_lo @ kf
    if centre:
        kbar = k.float().mean(dim=2, keepdim=True).repeat_interleave(g, dim=1)
        dq = dq - ds.sum(-1, keepdim=True) * kbar
    return (dq * scale).to(q.dtype)


def _inputs(qs, ks, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=s_).astype(np.float32)).to(torch.bfloat16)
            for s_ in (qs, ks, ks, qs)]


def _assert_bar(what, got, want, scale, rtol):
    err = (got.float() - want.float()).abs()
    bar = 1e-5 * scale + rtol * want.float().abs()
    assert bool(torch.isfinite(got.float()).all()), f"{what}: non-finite values"
    worst = float((err / bar).max())
    assert worst <= 1.0, f"{what}: {worst:.3f} of the bar (max abs err {float(err.max()):.3e})"


def _ids(case):
    return case[0]


@pytest.mark.parametrize("case", SPLIT_CASES, ids=_ids)
def test_split_forward_holds_the_bf16_bar(case):
    name, qs, ks, causal, window = case
    q, k, v, _ = _inputs(qs, ks, 20)
    o, lse = model_forward(q, k, v, causal=causal, window=window)
    po, plse = tflash.flash_attention_plain(q, k, v, causal=causal, window=window)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    _assert_bar(f"{name} o", o, po, 2.0, RTOL)
    _assert_bar(f"{name} lse", lse, plse, 1.0, 1e-5)


@pytest.mark.parametrize("case", SPLIT_CASES, ids=_ids)
def test_split_dkv_holds_the_bf16_bar(case):
    """The model's dK/dV from the model's own (o, lse), as on the card the
    kernel's forward feeds both backwards."""
    name, qs, ks, causal, window = case
    q, k, v, do = _inputs(qs, ks, 21)
    o, lse = model_forward(q, k, v, causal=causal, window=window)
    delta = (do.float() * o.float()).sum(-1)
    dk, dv = model_dkv(q, k, v, do, lse, delta, causal=causal, window=window)
    _, wdk, wdv = tflash.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                   causal=causal, window=window)
    for n, got, want in (("dk", dk, wdk), ("dv", dv, wdv)):
        assert got.dtype == torch.bfloat16
        _assert_bar(f"{name} {n}", got, want, float(want.float().abs().max()), RTOL)


def _dq_case(case, seed=22):
    """The model's dq and the plain version's from the model's own (o, lse),
    as on the card the kernel's forward feeds the backward."""
    name, qs, ks, causal, window = case
    q, k, v, do = _inputs(qs, ks, seed)
    o, lse = model_forward(q, k, v, causal=causal, window=window)
    delta = (do.float() * o.float()).sum(-1)
    dq = model_dq(q, k, v, do, lse, delta, causal=causal, window=window)
    want, _, _ = tflash.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                  causal=causal, window=window)
    return dq, want


@pytest.mark.parametrize("case", SPLIT_CASES, ids=_ids)
def test_split_dq_holds_the_bf16_bar(case):
    dq, want = _dq_case(case)
    assert dq.dtype == torch.bfloat16
    _assert_bar(f"{case[0]} dq", dq, want, float(want.float().abs().max()), RTOL)


@pytest.mark.parametrize("causal", [False, True])
def test_dq_subtracts_the_rowsum_times_the_mean_key(causal):
    """Keys that share most of their value, k̄ + 0.01·ε (a cross-attention
    over the encoder states of silent audio): the model's dq, less
    rowsum(dS) · k̄, lies within one bf16 rounding of its largest entry
    (2**-7 of it) from the plain version's; without the subtraction, dS's
    rows, which sum to 0 only up to rounding, carry that rounding times k̄
    into dq, 50 times farther. (The per-entry bar of the other cases does
    not hold here: dS's split, 2**-16 of it, times k̄ is about 2**-16 ·
    200 of dq's largest entry, more than 1e-5 of it.)"""
    rng = np.random.default_rng(23)
    qs, ks = (1, 2, 96, 64), (1, 1, 160, 64)
    q, v, do = (torch.from_numpy(rng.normal(size=s_).astype(np.float32))
                .to(torch.bfloat16) for s_ in (qs, ks, qs))
    k = torch.from_numpy((2 * rng.normal(size=(1, 1, 1, 64))
                          + 0.01 * rng.normal(size=ks)).astype(np.float32)
                         ).to(torch.bfloat16)
    o, lse = model_forward(q, k, v, causal=causal, window=None)
    delta = (do.float() * o.float()).sum(-1)
    want = tflash.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                            causal=causal)[0]
    bar = RTOL * float(want.float().abs().max())
    dq, raw = (model_dq(q, k, v, do, lse, delta, causal=causal, window=None,
                        centre=c).float() for c in (True, False))
    assert float((dq - want.float()).abs().max()) <= bar
    assert float((raw - want.float()).abs().max()) > 20 * bar


def test_one_bf16_ds_term_misses_the_dq_bar(monkeypatch):
    """Why the dQ kernel splits dS: with one bf16 term, dq lands outside the
    bar on granite's head layout."""
    monkeypatch.setattr(sys.modules[__name__], "_split",
                        lambda x: (_bf16(x), torch.zeros_like(x)))
    dq, want = _dq_case(SPLIT_CASES[-1])
    with pytest.raises(AssertionError, match="of the bar"):
        _assert_bar("one term dq", dq, want, float(want.float().abs().max()), RTOL)


def test_split_holds_an_operand_to_2_pow_minus_16():
    """hi + lo is within 2**-16 of x (relative, either sign) where hi alone
    is up to 2**-7 off; both terms are bf16 values."""
    x = np.random.default_rng(3).uniform(1e-6, 1.0, 4096).astype(np.float32)
    x = torch.from_numpy(np.concatenate([x, -x]))
    hi, lo = _split(x)
    assert torch.equal(_bf16(hi), hi) and torch.equal(_bf16(lo), lo)
    assert float(((hi + lo - x).abs() / x.abs()).max()) <= 2.0 ** -16
    assert float(((hi - x).abs() / x.abs()).max()) > 2.0 ** -8


def test_one_bf16_term_misses_the_bar(monkeypatch):
    """Why the kernels split: with P rounded to one bf16 term, o lands far
    outside the bar on granite's head layout (entries of o near 0 carry an
    error of about 2**-8 · |v| / sqrt(n))."""
    _, qs, ks, causal, window = SPLIT_CASES[-1]
    q, k, v, _ = _inputs(qs, ks, 20)
    po, _ = tflash.flash_attention_plain(q, k, v, causal=causal, window=window)
    monkeypatch.setattr(sys.modules[__name__], "_split",
                        lambda x: (_bf16(x), torch.zeros_like(x)))
    o, _ = model_forward(q, k, v, causal=causal, window=window)
    with pytest.raises(AssertionError, match="of the bar"):
        _assert_bar("one term o", o, po, 2.0, RTOL)
