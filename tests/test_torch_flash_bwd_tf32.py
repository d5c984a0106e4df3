"""A CPU model of the float32 tensor-core flash backward's arithmetic
(``csrc/flash_bwd.cu``, namespace ``tc``: ``flash_bwd_dq_tf32``,
``flash_bwd_dkv_tf32`` and their pre-pass), held against the port's plain
backward at ``chip_smoke.py``'s float32 bar.

The model repeats, in PyTorch on the CPU, what the kernels do: every
operand of a product in two TF32 terms, big = tf32(x) and small = tf32(x -
big), each product as three, small·big + big·small + big·big, summed in
float32 (``test_torch_flash_tf32.mm3``); S = Q Kᵀ and dP = dO Vᵀ, P =
2^(S · scale · log2 e - lse · log2 e) and dS = P ∘ (dP - delta) selected
to 0 where a pair is not valid; dQ = dS (K - k̄), k̄ each kv head's mean
key and K - k̄ formed in float32 before the split, summed over tiles of 32
keys (16 at D = 128) and dK, dV over tiles of 16 query rows (8 at D =
128), the GQA group summed last; dq · scale, dk · scale and dv in float32. The (o, lse) that
feed it come from the float32 forward's model, as on the card the
kernel's forward feeds the backward. With one TF32 product per product
(big·big) the same model misses the bar, and the tests assert that it
does.

dS enters dQ += dS K, and Pᵀ and dSᵀ enter dV += Pᵀ dO and dK += dSᵀ Q,
straight from the accumulator of S or Sᵀ, so the pre-pass writes Kᵀ, Qᵀ
and dOᵀ with their rows permuted within each group of 8, as the forward
writes Vᵀ; the tests hold the permuted products to the unpermuted ones
exactly at the kernels' tile widths.

Bar (``chip_smoke.py``: ``hold_attention``): dq, dk and dv within 1e-5 of
the tensor's largest entry + 1e-5 |want|. The model makes no claim about
the kernels themselves; ``chip_smoke.py`` holds those on the card.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as tflash
from test_torch_flash_split import _valid
from test_torch_flash_tf32 import (CASES, LOG2E, a_from_accumulator, mm3,
                                   model_forward, vt_slot_key)


def dq_tile(d):
    """Keys per streamed tile of the dQ kernel (``F32Dq<D>::BK``)."""
    return 16 if d == 128 else 32


def dkv_tile(d):
    """Query rows per streamed tile of the dK/dV kernel (``F32Dkv<D>::TQ``)."""
    return 8 if d == 128 else 16


def _scores(q, k, v, do, lse, delta, causal, window, terms):
    """P and dS over (b, hq, sq, sk), k and v repeated over the group."""
    hq, sq, d = q.shape[1:]
    hkv, sk = k.shape[1], k.shape[2]
    kf, vf = (x.repeat_interleave(hq // hkv, dim=1) for x in (k, v))
    ok = _valid(torch.arange(sq)[:, None] + sk - sq, torch.arange(sk)[None, :],
                sk, causal, window)
    s = mm3(q, kf.transpose(-1, -2), terms)
    dp = mm3(do, vf.transpose(-1, -2), terms)
    p = torch.exp2(s * (d ** -0.5 * LOG2E) - (lse * LOG2E)[..., None])
    # selected, not multiplied: a row no key reaches overflows exp2
    ds = torch.where(ok, p * (dp - delta[..., None]), 0.0)
    return torch.where(ok, p, 0.0), ds, kf


def model_dq(q, k, v, do, lse, delta, *, causal, window, terms=3, centre=True):
    """dq as the float32 dQ kernel computes it: dS times K - k̄ (K with
    ``centre=False``) tile by tile."""
    d, sk = q.shape[-1], k.shape[2]
    _, ds, kf = _scores(q, k, v, do, lse, delta, causal, window, terms)
    if centre:
        kf = kf - k.mean(dim=2, keepdim=True).repeat_interleave(
            q.shape[1] // k.shape[1], dim=1)
    dq = torch.zeros_like(q)
    bk = dq_tile(d)
    for k0 in range(0, sk, bk):  # a tile with no valid pair adds 0
        dq += mm3(ds[..., k0:k0 + bk], kf[:, :, k0:k0 + bk], terms)
    return dq * d ** -0.5


def model_dkv(q, k, v, do, lse, delta, *, causal, window, terms=3):
    """(dk, dv) as the float32 dK/dV kernel computes them: Pᵀ dO and dSᵀ Q
    tile by tile over the query rows, then the GQA group's sum."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    p, ds, _ = _scores(q, k, v, do, lse, delta, causal, window, terms)
    dk = torch.zeros(b, hq, sk, d)
    dv = torch.zeros(b, hq, sk, d)
    tq = dkv_tile(d)
    for q0 in range(0, sq, tq):
        rows = slice(q0, q0 + tq)
        dv += mm3(p[:, :, rows].transpose(-1, -2), do[:, :, rows], terms)
        dk += mm3(ds[:, :, rows].transpose(-1, -2), q[:, :, rows], terms)
    g = hq // hkv
    return (dk.reshape(b, hkv, g, sk, d).sum(2) * d ** -0.5,
            dv.reshape(b, hkv, g, sk, d).sum(2))


def _case(case, terms, seed=40):
    """The model's (dq, dk, dv) and the plain backward's on the same
    inputs, both from the forward model's (o, lse)."""
    _, qs, ks, causal, window = case
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.normal(size=s_).astype(np.float32))
                   for s_ in (qs, ks, ks, qs))
    o, lse = model_forward(q, k, v, causal=causal, window=window)
    delta = (do * o).sum(-1)
    opts = dict(causal=causal, window=window, terms=terms)
    got = (model_dq(q, k, v, do, lse, delta, **opts),
           *model_dkv(q, k, v, do, lse, delta, **opts))
    want = tflash.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                            window=window)
    return got, want


def _worst(got, want):
    """The largest error as a fraction of the float32 bar."""
    err = (got - want).abs()
    return float((err / (1e-5 * float(want.abs().max()) + 1e-5 * want.abs())).max())


def _ids(case):
    return case[0]


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_three_products_hold_the_float32_bar(case):
    got, want = _case(case, terms=3)
    for n, g, w in zip(("dq", "dk", "dv"), got, want):
        assert bool(torch.isfinite(g).all()), f"{case[0]} {n}"
        assert _worst(g, w) <= 1.0, f"{case[0]} {n}: {_worst(g, w):.3f} of the bar"


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_one_product_misses_the_float32_bar(case):
    got, want = _case(case, terms=1)
    assert max(_worst(g, w) for g, w in zip(got, want)) > 1.0, case[0]


@pytest.mark.parametrize("rows,d", [(32, 64), (16, 128), (16, 64), (8, 128),
                                    (32, 16), (16, 32)])
def test_permuted_transposes_equal_unpermuted(rows, d):
    """Kᵀ (dQ: tiles of 32 keys, 16 at D = 128) and Qᵀ, dOᵀ (dK/dV: tiles
    of 16 query rows, 8 at D = 128) as the pre-pass writes them: with the
    A operand rebuilt from the accumulator's fragments, the product equals
    the unpermuted one bit for bit."""
    rng = np.random.default_rng(rows + d)
    # small integers: every sum exact, so the two orders agree bit for bit
    a_acc = torch.from_numpy(rng.integers(-8, 9, size=(64, rows)).astype(np.float32))
    x = torch.from_numpy(rng.integers(-8, 9, size=(rows, d)).astype(np.float32))
    slots = torch.tensor([vt_slot_key(c) for c in range(rows)])
    assert torch.equal(torch.sort(slots).values, torch.arange(rows))
    xt = x[slots].T                       # (d, rows): the pre-pass's tile
    a = a_from_accumulator(a_acc)
    assert not bool(a.isnan().any())      # every fragment slot filled once
    assert torch.equal(a @ xt.T, a_acc @ x)


@pytest.mark.parametrize("causal", [False, True])
def test_dq_takes_the_keys_less_their_mean(causal):
    """Keys that share most of their value, k̄ + 0.01·ε (a cross-attention
    over the encoder states of silent audio): the model's dq against
    K - k̄ holds the float32 bar against the plain version; against K, the
    rounding of dS's rows, which sum to 0 in exact arithmetic, times k̄
    lands far outside it."""
    rng = np.random.default_rng(41)
    qs, ks = (1, 2, 96, 64), (1, 1, 160, 64)
    q, v, do = (torch.from_numpy(rng.normal(size=s_).astype(np.float32))
                for s_ in (qs, ks, qs))
    k = torch.from_numpy((2 * rng.normal(size=(1, 1, 1, 64))
                          + 0.01 * rng.normal(size=ks)).astype(np.float32))
    o, lse = model_forward(q, k, v, causal=causal, window=None)
    delta = (do * o).sum(-1)
    want = tflash.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                            causal=causal)[0]
    opts = dict(causal=causal, window=None)
    assert _worst(model_dq(q, k, v, do, lse, delta, **opts), want) <= 1.0
    assert _worst(model_dq(q, k, v, do, lse, delta, centre=False, **opts),
                  want) > 1.0


def test_bwd_scratch_holds_the_mean_key_first():
    """``bwd_work_floats``: dQ's k̄ (b · hkv · d floats) in both types, then
    in float32 its planes; dK/dV's planes in float32, none in bf16."""
    g = (2, 8, 2, 100, 70, 64)
    assert tflash.bwd_work_floats(*g, dkv=False, bf16=True) == 2 * 2 * 64
    assert tflash.bwd_work_floats(*g, dkv=True, bf16=True) == 0
    assert tflash.bwd_work_floats(*g, dkv=False, bf16=False) \
        == 2 * 2 * 64 + tflash.tf32_bwd_work_floats(*g, dkv=False)
    assert tflash.bwd_work_floats(*g, dkv=True, bf16=False) \
        == tflash.tf32_bwd_work_floats(*g, dkv=True)


def test_bwd_work_buffer_holds_every_plane():
    """``tf32_bwd_work_floats``: the two terms of the operands the pre-pass
    writes, as they are and transposed with their rows padded to a multiple
    of 32: dQ's k, v and kᵀ, dK/dV's q, dO, qᵀ, dOᵀ, k and v."""
    b, hq, hkv, sq, sk, d = 2, 8, 2, 100, 70, 64
    assert tflash.tf32_bwd_work_floats(b, hq, hkv, sq, sk, d, dkv=False) \
        == 2 * (2 * b * hkv * sk * d + b * hkv * d * 96)
    assert tflash.tf32_bwd_work_floats(b, hq, hkv, sq, sk, d, dkv=True) \
        == 2 * (2 * b * hq * sq * d + 2 * b * hq * d * 128 + 2 * b * hkv * sk * d)
    # granite-3-2b's training shape: 0.10 GB (dQ) and 0.60 GB (dK/dV)
    g = (4, 32, 8, 2048, 2048, 64)
    assert tflash.tf32_bwd_work_floats(*g, dkv=False) * 4 == 100_663_296
    assert tflash.tf32_bwd_work_floats(*g, dkv=True) * 4 == 603_979_776


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_each_type_launches_its_own_backward(monkeypatch, dtype):
    """A float32 backward launches the 3×TF32 kernels (``flash_bwd_dq_tf32``,
    ``flash_bwd_dkv_tf32``), a bf16 one the bf16 kernels (``flash_bwd_dq``,
    ``flash_bwd_dkv``): one export each, counted apart, the scratch's size
    passed for the export to check."""
    from test_torch_no_fallback import _reach_the_launch, _stand_in

    _reach_the_launch(monkeypatch)
    f32 = dtype == torch.float32
    pairs = ((tflash.DQ_TF32_KERNEL, tflash.DQ_KERNEL),
             (tflash.DKV_TF32_KERNEL, tflash.DKV_KERNEL))
    calls = {}
    for tf, bf in pairs:
        used, other = (tf, bf) if f32 else (bf, tf)
        calls[used.name] = _stand_in(monkeypatch, used, 0)[1]
        monkeypatch.setattr(other, "launches", 0)
    b, hq, hkv, sq, sk, d = 1, 4, 2, 96, 80, 64
    q = torch.empty(b, hq, sq, d, device="meta", dtype=dtype)
    kv = torch.empty(b, hkv, sk, d, device="meta", dtype=dtype)
    lse = torch.empty(b, hq, sq, device="meta")
    dq, dk, dv = tflash.flash_attention_bwd(q, kv, kv, q, lse, q)
    assert dq.shape == q.shape and dk.shape == dv.shape == kv.shape
    for tf, bf in pairs:
        used, other = (tf, bf) if f32 else (bf, tf)
        assert used.launches == 1 and other.launches == 0
    suffix = "_tf32" if f32 else ""
    (dq_call,), (dkv_call,) = calls[f"flash_bwd_dq{suffix}"], calls[f"flash_bwd_dkv{suffix}"]
    want = [tflash.bwd_work_floats(b, hq, hkv, sq, sk, d, dkv=x, bf16=not f32)
            for x in (False, True)]
    assert dq_call[8] == want[0] and dkv_call[9] == want[1]
    assert dq_call[9:15] == dkv_call[10:16] == (b, hq, hkv, sq, sk, d)
    assert dq_call[-2] == dkv_call[-2] == int(not f32)
