"""A CPU model of the float32 tensor-core flash forward's arithmetic
(``csrc/flash_fwd.cu``, namespace ``tc``: ``flash_fwd_tf32`` and its
pre-pass), held against the port's plain version at ``chip_smoke.py``'s
float32 bars.

The model repeats, in PyTorch on the CPU, what the kernel does: every
operand of a product rounded to TF32 (the mantissa to 10 bits, to nearest
with ties away from zero, as ``cvt.rna.tf32.f32``) in two terms, big =
tf32(x) and small = tf32(x - big); each product as three, small·big +
big·small + big·big, summed in float32; logits scaled by scale · log2(e)
and exponentiated base 2 with the TPU kernel's sentinels; key tiles of 64
(32 at D = 128) from the q block's first live slot; a row's reference max
moved only when a tile's max passes it by more than 8. With one TF32
product per product (big·big) the same model misses the bars, and the tests
assert that it does.

The kernel feeds P to O += P V straight from the S accumulator: a thread
holds keys 2t, 2t + 1 of each group of 8 of its rows, where the tf32 A
fragment of a k step of 8 wants columns t and t + 4. So the pre-pass
stores Vᵀ with its keys permuted within each group of 8 (slot c holds key
2c for c < 4, 2(c - 4) + 1 above), and the tests rebuild the A operand
from the accumulator's fragment layout and hold the permuted product to the
unpermuted one exactly.

Bars (``chip_smoke.py``: ``hold_attention``): o within 1e-5 · 2 + 1e-5
|want|, lse within 1e-5 + 1e-5 |want|. The model makes no claim about the
kernel itself; ``chip_smoke.py`` holds that on the card.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as tflash
from test_torch_flash_split import _live_slots, _valid

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
NEG = -1e30

# chip_smoke.py FLASH_CASES at D = 16, 32, 64 and 128: plain causal, GQA,
# block-unaligned, a window, Sq < Sk, Sq > Sk, the smoke LM's heads
CASES = [
    ("d64_causal", (1, 1, 128, 64), (1, 1, 128, 64), True, None),
    ("d128_gqa", (1, 8, 384, 128), (1, 1, 384, 128), True, None),
    ("d64_gqa4", (1, 8, 384, 64), (1, 2, 384, 64), True, None),
    ("d64_unaligned", (2, 2, 257, 64), (2, 2, 257, 64), True, None),
    ("d64_window", (1, 2, 384, 64), (1, 2, 384, 64), True, 128),
    ("d64_cross", (1, 2, 100, 64), (1, 2, 300, 64), True, None),
    ("d64_sq_gt_sk", (1, 2, 300, 64), (1, 2, 130, 64), True, 50),
    ("d16_smoke", (2, 4, 40, 16), (2, 4, 40, 16), True, None),
    ("d32_window", (1, 4, 70, 32), (1, 2, 70, 32), True, 16),
]


def tf32(x):
    """x rounded to TF32 (10 mantissa bits, to nearest, ties away from 0),
    as cvt.rna.tf32.f32: the low 13 bits of the float32 pattern are 0."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x):
    big = tf32(x)
    return big, tf32(x - big)


def mm3(a, b, terms):
    """a @ b as the kernel's products: three TF32 products (or one)."""
    ab, as_ = split(a)
    bb, bs = split(b)
    if terms == 1:
        return ab @ bb
    return as_ @ bb + ab @ bs + ab @ bb


def model_forward(q, k, v, *, causal, window, terms=3, block_q=128, block_k=128):
    """(o, lse) as the float32 tensor-core forward computes them."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    tile = 32 if d == 128 else 64
    scale2 = d ** -0.5 * LOG2E
    bq, bk = min(block_q, sq), min(block_k, sk)
    pad = -(-sk // tile) * tile + tile
    kf = torch.nn.functional.pad(k, (0, 0, 0, pad - sk))
    vf = torch.nn.functional.pad(v, (0, 0, 0, pad - sk))
    kf, vf = (x.repeat_interleave(hq // hkv, dim=1) for x in (kf, vf))
    o = torch.zeros(b, hq, sq, d)
    lse = torch.zeros(b, hq, sq)
    for r0 in range(0, sq, bq):
        n = min(bq, sq - r0)
        qb = q[:, :, r0:r0 + n]
        qpos = torch.arange(r0, r0 + n)[:, None] + sk - sq
        lo, hi = _live_slots(r0, sq, sk, causal, window, bq, bk)
        m = torch.full((b, hq, n), NEG)
        l = torch.zeros(b, hq, n)
        acc = torch.zeros(b, hq, n, d)
        for k0 in range(lo, hi, tile):
            kpos = torch.arange(k0, k0 + tile)[None, :]
            s = mm3(qb, kf[:, :, k0:k0 + tile].transpose(-1, -2), terms)
            slot = (kpos >= lo) & (kpos < hi)
            x = torch.where(_valid(qpos, kpos, sk, causal, window),
                            s * scale2, torch.tensor(NEG))
            x = torch.where(slot, x, torch.tensor(-math.inf))
            mc = x.amax(-1)
            move = mc > m + 8
            corr = torch.where(move, torch.exp2(m - mc), torch.ones_like(m))
            m = torch.where(move, mc, m)
            p = torch.exp2(x - m[..., None])
            l = corr * l + p.sum(-1)
            acc = acc * corr[..., None] + mm3(p, vf[:, :, k0:k0 + tile], terms)
        denom = torch.where(l == 0, torch.ones_like(l), l)
        o[:, :, r0:r0 + n] = acc / denom[..., None]
        lse[:, :, r0:r0 + n] = torch.where(m == NEG, m, m * LN2) + torch.log(denom)
    return o, lse


def _inputs(qs, ks, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=s_).astype(np.float32)) for s_ in (qs, ks, ks)]


def _worst(got, want, scale):
    """The largest error as a fraction of the float32 bar."""
    err = (got - want).abs()
    return float((err / (1e-5 * scale + 1e-5 * want.abs())).max())


def _ids(case):
    return case[0]


def test_tf32_rounding_model():
    x = torch.tensor([1 + 2 ** -11, 1 + 2 ** -12, -(1 + 2 ** -11), 1 + 3 * 2 ** -11,
                      3.0, 0.0, -0.0])
    want = torch.tensor([1 + 2 ** -10, 1.0, -(1 + 2 ** -10), 1 + 2 * 2 ** -10,
                         3.0, 0.0, -0.0])
    got = tf32(x)
    assert torch.equal(got, want)
    assert torch.equal(got.view(torch.int32) & 0x1FFF, torch.zeros(7, dtype=torch.int32))
    y = torch.from_numpy(np.random.default_rng(3).normal(size=4096).astype(np.float32))
    big, small = split(y)
    assert float(((y - big - small).abs() / y.abs()).max()) <= 2.0 ** -22
    assert float(((y - big).abs() / y.abs()).max()) <= 2.0 ** -11


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_three_products_hold_the_float32_bar(case):
    name, qs, ks, causal, window = case
    q, k, v = _inputs(qs, ks, 30)
    o, lse = model_forward(q, k, v, causal=causal, window=window)
    po, plse = tflash.flash_attention_plain(q, k, v, causal=causal, window=window)
    assert bool(torch.isfinite(o).all())
    assert _worst(o, po, 2.0) <= 1.0, f"{name} o"
    assert _worst(lse, plse, 1.0) <= 1.0, f"{name} lse"


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_one_product_misses_the_float32_bar(case):
    name, qs, ks, causal, window = case
    q, k, v = _inputs(qs, ks, 30)
    o, lse = model_forward(q, k, v, causal=causal, window=window, terms=1)
    po, plse = tflash.flash_attention_plain(q, k, v, causal=causal, window=window)
    assert max(_worst(o, po, 2.0), _worst(lse, plse, 1.0)) > 1.0, name


def vt_slot_key(c):
    """The key held by slot c of the pre-pass's Vᵀ (tf32_planes_vt)."""
    t = c & 7
    return (c & ~7) | (2 * t if t < 4 else 2 * t - 7)


def a_from_accumulator(s_tile):
    """The A operand of O += P V (64 rows × keys, in the order of Vᵀ's
    slots) as the kernel's registers hold it: thread (warp w, lane) keeps
    accumulator register i at row 16w + lane/4 + 8·((i >> 1) & 1), key
    8·(i >> 2) + 2·(lane % 4) + (i & 1); p_frag hands registers
    (4kk, 4kk + 2, 4kk + 1, 4kk + 3) to fragment slots a0..a3 of k step
    kk, which wgmma reads at (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)."""
    rows, keys = s_tile.shape
    a = torch.full_like(s_tile, float("nan"))
    for w in range(rows // 16):
        for lane in range(32):
            g, t = lane // 4, lane % 4
            reg = {}
            for i in range(keys // 2):
                reg[i] = s_tile[16 * w + g + 8 * ((i >> 1) & 1),
                                8 * (i >> 2) + 2 * t + (i & 1)]
            for kk in range(keys // 8):
                frag = (reg[4 * kk], reg[4 * kk + 2], reg[4 * kk + 1], reg[4 * kk + 3])
                at = ((g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4))
                for val, (r, c) in zip(frag, at):
                    a[16 * w + r, 8 * kk + c] = val
    return a


@pytest.mark.parametrize("keys,d", [(64, 64), (64, 16), (32, 128)])
def test_permuted_pv_equals_unpermuted(keys, d):
    rng = np.random.default_rng(keys + d)
    # small integers: every sum exact, so the two orders agree bit for bit
    p = torch.from_numpy(rng.integers(-8, 9, size=(64, keys)).astype(np.float32))
    v = torch.from_numpy(rng.integers(-8, 9, size=(keys, d)).astype(np.float32))
    slots = torch.tensor([vt_slot_key(c) for c in range(keys)])
    assert torch.equal(torch.sort(slots).values, torch.arange(keys))
    vt = v[slots].T                       # (d, keys): the pre-pass's Vᵀ tile
    a = a_from_accumulator(p)
    assert not bool(a.isnan().any())      # every fragment slot filled once
    assert torch.equal(a, p[:, slots])
    assert torch.equal(a @ vt.T, p @ v)


def test_work_buffer_holds_every_plane_and_the_counter():
    """``tf32_work_floats``: two terms of q and k, of vᵀ with its keys padded
    to a multiple of 32, and 4 floats for the kernel's item counter."""
    b, hq, hkv, sq, sk, d = 2, 8, 2, 100, 70, 64
    want = 2 * (b * hq * sq * d + b * hkv * sk * d + b * hkv * d * 96) + 4
    assert tflash.tf32_work_floats(b, hq, hkv, sq, sk, d) == want
    assert tflash.tf32_work_floats(1, 1, 1, 5, 32, 16) == 2 * (80 + 512 + 512) + 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_each_type_launches_its_own_forward(monkeypatch, dtype):
    """A float32 forward launches the 3×TF32 kernel (``flash_fwd_tf32``), a
    bf16 one the bf16 kernel (``flash_fwd``): one export, counted apart,
    the bf16 flag the kernel's last integer."""
    from test_torch_no_fallback import _reach_the_launch, _stand_in

    _reach_the_launch(monkeypatch)
    used = tflash.TF32_KERNEL if dtype == torch.float32 else tflash.KERNEL
    other = tflash.KERNEL if dtype == torch.float32 else tflash.TF32_KERNEL
    _, calls = _stand_in(monkeypatch, used, 0)
    monkeypatch.setattr(other, "launches", 0)
    q = torch.empty(1, 4, 96, 64, device="meta", dtype=dtype)
    kv = torch.empty(1, 2, 80, 64, device="meta", dtype=dtype)
    o, lse = tflash.flash_attention(q, kv, kv)
    assert o.shape == q.shape and lse.shape == (1, 4, 96)
    assert used.launches == 1 and other.launches == 0
    # the float32 scratch's size goes with it, for the export to check
    assert calls[-1][6] == (0 if dtype == torch.bfloat16
                            else tflash.tf32_work_floats(1, 4, 2, 96, 80, 64))
    assert calls[-1][7:13] == (1, 4, 2, 96, 80, 64)
    assert calls[-1][-2] == int(dtype == torch.bfloat16)
