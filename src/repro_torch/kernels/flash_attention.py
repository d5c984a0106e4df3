"""Flash-attention forward: blockwise online softmax (port of the forward of
``repro/kernels/flash_attention.py``).

:func:`flash_attention` returns ``(o, lse)`` like the TPU kernel's
``_fwd_call``: q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D) → o (B, Hq, Sq, D) in
q's dtype and lse (B, Hq, Sq) in f32, queries right-aligned to the keys,
causal and sliding-window masks, GQA with group Hq // Hkv.

On a CUDA tensor it launches ``csrc/flash_fwd.cu`` (float32, D in 16, 32,
64 or 128); on a CPU tensor it runs :func:`flash_attention_plain`, the same
blockwise algorithm in PyTorch ops. Both evaluate the TPU kernel's blocks of
(min(block_q, Sq), min(block_k, Sk)) with its liveness rule and its -1e30
masking, so even the rows no key reaches (causal with Sq > Sk) come out as
the TPU kernel's do: V averaged over the slots of the live blocks, and
lse = -1e30 + log(count).

The backward (the TPU kernel's ``_bwd_call``) waits for the LM-training
slice; nothing here is differentiable.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import _device

from . import _build

DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128
TILE_Q = 64                        # query rows per CTA (csrc/flash_fwd.cu: BQ)
KERNEL_HEAD_DIMS = (16, 32, 64, 128)
_NEG_INF = -1e30

_P, _I = _build.PTR, _build.INT
KERNEL = _build.Kernel("flash_fwd", {
    "flash_fwd": [_P] * 5 + [_I] * 8 + [_build.FLOAT] + [_I] * 2 + [_P],
})


def _shapes(q, k, v, window):
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention takes q (B,Hq,Sq,D) and k, v "
                         f"(B,Hkv,Sk,D); got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, hq, sq, d = q.shape
    bk, hkv, sk, dk = k.shape
    if bk != b or dk != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree "
                         "on batch or head dim")
    if hq % hkv:
        raise ValueError(f"Hq={hq} not a multiple of Hkv={hkv}")
    if min(b, hq, sq, sk, d) == 0:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, k {tuple(k.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    return b, hq, hkv, sq, sk, d


def flash_attention_plain(q, k, v, *, causal: bool = True, window=None,
                          scale=None, block_q: int = DEFAULT_BLOCK_Q,
                          block_k: int = DEFAULT_BLOCK_K):
    """The plain PyTorch version: the TPU kernel's grid as loops over k
    blocks, all q blocks at once, a (q block, k block) pair applied only
    where it is live. Returns ``(o, lse)``."""
    b, hq, hkv, sq, sk, d = _shapes(q, k, v, window)
    g = hq // hkv
    scale = d ** -0.5 if scale is None else float(scale)
    bq, bk = min(block_q, sq), min(block_k, sk)
    nq, nk = -(-sq // bq), -(-sk // bk)
    dev = q.device
    qf = F.pad(q.float(), (0, 0, 0, nq * bq - sq)).reshape(b, hq, nq, bq, d)
    # the ragged k/v tail is zero, so padding never turns into NaN
    kf = F.pad(k.float(), (0, 0, 0, nk * bk - sk)).repeat_interleave(g, dim=1)
    vf = F.pad(v.float(), (0, 0, 0, nk * bk - sk)).repeat_interleave(g, dim=1)
    q_start = [i * bq + (sk - sq) for i in range(nq)]
    qpos = (torch.tensor(q_start, device=dev)[:, None]
            + torch.arange(bq, device=dev))[..., None]          # (nq, bq, 1)
    neg = torch.full((), _NEG_INF, device=dev)

    m = torch.full((b, hq, nq, bq), _NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hq, nq, bq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hq, nq, bq, d), dtype=torch.float32, device=dev)
    for ik in range(nk):
        ks = ik * bk
        live = [(not causal or ks <= qs + bq - 1)
                and (window is None or ks + bk - 1 > qs - window)
                for qs in q_start]
        if not any(live):
            continue
        kb = kf[:, :, ks:ks + bk]
        vb = vf[:, :, ks:ks + bk]
        s = torch.einsum("bhnqd,bhkd->bhnqk", qf, kb) * scale
        kpos = ks + torch.arange(bk, device=dev)
        mask = (kpos < sk) & (qpos < sk)
        if causal:
            mask = mask & (kpos <= qpos)
        if window is not None:
            mask = mask & (kpos > qpos - window)
        s = torch.where(mask, s, neg)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l_new = corr * l + p.sum(dim=-1)
        acc_new = acc * corr[..., None] + torch.einsum("bhnqk,bhkd->bhnqd", p, vb)
        lv = torch.tensor(live, device=dev)[:, None]             # (nq, 1)
        m = torch.where(lv, m_new, m)
        l = torch.where(lv, l_new, l)
        acc = torch.where(lv[..., None], acc_new, acc)
    denom = torch.where(l == 0, torch.ones_like(l), l)
    o = (acc / denom[..., None]).reshape(b, hq, nq * bq, d)[:, :, :sq]
    lse = (m + torch.log(denom)).reshape(b, hq, nq * bq)[:, :, :sq]
    return o.to(q.dtype), lse


def flash_attention(q, k, v, *, causal: bool = True, window=None, scale=None,
                    block_q: int = DEFAULT_BLOCK_Q,
                    block_k: int = DEFAULT_BLOCK_K):
    """Blockwise attention forward, ``(o, lse)``. q (B,Hq,Sq,D); k, v
    (B,Hkv,Sk,D). The CUDA kernel for a CUDA tensor, the plain version for
    a CPU tensor; ``block_q``/``block_k`` are the TPU kernel's blocks, whose
    liveness both follow."""
    b, hq, hkv, sq, sk, d = _shapes(q, k, v, window)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale, block_q=block_q,
                                     block_k=block_k)
    _device.require_cuda(q, "flash_attention")
    if any(t.dtype != torch.float32 for t in (q, k, v)):
        raise ValueError(f"the flash kernel takes float32, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if any(t.device != q.device or not t.is_contiguous() for t in (q, k, v)):
        raise ValueError("the flash kernel takes contiguous q, k, v on one device")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the flash kernel takes head dims {KERNEL_HEAD_DIMS}, "
                         f"got {d}")
    bq, bk = min(block_q, sq), min(block_k, sk)
    if bq % TILE_Q and bq != sq:
        raise ValueError(f"block_q {block_q} must be a multiple of {TILE_Q} "
                         "(a CTA's rows lie in one block)")
    scale = d ** -0.5 if scale is None else float(scale)
    o = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    KERNEL.launch("flash_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  o.data_ptr(), lse.data_ptr(), b, hq, hkv, sq, sk, d,
                  int(bool(causal)), 0 if window is None else int(window),
                  scale, bq, bk, _build.stream_handle(q))
    return o, lse
