"""Flash attention, forward and backward: blockwise online softmax (port of
``repro/kernels/flash_attention.py``).

:func:`flash_attention` returns ``(o, lse)`` like the TPU kernel's
``_fwd_call``: q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D) → o (B, Hq, Sq, D) in
q's dtype and lse (B, Hq, Sq) in f32, queries right-aligned to the keys,
causal and sliding-window masks, GQA with group Hq // Hkv.

On a CUDA tensor it launches ``csrc/flash_fwd.cu`` (D a multiple of 8
from 8 to 128, :data:`KERNEL_HEAD_DIMS`; the kernels instantiated at the
next of 16, 32, 64 and 128 up run on it, ``flash::padded_width``, reading
the columns past D as 0): tensor-core kernels (``wgmma`` fed by TMA),
bf16 products for bf16 and three TF32 products per product for float32
(its operands' two tf32 terms in a scratch buffer,
:func:`tf32_work_floats`); on a CPU tensor it runs
:func:`flash_attention_plain`,
the same blockwise algorithm in PyTorch ops. Both evaluate the TPU kernel's
blocks of (min(block_q, Sq), min(block_k, Sk)) with its liveness rule and
its -1e30 masking, so even the rows no key reaches (causal with Sq > Sk)
come out as the TPU kernel's do: V averaged over the slots of the live
blocks, and lse = -1e30 + log(count).

:func:`flash_attention_bwd` is ``_bwd_call``: (dq, dk, dv) from the saved
(q, k, v, o, lse) and dO, with delta = rowsum(dO ∘ O) in float32. On a CUDA
tensor it launches the two kernels of ``csrc/flash_bwd.cu``
(``flash_bwd_dq`` and ``flash_bwd_dkv``, both on the tensor cores: bf16
products for bf16, three TF32 products per product for float32 with its
operands' two tf32 terms in a scratch buffer, :func:`tf32_bwd_work_floats`);
on a CPU tensor it runs :func:`flash_attention_bwd_plain`. A dead block's
mask is all false, so the backward does not depend on the blocks: the
plain version walks the TPU's blocks, the kernels their own tiles.

dQ is taken against the keys less k̄, each kv head's mean key (in float32):
dQ = scale · Σ dS (K − k̄), which is the TPU kernel's scale · Σ dS K in
exact arithmetic because each row of dS sums to 0. In floating point that
sum is 0 only up to the rounding of lse, delta and the products, and where
the keys share most of their value (whisper's cross-attention over the
encoder states of silent audio) Σ dS K turns that rounding times k̄ into
most of dQ. The kernel and the plain version both take the difference
(:func:`bwd_work_floats` sizes the kernel's k̄).

:class:`FlashAttention` is ``_flash``'s custom VJP as a
``torch.autograd.Function`` and :func:`flash` its entry point: o only,
differentiable in q, k and v.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import _device
from repro_torch.roofline import costs as _costs

from . import _build

DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128
TILE_Q = 64                        # query rows that share one liveness (csrc/flash_fwd.cu)
# the kernels' head dims: multiples of 8 (TMA's 16-byte strides in bf16)
# up to 128, each run by the instantiation of the next of 16, 32, 64, 128 up
KERNEL_HEAD_DIMS = range(8, 129, 8)
HEAD_DIMS_TEXT = "a multiple of 8 from 8 to 128"
_NEG_INF = -1e30

KERNEL_DTYPES = (torch.float32, torch.bfloat16)

_P, _I, _F = _build.PTR, _build.INT, _build.FLOAT
_FWD_ARGS = [_P] * 6 + [_build.LONG] + [_I] * 8 + [_F] + [_I] * 3 + [_P]
KERNEL = _build.Kernel("flash_fwd", {"flash_fwd": _FWD_ARGS})
# the float32 forward: the same export and source, counted apart
TF32_KERNEL = _build.Kernel("flash_fwd_tf32", {"flash_fwd": _FWD_ARGS},
                            source="flash_fwd")
# the backward's two kernels share csrc/flash_bwd.cu and count apart, each
# in bf16 and in float32 (3×TF32: the same export, counted under its own name)
_DQ_ARGS = [_P] * 8 + [_build.LONG] + [_I] * 8 + [_F, _I, _P]
_DKV_ARGS = [_P] * 9 + [_build.LONG] + [_I] * 8 + [_F, _I, _P]
DQ_KERNEL = _build.Kernel("flash_bwd_dq", {"flash_bwd_dq": _DQ_ARGS},
                          source="flash_bwd")
DKV_KERNEL = _build.Kernel("flash_bwd_dkv", {"flash_bwd_dkv": _DKV_ARGS},
                           source="flash_bwd")
DQ_TF32_KERNEL = _build.Kernel("flash_bwd_dq_tf32", {"flash_bwd_dq": _DQ_ARGS},
                               source="flash_bwd")
DKV_TF32_KERNEL = _build.Kernel("flash_bwd_dkv_tf32",
                                {"flash_bwd_dkv": _DKV_ARGS}, source="flash_bwd")


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


def tf32_work_floats(b: int, hq: int, hkv: int, sq: int, sk: int, d: int) -> int:
    """Floats of the float32 forward's scratch: the two tf32 terms of q and
    k, of vᵀ with its keys padded to a multiple of 32, and the kernel's item
    counter. ``csrc/flash_fwd.cu`` owns the layout (``tc::Tf32Work``): the
    export takes the buffer's size and refuses one that is too small."""
    skp = -(-sk // 32) * 32
    return 2 * (b * hq * sq * d + b * hkv * sk * d + b * hkv * d * skp) + 4


def tf32_bwd_work_floats(b: int, hq: int, hkv: int, sq: int, sk: int, d: int,
                         dkv: bool) -> int:
    """Floats of a float32 backward kernel's scratch: the two tf32 terms of
    the operands its pre-pass writes, as they are and transposed (rows
    padded to a multiple of 32): dQ's k, v and (k − k̄)ᵀ (it splits q and dO in
    shared memory) or, with ``dkv``, dK/dV's q, dO, qᵀ, dOᵀ, k and v.
    ``csrc/flash_bwd.cu`` owns the layout (``tc::Tf32BwdWork``): the exports
    take the buffer's size and refuse one that is too small."""
    sqp, skp = -(-sq // 32) * 32, -(-sk // 32) * 32
    if dkv:
        return 4 * (b * hq * sq * d + b * hq * d * sqp + b * hkv * sk * d)
    return 4 * b * hkv * sk * d + 2 * b * hkv * d * skp


def bwd_work_floats(b: int, hq: int, hkv: int, sq: int, sk: int, d: int, *,
                    dkv: bool, bf16: bool) -> int:
    """Floats of a backward kernel's scratch: dQ's k̄ (b · hkv · d floats,
    the mean key its product takes the keys' differences from) in both
    types, then in float32 the pre-pass's planes
    (:func:`tf32_bwd_work_floats`); bf16 dK/dV takes none.
    ``csrc/flash_bwd.cu`` owns the layout (``tc::Tf32BwdWork::needed``) and
    refuses a smaller buffer."""
    planes = 0 if bf16 else tf32_bwd_work_floats(b, hq, hkv, sq, sk, d, dkv=dkv)
    return planes if dkv else b * hkv * d + planes


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
    _check_kernel_operands("flash_attention", d, q, k, v)
    bq, bk = min(block_q, sq), min(block_k, sk)
    if bq % TILE_Q and bq != sq:
        raise ValueError(f"block_q {block_q} must be a multiple of {TILE_Q} "
                         "(each 64-row tile of the kernels lies in one block)")
    scale = d ** -0.5 if scale is None else float(scale)
    o = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    bf16 = q.dtype == torch.bfloat16
    work = None if bf16 else torch.empty(
        tf32_work_floats(b, hq, hkv, sq, sk, d), dtype=torch.float32,
        device=q.device)
    kernel = KERNEL if bf16 else TF32_KERNEL
    if _costs.active() and _costs.declare(
            kernel, q, *_costs.flash_fwd(q, k, causal, window), matmul=True):
        return o, lse
    kernel.launch(
        "flash_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), _build.ptr(work), 0 if bf16 else work.numel(), b, hq,
        hkv, sq, sk, d, int(bool(causal)), 0 if window is None else int(window),
        scale, bq, bk, int(bf16), _build.stream_handle(q))
    return o, lse


def _check_kernel_operands(what, d, *ts):
    """The kernels' contract: one dtype (float32 or bf16), one device,
    contiguous, 16-byte aligned, head dim in :data:`KERNEL_HEAD_DIMS`."""
    if ts[0].dtype not in KERNEL_DTYPES or any(t.dtype != ts[0].dtype for t in ts):
        raise ValueError(f"{what}: the flash kernels take float32 or bfloat16 "
                         f"operands of one dtype, got {[t.dtype for t in ts]}")
    if any(t.device != ts[0].device or not t.is_contiguous()
           or t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{what}: the flash kernels take contiguous, 16-byte "
                         "aligned operands on one device")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{what}: the flash kernels take head dims "
                         f"{HEAD_DIMS_TEXT}, got {d}")


# --------------------------------------------------------------- backward
def _check_bwd(q, k, v, o, lse, do, window):
    dims = _shapes(q, k, v, window)
    b, hq, _, sq, _, _ = dims
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (b, hq, sq):
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)}, do "
                         f"{tuple(do.shape)} and lse {tuple(lse.shape)} must "
                         f"match q {tuple(q.shape)}")
    return dims


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool = True,
                              window=None, scale=None,
                              block_q: int = DEFAULT_BLOCK_Q,
                              block_k: int = DEFAULT_BLOCK_K):
    """The plain PyTorch version of ``_bwd_call``: the TPU backward's grid as
    loops over k blocks, all q blocks at once, a (q block, k block) pair
    applied only where it is live, its ``_block_mask`` (ragged q rows are
    ``qpos >= sk``), ragged q/do/k/v rows zeroed before any contraction and
    delta = rowsum(dO ∘ O) in float32; dq sums dS (K − k̄), k̄ the mean of
    each kv head's keys, as the kernels do. The GQA group's dK/dV are
    summed after the loop. Returns ``(dq, dk, dv)`` in the input dtypes."""
    b, hq, hkv, sq, sk, d = _check_bwd(q, k, v, o, lse, do, window)
    g = hq // hkv
    scale = d ** -0.5 if scale is None else float(scale)
    bq, bk = min(block_q, sq), min(block_k, sk)
    nq, nk = -(-sq // bq), -(-sk // bk)
    dev = q.device
    kbar = k.float().mean(dim=2, keepdim=True).repeat_interleave(g, dim=1)
    delta = (do.float() * o.float()).sum(-1)

    def rows(x):  # (b, h, s, ...) -> padded q blocks (b, h, nq, bq, ...)
        pad = (0, 0) * (x.ndim - 3) + (0, nq * bq - sq)
        return F.pad(x, pad).reshape(b, hq, nq, bq, *x.shape[3:])

    qf, dof = rows(q.float()), rows(do.float())
    lsef, deltaf = rows(lse.float()), rows(delta)
    kf = F.pad(k.float(), (0, 0, 0, nk * bk - sk)).repeat_interleave(g, dim=1)
    vf = F.pad(v.float(), (0, 0, 0, nk * bk - sk)).repeat_interleave(g, dim=1)
    q_start = [i * bq + (sk - sq) for i in range(nq)]
    qpos = (torch.tensor(q_start, device=dev)[:, None]
            + torch.arange(bq, device=dev))[..., None]          # (nq, bq, 1)

    dq = torch.zeros((b, hq, nq, bq, d), dtype=torch.float32, device=dev)
    dk = torch.zeros((b, hq, nk * bk, d), dtype=torch.float32, device=dev)
    dv = torch.zeros((b, hq, nk * bk, d), dtype=torch.float32, device=dev)
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
        mask = mask & torch.tensor(live, device=dev)[:, None, None]
        # select, not multiply: a row no key reaches has lse = -1e30 + log(n)
        p = torch.where(mask, torch.exp(s - lsef[..., None]), 0.0)
        dp = torch.einsum("bhnqd,bhkd->bhnqk", dof, vb)
        ds = torch.where(mask, p * (dp - deltaf[..., None]), 0.0)
        dq += torch.einsum("bhnqk,bhkd->bhnqd", ds, kb - kbar)
        dk[:, :, ks:ks + bk] += torch.einsum("bhnqk,bhnqd->bhkd", ds, qf)
        dv[:, :, ks:ks + bk] += torch.einsum("bhnqk,bhnqd->bhkd", p, dof)
    dq = (dq * scale).reshape(b, hq, nq * bq, d)[:, :, :sq]
    dk = (dk * scale).reshape(b, hkv, g, nk * bk, d).sum(2)[:, :, :sk]
    dv = dv.reshape(b, hkv, g, nk * bk, d).sum(2)[:, :, :sk]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window=None, scale=None,
                        block_q: int = DEFAULT_BLOCK_Q,
                        block_k: int = DEFAULT_BLOCK_K):
    """Flash-attention backward, ``(dq, dk, dv)`` in the input dtypes. The two
    CUDA kernels for CUDA tensors, the plain version for CPU tensors.
    ``block_q``/``block_k`` are the TPU blocks the plain version walks; the
    result does not depend on them."""
    _check_bwd(q, k, v, o, lse, do, window)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                         window=window, scale=scale,
                                         block_q=block_q, block_k=block_k)
    # delta = rowsum(dO ∘ O): one elementwise pass, as jnp outside Pallas
    delta = (do.float() * o.float()).sum(-1)
    opts = dict(causal=causal, window=window, scale=scale)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, **opts)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, **opts)
    return dq, dk, dv


def _bwd_args(what, q, k, v, do, lse, delta, causal, window, scale):
    """Checks and the trailing launch arguments shared by the two kernels."""
    b, hq, hkv, sq, sk, d = _shapes(q, k, v, window)
    _device.require_cuda(q, what)
    _check_kernel_operands(what, d, q, k, v, do)
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.dtype != torch.float32 or t.device != q.device
                or not t.is_contiguous() or t.shape != (b, hq, sq)):
            raise ValueError(f"{what}: {name} must be contiguous float32 "
                             f"{(b, hq, sq)} on q's device")
    scale = d ** -0.5 if scale is None else float(scale)
    return (b, hq, hkv, sq, sk, d, int(bool(causal)),
            0 if window is None else int(window), scale,
            int(q.dtype == torch.bfloat16), _build.stream_handle(q))


def _bwd_work(q, args, dkv):
    """A kernel's scratch (:func:`bwd_work_floats`; None for bf16 dK/dV)
    and its size."""
    n = bwd_work_floats(*args[:6], dkv=dkv, bf16=q.dtype == torch.bfloat16)
    if n == 0:
        return None, 0
    return torch.empty(n, dtype=torch.float32, device=q.device), n


def flash_bwd_dq(q, k, v, do, lse, delta, *, causal: bool = True,
                 window=None, scale=None):
    """dq by the ``flash_bwd_dq`` kernel (``_dq_kernel``), CUDA tensors only:
    delta = rowsum(dO ∘ O) is given. float32 runs the 3×TF32 kernel
    (counted as ``flash_bwd_dq_tf32``), bf16 the bf16 one."""
    args = _bwd_args("flash_bwd_dq", q, k, v, do, lse, delta, causal, window,
                     scale)
    dq = torch.empty_like(q)
    work, n = _bwd_work(q, args, dkv=False)
    kernel = DQ_KERNEL if q.dtype == torch.bfloat16 else DQ_TF32_KERNEL
    if _costs.active() and _costs.declare(
            kernel, q, *_costs.flash_bwd_dq(q, k, causal, window), matmul=True):
        return dq
    kernel.launch(
        "flash_bwd_dq", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        _build.ptr(work), n, *args)
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool = True,
                  window=None, scale=None):
    """(dk, dv) by the ``flash_bwd_dkv`` kernel (``_dkv_kernel``), CUDA
    tensors only: delta = rowsum(dO ∘ O) is given. float32 runs the 3×TF32
    kernel (counted as ``flash_bwd_dkv_tf32``), bf16 the bf16 one."""
    args = _bwd_args("flash_bwd_dkv", q, k, v, do, lse, delta, causal, window,
                     scale)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    work, n = _bwd_work(q, args, dkv=True)
    kernel = DKV_KERNEL if q.dtype == torch.bfloat16 else DKV_TF32_KERNEL
    if _costs.active() and _costs.declare(
            kernel, q, *_costs.flash_bwd_dkv(q, k, causal, window), matmul=True):
        return dk, dv
    kernel.launch(
        "flash_bwd_dkv", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), _build.ptr(work), n, *args)
    return dk, dv


# ----------------------------------------------------------- custom VJP
class FlashAttention(torch.autograd.Function):
    """``_flash`` with its custom VJP: the forward saves (q, k, v, o, lse)
    and the backward runs :func:`flash_attention_bwd` on them."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, block_q, block_k):
        o, lse = flash_attention(q, k, v, causal=causal, window=window,
                                 scale=scale, block_q=block_q, block_k=block_k)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = dict(causal=causal, window=window, scale=scale,
                        block_q=block_q, block_k=block_k)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         **ctx.opts)
        return dq, dk, dv, None, None, None, None, None


def flash(q, k, v, *, causal: bool = True, window=None, scale=None,
          block_q: int = DEFAULT_BLOCK_Q, block_k: int = DEFAULT_BLOCK_K):
    """Blockwise attention, differentiable: o (B,Hq,Sq,D) from q (B,Hq,Sq,D)
    and k, v (B,Hkv,Sk,D) (the JAX package's ``flash_attention``)."""
    return FlashAttention.apply(q, k, v, causal, window, scale, int(block_q),
                                int(block_k))
