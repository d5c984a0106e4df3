"""The bi-level ℓ1,∞ projection (paper Algorithm 2) as hand-written kernels
(port of ``repro/kernels/bilevel_l1inf.py``).

GOLDEN REFERENCE, as in the JAX package: the planner serves the generated
pipeline (``kernels/codegen``); these kernels are a second, independent
implementation of the same design that pins it (``chip_smoke.py`` on the
card, ``tests/test_torch_golden.py`` on the CPU).

    pass 1  colmax:  v[j]   = max_i |Y[i, j]|      (csrc/bilevel_l1inf.cu)
    (tiny)  outer :  u      = P¹_η(v)              (kernels.l1ball.outer_l1_solve)
    pass 2  clip  :  X[i,j] = clip(Y[i,j], ±u[j])  (csrc/bilevel_l1inf.cu)

Y is read twice, the minimum for the split. :func:`colmax` and :func:`clip`
launch their kernels on a CUDA tensor (float32 or bf16, output in Y's type)
and run :func:`colmax_plain` / :func:`clip_plain` on a CPU tensor, nothing
else. The TPU ``block_n``/``block_m`` arguments are not carried over: the
wrappers pick the launch shape (:func:`colmax_shape`: whole columns per CTA,
one launch; :func:`stream_shape`: one CTA per 8 KB tile of the plane and
group of planes, for ``clip`` and the tri-level apply).
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import torch

from repro_torch import _device
from repro_torch.roofline import costs as _costs

from . import _build, l1ball

SM_COUNT = 132     # H100 SXM
STREAM_THREADS = 256        # threads per clip / apply CTA (csrc/golden.cuh)
STREAM_TILE = 2 * STREAM_THREADS  # packs of a CTA's tile (8 KB)
STREAM_CTAS = 6 * SM_COUNT  # float32 clip / apply CTAs resident at once
COLMAX_THREADS = 512        # threads per colmax CTA (csrc/bilevel_l1inf.cu)
COLMAX_CTAS = 2 * SM_COUNT  # colmax CTAs resident at once: two per SM
COLMAX_SEGMENT = 64         # bytes of each row a warp load covers at least
                            # (on an H100, 2–4 µs less than 32 at W1;
                            # PERF.md § 6)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}  # csrc/golden.cuh

_P, _I = _build.PTR, _build.INT
COLMAX = _build.Kernel("colmax", {
    "golden_colmax": [_P, _P] + [_I] * 5 + [_P],
}, source="bilevel_l1inf")
CLIP = _build.Kernel("clip", {
    "golden_clip": [_P, _P, _P] + [_I] * 4 + [_P],
}, source="bilevel_l1inf")


# --------------------------------------------------------------------------- #
# Launch shape and checks, shared with kernels/trilevel_l1infinf.py
# --------------------------------------------------------------------------- #


def vector_width(m: int, *ts: torch.Tensor) -> int:
    """Elements per 16-byte access: ``16 / itemsize`` when every row of
    width ``m`` starts 16-byte aligned in every tensor, else 1."""
    vec = 16 // ts[0].element_size()
    ok = m % vec == 0 and all(t.data_ptr() % 16 == 0 for t in ts)
    return vec if ok else 1


@functools.lru_cache(maxsize=1024)
def stream_shape(c: int, n: int, m: int, itemsize: int,
                 aligned: bool) -> Tuple[int, int]:
    """``(vec, groups)`` of the clip stream (csrc/golden.cuh:
    ``stream_clip``) over c planes of (n, m). ``vec`` elements per pack: 16
    bytes when every base pointer is 16-byte ``aligned`` (and, with c > 1,
    every plane of Y too), else one. The kernel runs one CTA per tile of
    ``STREAM_TILE`` packs of the plane and group of planes; each group
    takes as many planes (reading v2 once for them) as leave at least four
    waves of ``STREAM_CTAS`` CTAs. Cached: a wrapper asks for the same few
    shapes on every call."""
    vec = 16 // itemsize
    if not aligned or (c > 1 and n * m % vec):
        vec = 1
    tiles = math.ceil(n * m / vec / STREAM_TILE)
    per = max(1, min(c, tiles * c // (4 * STREAM_CTAS)))   # planes per group
    return vec, math.ceil(c / per)


@functools.lru_cache(maxsize=1024)
def colmax_shape(m: int, vec: int, itemsize: int = 4) -> Tuple[int, int]:
    """``(packs, ctas)`` of the one-launch ``colmax``: each CTA owns
    ``packs`` packs of ``vec`` columns and all their rows. ``packs`` starts
    at ``COLMAX_SEGMENT`` bytes of each row and doubles until the ``ctas``
    CTAs fit in one wave (``COLMAX_CTAS``), or a CTA holds as many packs as
    it has threads."""
    count = math.ceil(m / vec)
    packs = min(max(1, COLMAX_SEGMENT // (vec * itemsize)),
                1 << (count - 1).bit_length())
    while packs < COLMAX_THREADS and packs < count \
            and math.ceil(count / packs) > COLMAX_CTAS:
        packs *= 2
    return packs, math.ceil(count / packs)


def check_operands(what: str, y: torch.Tensor, *others: torch.Tensor) -> int:
    """The kernels take contiguous, non-empty float32 or bf16 tensors of one
    type on one CUDA device, none of which autograd records (the kernels
    have no backward); returns Y's code in :data:`DTYPE_CODES`.
    Devices are compared by index (``get_device``), which builds no
    ``torch.device`` on the launch path; each operand is looked at once,
    and grad mode only when one requires grad."""
    _device.require_cuda(y, what)
    code = DTYPE_CODES.get(y.dtype)
    if code is None:
        raise ValueError(f"{what} takes float32 or bfloat16, got {y.dtype}")
    if not y.is_contiguous():
        raise ValueError(f"{what} takes contiguous tensors")
    index = y.get_device()
    grad = y.requires_grad
    for t in others:
        if t.dtype != y.dtype or t.get_device() != index:
            raise ValueError(f"{what}: every operand must be {y.dtype} on "
                             f"{y.device}, got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what} takes contiguous tensors")
        grad = grad or t.requires_grad
    if grad:
        _device.refuse_grad(what, y, *others)
    if y.numel() == 0:
        raise ValueError(f"{what} takes a non-empty tensor")
    return code


# --------------------------------------------------------------------------- #
# Plain versions (PyTorch ops)
# --------------------------------------------------------------------------- #


def colmax_plain(y: torch.Tensor) -> torch.Tensor:
    """v[j] = max_i |Y[i, j]| in Y's type (NaN propagates)."""
    return y.abs().amax(dim=0)


def clip_plain(y: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """X = clip(Y, ±u) with u rounded to Y's type first, as JAX's
    ``clip_pallas`` does; ``jnp.clip``'s max-then-min order."""
    u = u.to(y.dtype)[None, :]
    return torch.minimum(torch.maximum(y, -u), u)


# --------------------------------------------------------------------------- #
# Kernel wrappers
# --------------------------------------------------------------------------- #


def colmax(y: torch.Tensor) -> torch.Tensor:
    """Per-column max|·| of a 2-D tensor: the ``colmax`` kernel on a CUDA
    tensor, :func:`colmax_plain` on a CPU one."""
    if y.ndim != 2:
        raise ValueError(f"colmax takes a 2-D tensor, got {tuple(y.shape)}")
    if y.is_cpu:
        return colmax_plain(y)
    code = check_operands("colmax", y)
    n, m = y.shape
    vec = vector_width(m, y)
    packs, _ = colmax_shape(m, vec, y.element_size())
    out = y.new_empty((m,))
    if _costs.active() and _costs.declare(
            COLMAX, y, *_costs.colmax(y.element_size(), y.numel(), m)):
        return out
    COLMAX.launch("golden_colmax", y.data_ptr(), out.data_ptr(), code, vec,
                  n, m, packs, _build.stream_handle(y))
    return out


def clip(y: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """X = clip(Y, ±u) with ``u`` (m,) a per-column radius, rounded to Y's
    type first: the ``clip`` kernel on a CUDA tensor, :func:`clip_plain` on
    a CPU one."""
    if y.ndim != 2 or u.shape != (y.shape[1],):
        raise ValueError(f"clip takes y (n, m) and u (m,), got "
                         f"{tuple(y.shape)} and {tuple(u.shape)}")
    if y.is_cpu:
        return clip_plain(y, u)
    if u.dtype != y.dtype or not u.is_contiguous():
        u = u.to(y.dtype).contiguous()  # JAX: u.astype(y.dtype) outside the kernel
    code = check_operands("clip", y, u)
    n, m = y.shape
    x = torch.empty_like(y)
    py, pu, px = y.data_ptr(), u.data_ptr(), x.data_ptr()
    vec, _ = stream_shape(1, n, m, y.element_size(), not (py | pu | px) % 16)
    if _costs.active() and _costs.declare(
            CLIP, y, *_costs.clip(y.element_size(), y.numel(), m)):
        return x
    CLIP.launch("golden_clip", py, pu, px, code, vec, n, m,
                _build.stream_handle(y))
    return x


def bilevel_l1inf_fused(y: torch.Tensor, radius, *,
                        method: str = "bisect") -> torch.Tensor:
    """Fused bi-level ℓ1,∞ projection of Y (n, m), float32 or bf16:
    colmax → outer ℓ1 solve → clip, on Y's device and in Y's type (three
    launches on the card, as JAX's ``bilevel_l1inf_pallas``).

    ``method`` selects the outer θ-solve: "bisect" or "filter" run the
    ``l1ball`` kernel; any other ``core.ball`` method, or m over JAX's
    single-block limit, the solver in PyTorch ops (``l1ball.outer_l1_solve``).
    """
    v = colmax(y)
    u = l1ball.outer_l1_solve(v, radius, method=method)
    return clip(y, u)
