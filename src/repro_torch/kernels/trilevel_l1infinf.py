"""The tri-level ℓ1,∞,∞ projection (paper Algorithm 5) as hand-written
kernels (port of ``repro/kernels/trilevel_l1infinf.py``).

GOLDEN REFERENCE, as in the JAX package: the planner serves the generated
pipeline (``kernels/codegen``); these kernels pin it. ``TP^{1,∞,∞}_η(Y)`` for
Y ∈ R^{c,n,m} is

    pass 1  reduce:  v2[i,j] = max_c |Y[c,i,j]|  and  v1[j] = max_i v2[i,j]
                     in ONE pass over Y             (csrc/trilevel_l1infinf.cu)
    (tiny)  outer :  u1 = P¹_η(v1)                  (kernels.l1ball.outer_l1_solve)
    pass 2  apply :  X = clip(Y, ±min(v2, u1))      (csrc/trilevel_l1infinf.cu)

:func:`trilevel_reduce` and :func:`trilevel_apply` launch their kernels on a
CUDA tensor (float32 or bf16, outputs in Y's type) and run their ``_plain``
versions on a CPU tensor, nothing else. The launch shape is the wrappers'
(:func:`reduce_shape`: whole column strips per CTA, one launch;
``bilevel_l1inf.stream_shape`` for the apply), not the TPU's
``block_n``/``block_m``.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import torch

from repro_torch.roofline import costs as _costs

from . import _build, l1ball
from .bilevel_l1inf import SM_COUNT, check_operands, stream_shape, vector_width

REDUCE_THREADS = 512   # threads per reduce CTA (csrc/trilevel_l1infinf.cu)
REDUCE_CTAS = SM_COUNT  # reduce CTAs resident at once: one per SM
REDUCE_SEGMENT = 512   # bytes of a row one strip's warp load covers at most
REDUCE_CLUSTER_MAX = 8  # CTAs per strip: the portable cluster size
WARP = 32

_P, _I = _build.PTR, _build.INT
REDUCE = _build.Kernel("trilevel_reduce", {
    "golden_trilevel_reduce": [_P] * 3 + [_I] * 8 + [_P],
}, source="trilevel_l1infinf")
APPLY = _build.Kernel("trilevel_apply", {
    "golden_trilevel_apply": [_P] * 4 + [_I] * 6 + [_P],
}, source="trilevel_l1infinf")


@functools.lru_cache(maxsize=1024)
def reduce_shape(c: int, n: int, m: int, vec: int,
                 itemsize: int = 4) -> Tuple[int, int, int, int]:
    """``(packs, groups, cluster, ctas)`` of the one-launch reduce. A strip
    of ``packs`` packs of ``vec`` columns belongs to one thread block
    cluster of ``cluster`` CTAs (as many as fit ``REDUCE_CTAS`` with the
    strips, up to the portable 8), whose lanes split its rows and fold v1
    through distributed shared memory; ``groups`` lanes share each row's c
    slices (as many as the rows leave lanes for, the slices feed and a
    warp holds). Of the strip widths from ``REDUCE_SEGMENT`` bytes down to
    one wave of strips, the widest that best keeps both the card (CTAs over
    ``REDUCE_CTAS``) and the lanes (rows per step over lanes) busy. Cached:
    a wrapper asks for the same few shapes on every call."""
    count = math.ceil(m / vec)
    packs = min(max(1, REDUCE_SEGMENT // (vec * itemsize)),
                1 << (count - 1).bit_length())
    best, best_score = None, -1.0
    while packs >= 1:
        strips = math.ceil(count / packs)
        if best is not None and strips > REDUCE_CTAS:
            break   # narrower strips only add waves
        cluster = 1
        while cluster < REDUCE_CLUSTER_MAX and 2 * strips * cluster <= REDUCE_CTAS:
            cluster *= 2
        lanes = cluster * REDUCE_THREADS // packs
        groups = 1
        while (2 * groups <= c and 2 * groups * n <= lanes
               and 2 * groups * packs <= WARP):
            groups *= 2
        slots = lanes // groups
        busy = n / (math.ceil(n / slots) * slots)
        ctas = strips * cluster
        score = busy * min(1.0, ctas / REDUCE_CTAS)
        if score > best_score * (1 + 1e-9):
            best, best_score = (packs, groups, cluster, ctas), score
        packs //= 2
    return best


def _check_order3(what: str, y: torch.Tensor) -> None:
    if y.ndim != 3:
        raise ValueError(f"{what} expects an order-3 tensor, got "
                         f"{tuple(y.shape)}")


# --------------------------------------------------------------------------- #
# Plain versions (PyTorch ops)
# --------------------------------------------------------------------------- #


def trilevel_reduce_plain(y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(v2, v1) = (max_c |Y|, max_{c,i} |Y|) in Y's type."""
    v2 = y.abs().amax(dim=0)
    return v2, v2.amax(dim=0)


def trilevel_apply_plain(y: torch.Tensor, v2: torch.Tensor,
                         u1: torch.Tensor) -> torch.Tensor:
    """X = clip(Y, ±min(v2, u1)), u1 rounded to Y's type and the min taken
    in Y's type, as JAX's ``trilevel_apply_pallas``."""
    u2 = torch.minimum(v2, u1.to(y.dtype)[None, :])[None]
    return torch.minimum(torch.maximum(y, -u2), u2)


# --------------------------------------------------------------------------- #
# Kernel wrappers
# --------------------------------------------------------------------------- #


def trilevel_reduce(y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(v2 (n, m), v1 (m,)) of Y (c, n, m) in one streaming pass: the
    ``trilevel_reduce`` kernel on a CUDA tensor, the plain version on a CPU
    one."""
    _check_order3("trilevel_reduce", y)
    if y.is_cpu:
        return trilevel_reduce_plain(y)
    code = check_operands("trilevel_reduce", y)
    c, n, m = y.shape
    vec = vector_width(m, y)
    packs, groups, cluster, _ = reduce_shape(c, n, m, vec, y.element_size())
    v2 = y.new_empty((n, m))
    v1 = y.new_empty((m,))
    if _costs.active() and _costs.declare(
            REDUCE, y, *_costs.trilevel_reduce(y.element_size(), y.numel(),
                                               n * m, m)):
        return v2, v1
    REDUCE.launch("golden_trilevel_reduce", y.data_ptr(), v2.data_ptr(),
                  v1.data_ptr(), code, vec, c, n, m, packs, groups, cluster,
                  _build.stream_handle(y))
    return v2, v1


def trilevel_apply(y: torch.Tensor, v2: torch.Tensor,
                   u1: torch.Tensor) -> torch.Tensor:
    """X = clip(Y, ±min(v2, u1)) for Y (c, n, m), v2 (n, m), u1 (m,): the
    ``trilevel_apply`` kernel on a CUDA tensor, the plain version on a CPU
    one."""
    _check_order3("trilevel_apply", y)
    c, n, m = y.shape
    if v2.shape != (n, m) or u1.shape != (m,):
        raise ValueError(f"trilevel_apply takes v2 {(n, m)} and u1 {(m,)}, "
                         f"got {tuple(v2.shape)} and {tuple(u1.shape)}")
    if y.is_cpu:
        return trilevel_apply_plain(y, v2, u1)
    if u1.dtype != y.dtype or not u1.is_contiguous():
        u1 = u1.to(y.dtype).contiguous()  # JAX: u1.astype(y.dtype) outside the kernel
    code = check_operands("trilevel_apply", y, v2, u1)
    x = torch.empty_like(y)
    py, pv, pu, px = y.data_ptr(), v2.data_ptr(), u1.data_ptr(), x.data_ptr()
    vec, groups = stream_shape(c, n, m, y.element_size(),
                               not (py | pv | pu | px) % 16)
    if _costs.active() and _costs.declare(
            APPLY, y, *_costs.trilevel_apply(y.element_size(), y.numel(),
                                             n * m, m)):
        return x
    APPLY.launch("golden_trilevel_apply", py, pv, pu, px, code, vec, c, n, m,
                 groups, _build.stream_handle(y))
    return x


def trilevel_l1infinf_fused(y: torch.Tensor, radius, *,
                            method: str = "bisect") -> torch.Tensor:
    """Fused tri-level ℓ1,∞,∞ projection of Y (c, n, m), float32 or bf16:
    reduce → outer ℓ1 solve → apply, on Y's device and in Y's type (three
    launches on the card, as JAX's ``trilevel_l1infinf_pallas``).

    ``method`` selects the outer θ-solve: "bisect" or "filter" run the
    ``l1ball`` kernel; any other ``core.ball`` method, or m over JAX's
    single-block limit, the solver in PyTorch ops (``l1ball.outer_l1_solve``).
    """
    _check_order3("trilevel_l1infinf_fused", y)
    v2, v1 = trilevel_reduce(y)
    u1 = l1ball.outer_l1_solve(v1, radius, method=method)
    return trilevel_apply(y, v2, u1)
