"""Entry points on tensors (port of ``repro/kernels/ops.py``): the
projections and attention.

The tensor's device decides the path: for a projection, a CUDA tensor runs
the generated kernels (``kernels/codegen``), a CPU tensor a cached planner
plan of the plain PyTorch schedule executor; for attention, a CUDA tensor
runs the flash kernels (``kernels/flash_attention``: the forward, and the
dQ and dK/dV kernels in the backward), a CPU tensor their plain versions.
No environment variable or flag switches the kernels off (the JAX
package's ``REPRO_FORCE_INTERPRET``/``use_pallas`` have no counterpart).
"""

from __future__ import annotations

import torch

from repro_torch.core import plan as planmod

from .codegen import codegen_project
from .flash_attention import flash

_BILEVEL_LEVELS = (("inf", 1), ("1", 1))
_TRILEVEL_LEVELS = (("inf", 1), ("inf", 1), ("1", 1))


def _projection(y: torch.Tensor, levels, radius, method: str) -> torch.Tensor:
    if y.is_cuda:
        return codegen_project(y, list(levels), radius, method=method)
    p = planmod.make_plan(y.shape, y.dtype, list(levels), method=method,
                          device=y.device.type)
    return p(y, radius)


def bilevel_l1inf(y: torch.Tensor, radius, *,
                  method: str = "bisect") -> torch.Tensor:
    """Bi-level ℓ1,∞ projection of a 2-D tensor: the generated kernels on
    the card, the plain schedule on the CPU. ``method`` is the outer ℓ1
    solve ("bisect" | "filter" on the card)."""
    return _projection(y, _BILEVEL_LEVELS, radius, method)


def trilevel_l1infinf(y: torch.Tensor, radius, *,
                      method: str = "bisect") -> torch.Tensor:
    """Tri-level ℓ1,∞,∞ projection — same contract as ``bilevel_l1inf``."""
    if y.ndim != 3:
        raise ValueError("trilevel_l1infinf expects an order-3 tensor")
    return _projection(y, _TRILEVEL_LEVELS, radius, method)


def attention(q, k, v, *, causal: bool = True, window=None) -> torch.Tensor:
    """Flash attention, o only, differentiable in q, k and v: q (B,Hq,Sq,D),
    k/v (B,Hkv,Sk,D)."""
    return flash(q, k, v, causal=causal, window=window)
