"""Plain PyTorch oracles of the projection kernels (port of
``repro/kernels/ref.py``, projection part): the unfused compositions the
kernels must agree with."""

from __future__ import annotations

import torch

from repro_torch.core import ball, multilevel


def colmax_ref(y: torch.Tensor) -> torch.Tensor:
    return y.abs().amax(dim=0)


def clip_ref(y: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    u = u[None, :].to(y.dtype)
    return torch.minimum(torch.maximum(y, -u), u)


def project_l1_ref(v: torch.Tensor, radius, method: str = "bisect") -> torch.Tensor:
    return ball.project_l1(v, radius, method=ball.resolve_method(method))


def bilevel_l1inf_ref(y: torch.Tensor, radius, method: str = "bisect") -> torch.Tensor:
    return clip_ref(y, project_l1_ref(colmax_ref(y), radius, method=method))


def trilevel_l1infinf_ref(y: torch.Tensor, radius,
                          method: str = "bisect") -> torch.Tensor:
    """Tri-level ℓ1,∞,∞ oracle — the unfused schedule executor."""
    return multilevel.trilevel_l1infinf(y, radius, method=method)
