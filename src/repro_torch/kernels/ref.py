"""Plain PyTorch oracles of the kernels (port of ``repro/kernels/ref.py``):
the unfused compositions the kernels must agree with."""

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


def flash_attention_ref(q, k, v, *, causal: bool = True, window=None,
                        scale=None) -> torch.Tensor:
    """Reference multi-head attention: q, k, v are (B, H, S, D) with one head
    count (callers repeat kv heads for GQA); masked logits are -1e30 and q is
    right-aligned to k."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    sq, sk = q.shape[2], k.shape[2]
    qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = torch.where(mask, logits, torch.full((), -1e30, device=q.device))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
