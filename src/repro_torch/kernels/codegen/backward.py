"""Generated backward for compiled schedules: residual VJPs, no re-execution
(port of ``repro/kernels/codegen/backward.py``).

The forward of a compiled schedule is

    ReduceLevel* → OuterSolve → ApplyGroup*

and its Jacobian factors stage by stage into pieces that are *diagonal plus
rank-one per group*:

* a **reduce** VJP expands the aggregate cotangent elementwise (``sign(s)``
  for ℓ1, ``s/‖s‖`` for ℓ2, an even split over the ties at the max for ℓ∞);
* the **outer-solve** VJP is the projection Jacobian: identity inside the
  ball; outside it ``diag(1_S) − rank-one over the active set S`` (ℓ1),
  ``(r/‖v‖)(I − v̂v̂ᵀ)`` (ℓ2), a clip mask (ℓ∞), with S read off the saved
  solved output, never solved again;
* an **apply** VJP is the grouped version of the same three forms, with
  "group untouched" read from the saved forward aggregate of the same level.

The residuals are what the forward pipeline already holds: ``y``, every
stage aggregate ``s_1 … s_{L-1}``, the solved radii ``u``, the projected
output ``x`` and ``radius``. The only recomputation is the radii chain above
stage 0, on aggregate-sized tensors. Everything here is PyTorch ops on the
residuals' device, as the JAX package's backward is jnp outside its Pallas
kernels; ``schedule.execute`` is never called.

Every tensor carries a leading batch axis (the pipeline's bucket; one item
is a bucket of one): a stage's group axis is axis 1, the outer solve runs
on the last axis of each item, and the radius has one entry per item.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core import ball


def _finv(x: torch.Tensor) -> torch.Tensor:
    """1/x that is 0 at 0 (used only where a ``shrink`` mask already gates)."""
    zero = x == 0
    return torch.where(zero, 0.0, 1.0 / torch.where(zero, 1.0, x))


# --------------------------------------------------------------------------- #
# Per-stage VJPs (group axis = axis 1 of the canonical layout)
# --------------------------------------------------------------------------- #


def reduce_vjp(q: str, s: torch.Tensor, v: torch.Tensor,
               c: torch.Tensor) -> torch.Tensor:
    """Cotangent of ``s`` given cotangent ``c`` of ``v = norm_reduce(s, q,
    1)``. Elementwise in ``s`` given the saved aggregate."""
    if q == "1":
        return c.unsqueeze(1) * torch.sign(s)
    if q == "2":
        return (c * _finv(v)).unsqueeze(1) * s
    ties = s.abs() == v.unsqueeze(1)
    share = c * _finv(ties.sum(dim=1).to(s.dtype))
    return torch.where(ties, share.unsqueeze(1) * torch.sign(s), 0.0)


def apply_vjp(q: str, s: torch.Tensor, w: torch.Tensor, agg: torch.Tensor,
              out: torch.Tensor, g: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """VJP of ``out = apply_group(s, q, radii=w, axes=(1,), agg=agg)``:
    ``(ds, dw, dagg)``, ``dagg`` None unless ``q == '2'`` (the one apply
    that reads its saved aggregate)."""
    if q == "inf":
        inside = s.abs() < w.unsqueeze(1)
        ds = torch.where(inside, g, 0.0)
        dw = torch.where(inside, 0.0, g * torch.sign(s)).sum(dim=1)
        return ds, dw, None
    if q == "2":
        shrink = agg > w
        inv = _finv(torch.clamp(agg, min=1e-30))
        ds = g * torch.where(shrink, w * inv, 1.0).unsqueeze(1)
        gs = (g * s).sum(dim=1)              # cotangent of the scale
        dw = torch.where(shrink, gs * inv, 0.0)
        dagg = torch.where(shrink, -gs * w * inv * inv, 0.0)
        return ds, dw, dagg
    # ℓ1: ``agg`` is the saved group norm Σ|s|, and the active set comes off
    # the saved output
    inside = agg <= w
    act = out != 0.0
    cnt = torch.clamp(act.sum(dim=1), min=1).to(s.dtype)
    sg = torch.sign(s)
    sigma = torch.where(act, sg * g, 0.0).sum(dim=1)
    corr = (sigma / cnt).unsqueeze(1)
    ds = torch.where(inside.unsqueeze(1), g,
                     torch.where(act, g - sg * corr, 0.0))
    dw = torch.where(inside, 0.0, sigma / cnt)
    return ds, dw, None


def outer_vjp(q: str, v: torch.Tensor, u: torch.Tensor, radius: torch.Tensor,
              du: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """VJP of the OuterSolve ``u = project_ball(v, q, radius)`` on each
    item's flat aggregate (the last axis of ``v``, (B, m)). Returns ``(dv,
    dradius)``, ``dradius`` shaped like ``radius`` (B,)."""
    du = du.reshape(v.shape)
    r = radius[:, None]

    def total(t):
        return t.sum(dim=-1, keepdim=True)

    if q == "inf":
        inside = v.abs() < r
        dv = torch.where(inside, du, 0.0)
        dr = total(torch.where(inside, 0.0, du * torch.sign(v)))
    elif q == "2":
        nrm = torch.sqrt(total(v * v))
        shrink = nrm > r
        inv = _finv(torch.clamp(nrm, min=1e-30))
        vhat = v * inv
        vg = total(vhat * du)
        dv = torch.where(shrink, r * inv * (du - vhat * vg), du)
        dr = torch.where(shrink, vg, 0.0)
    else:
        inside = total(v.abs()) <= r
        act = u.reshape(v.shape) != 0.0
        cnt = torch.clamp(total(act), min=1).to(v.dtype)
        sg = torch.sign(v)
        sigma = total(torch.where(act, sg * du, 0.0))
        dv = torch.where(inside, du, torch.where(act, du - sg * sigma / cnt, 0.0))
        dr = torch.where(inside, 0.0, sigma / cnt)
    return dv, dr.reshape(radius.shape)


# --------------------------------------------------------------------------- #
# The full-schedule VJP on canonical-shape residuals
# --------------------------------------------------------------------------- #


def _apply_forward(q: str, s: torch.Tensor, w: torch.Tensor,
                   agg: torch.Tensor) -> torch.Tensor:
    """One apply step on an aggregate-sized stage (radii-chain recompute)."""
    if q == "inf":
        wb = w.unsqueeze(1)
        return torch.minimum(torch.maximum(s, -wb), wb)
    if q == "2":
        scale = torch.where(agg > w, w / torch.clamp(agg, min=1e-30), 1.0)
        return s * scale.unsqueeze(1)
    return ball.project_grouped(s, "1", w, inner_axes=(1,), method="sort")


def schedule_vjp(norms: Sequence[str], stages: Sequence[torch.Tensor],
                 u: torch.Tensor, x: torch.Tensor, radius: torch.Tensor,
                 g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The generated VJP of one compiled schedule, from residuals only.

    ``norms = [q_1 … q_L]``; ``stages = [s_0=y, s_1, …, s_{L-1}]`` in the
    batched canonical ``(B, g_1, …, g_{L-1}, m)`` layout (``s_{L-1}`` is
    each item's flat aggregate, (B, m)); ``u`` the OuterSolve output; ``x``
    the projected output and ``g`` its cotangent (canonical); ``radius``
    (B,). Returns ``(dy, dradius)``. Never calls ``schedule.execute`` or a
    θ-solver on a y-sized tensor.
    """
    L = len(norms)
    if L == 1:
        return outer_vjp(norms[0], stages[0], x, radius, g)

    # the radii chain A_i = apply output at stage i; A_0 = x is saved, the
    # rest (aggregate-sized) replays down from the solved u
    A = [None] * (L - 1)
    A[0] = x
    W = [None] * (L - 1)            # W_i = radii consumed by stage i's apply
    top = stages[L - 2].shape
    W[L - 2] = u.reshape(top[:1] + top[2:])
    for i in range(L - 2, 0, -1):
        A[i] = _apply_forward(norms[i], stages[i], W[i], stages[i + 1])
        W[i - 1] = A[i]

    c = [torch.zeros_like(s) for s in stages]   # stage cotangents
    gi = g
    for i in range(L - 1):
        ds, dw, dagg = apply_vjp(norms[i], stages[i], W[i], stages[i + 1],
                                 A[i], gi)
        c[i] = c[i] + ds
        if dagg is not None:
            c[i + 1] = c[i + 1] + dagg
        gi = dw                                  # cotangent of A_{i+1} (or u)
    dv, dr = outer_vjp(norms[-1], stages[-1], u, radius, gi)
    c[L - 1] = c[L - 1] + dv
    for t in range(L - 1, 0, -1):
        c[t - 1] = c[t - 1] + reduce_vjp(norms[t - 1], stages[t - 1],
                                         stages[t], c[t])
    return c[0], dr
