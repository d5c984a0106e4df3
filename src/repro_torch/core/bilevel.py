"""Bi-level ℓp,q projections (paper §3–5, Algorithms 1–4) — port of
``repro/core/bilevel.py``.

``BP^{p,q}_η(Y)`` for Y ∈ R^{n×m} (columns of length n):

    1. aggregate:  v_q[j] = ‖Y[:, j]‖_q
    2. outer:      u = P^p_η(v_q)
    3. inner:      X[:, j] = P^q_{u[j]}(Y[:, j]) for every j

One pass, always feasible. For q = ∞ step 3 is a clip, for q = 2 a rescale,
for q = 1 a per-column soft threshold with a per-column radius.
``bilevel_project_axes`` takes any tensor and any set of aggregated axes.
"""

from __future__ import annotations

import math

import torch

from repro_torch import _device

from . import ball, multilevel


def bilevel_project(y: torch.Tensor, radius, p=1, q=math.inf,
                    method: str = "sort") -> torch.Tensor:
    """BP^{p,q}_radius(Y) for a 2-D Y, aggregating columns (axis 0).

    ``method="auto"`` is the two-level design ν = [(q, 1), (p, 1)] through
    the planner, exactly like ``multilevel_project``.
    """
    if y.ndim != 2:
        raise ValueError("bilevel_project expects a 2-D tensor")
    if method == "auto":
        return multilevel.multilevel_project(y, [(q, 1), (p, 1)], radius,
                                             method="auto")
    method = ball.resolve_method(method)
    v = ball.norm_reduce(y, q, axes=0)           # (m,) non-negative
    u = ball.project_ball(v, p, radius, method=method)
    return ball.project_grouped(y, q, u, inner_axes=(0,), method=method)


def bilevel_l1inf(y: torch.Tensor, radius, method: str = "sort") -> torch.Tensor:
    """Paper Algorithm 2: v = colwise max|·| → P¹(v) → clip."""
    return bilevel_project(y, radius, p=1, q=math.inf, method=method)


def bilevel_l11(y: torch.Tensor, radius, method: str = "sort") -> torch.Tensor:
    """Paper Algorithm 3."""
    return bilevel_project(y, radius, p=1, q=1, method=method)


def bilevel_l12(y: torch.Tensor, radius, method: str = "sort") -> torch.Tensor:
    """Paper Algorithm 4."""
    return bilevel_project(y, radius, p=1, q=2, method=method)


def bilevel_l21(y: torch.Tensor, radius, method: str = "sort") -> torch.Tensor:
    """Paper Algorithm 7."""
    return bilevel_project(y, radius, p=2, q=1, method=method)


def bilevel_project_axes(y: torch.Tensor, radius, p=1, q=math.inf, *,
                         inner_axes, method: str = "sort") -> torch.Tensor:
    """Bi-level projection of an arbitrary tensor.

    ``inner_axes`` are aggregated by the q-norm (the "column" axes); all
    other axes index the groups whose aggregate is projected onto the
    p-ball. ``method="auto"`` takes the planner's θ-solver for the
    aggregate's length on ``y``'s device (generic solvers only: the
    arbitrary-axes form has no kernel), timed under autograd on an input
    autograd records.
    """
    inner_axes = tuple(a % y.ndim for a in inner_axes)
    if method == "auto":
        from . import plan as _plan

        n_outer = math.prod(d for a, d in enumerate(y.shape)
                            if a not in inner_axes)
        method = _plan.best_l1_method(
            max(n_outer, 1), y.dtype, device=y.device.type,
            grad=_device.records_grad(y, radius))
    method = ball.resolve_method(method)
    v = ball.norm_reduce(y, q, axes=inner_axes)  # shape = outer dims
    u = ball.project_ball(v.reshape(-1), p, radius,
                          method=method).reshape(v.shape)
    return ball.project_grouped(y, q, u, inner_axes=inner_axes, method=method)
