"""EXACT Euclidean projection onto the ℓ1,∞ ball — the paper's baseline
(port of ``repro/core/exact_l1inf.py``, in PyTorch ops on Y's device).

The paper compares its bi-level projection against the exact projection of
Chu et al. (ICML'20, semismooth Newton on the dual):

    minimize ½‖X-Y‖²  s.t.  Σ_j max_i |X_ij| ≤ η

With A = |Y|, the solution is X_ij = sign(Y_ij)·min(A_ij, t_j), where the
column caps t_j solve, for a dual variable λ ≥ 0,

    Σ_i max(A_ij - t_j, 0) = λ     (or t_j = 0 when Σ_i A_ij ≤ λ)
    Σ_j t_j = η.

With each column sorted descending (a_1 ≥ … ≥ a_n, prefix sums S_k) and
d_k = S_k - k·a_k (non-decreasing in k), the inner solve is

    k*(λ) = max{k : d_k ≤ λ},   t(λ) = max((S_{k*} - λ)/k*, 0),

and F(λ) = Σ_j t_j(λ) - η is convex, piecewise-linear and decreasing, with
F'(λ) = -Σ_{j active} 1/k*_j. Newton from λ = 0 converges monotonically.

As in the JAX package the dual solvers run a fixed number of steps (50
Newton, 100 bisection: its ``fori_loop``), each a few tensor operations on
the device, with no read-back to the host. Y (n, m) projects its m columns
of length n; the work is float32 and the result is in Y's type.
"""

from __future__ import annotations

from typing import Optional

import torch

_NEWTON_ITERS = 50
_BISECT_ITERS = 100


def l1inf_norm(y: torch.Tensor) -> torch.Tensor:
    """‖Y‖_{1,∞} = Σ_j max_i |Y_ij| for Y of shape (n, m)."""
    return y.abs().amax(dim=0).sum()


def _caps_for_lambda(lam, csum, dks):
    """t_j(λ) and the Newton slope F'(λ), vectorized over the columns.

    csum : (n, m) prefix sums of each column sorted descending
    dks  : (n, m) d_k = S_k - k·a_k (non-decreasing down each column)
    """
    # k* = #{k : d_k <= λ}; at least 1 because d_1 = 0 <= λ
    k = torch.clamp((dks <= lam).sum(dim=0), min=1)
    sk = torch.gather(csum, 0, (k - 1)[None, :])[0]
    kf = k.to(csum.dtype)
    t = torch.clamp((sk - lam) / kf, min=0.0)
    # columns whose total mass is <= λ are shrunk to cap 0
    t = torch.where(csum[-1] <= lam, torch.zeros_like(t), t)
    d_f = -((t > 0).to(csum.dtype) / kf).sum()
    return t, d_f


def _sorted_column_stats(a: torch.Tensor):
    """(csum, dks) of the columns of ``a`` sorted descending, shared by every
    dual solver."""
    n = a.shape[0]
    a_sorted = torch.sort(a, dim=0, descending=True).values
    csum = torch.cumsum(a_sorted, dim=0)
    ks = torch.arange(1, n + 1, dtype=a.dtype, device=a.device)[:, None]
    return csum, csum - ks * a_sorted


def _solve_lambda_newton(a, csum, dks, radius, iters):
    """Semismooth Newton on F(λ) = Σ t_j(λ) - η, monotone from λ = 0."""
    lam = torch.zeros((), dtype=a.dtype, device=a.device)
    for _ in range(iters):
        t, d_f = _caps_for_lambda(lam, csum, dks)
        f = t.sum() - radius
        # d_f < 0 whenever F > 0 (an active column); guard anyway
        step = f / torch.where(d_f >= -1e-20, torch.full_like(d_f, -1e-20), d_f)
        lam = torch.clamp(lam - step, min=0.0)
    return lam


def _solve_lambda_bisect(a, csum, dks, radius, iters):
    """Bisection on F(λ) (slower, very robust: the cross-check oracle)."""
    lo = torch.zeros((), dtype=a.dtype, device=a.device)
    # F(hi) = -η <= 0: at λ = the largest column mass every cap t_j is 0.
    # (The JAX package brackets with Σ_j max_i |Y_ij|, which is below the
    # root when columns are long and few, e.g. (300, 17): its bisection then
    # stops at the bracket's end with an infeasible result.)
    hi = csum[-1].amax()
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        above = _caps_for_lambda(mid, csum, dks)[0].sum() - radius > 0
        lo, hi = torch.where(above, mid, lo), torch.where(above, hi, mid)
    return 0.5 * (lo + hi)


# dual-λ solver registry, same shape as core.ball's ℓ1 backend table: a new
# root finder is one entry here, not a new public function
_DUAL_SOLVERS = {
    "newton": (_solve_lambda_newton, _NEWTON_ITERS),
    "bisect": (_solve_lambda_bisect, _BISECT_ITERS),
}


def resolve_dual_solver(method: str) -> str:
    if method not in _DUAL_SOLVERS:
        raise ValueError(
            f"unknown l1inf dual solver {method!r}; available: "
            f"{sorted(_DUAL_SOLVERS)}")
    return method


def project_l1inf_exact(y: torch.Tensor, radius, iters: Optional[int] = None,
                        method: str = "newton") -> torch.Tensor:
    """Exact projection of Y (n, m) onto the ℓ1,∞ ball of ``radius``.

    ``method`` selects the dual-λ root search: "newton" (semismooth Newton,
    default, 50 steps) or "bisect" (100 steps); ``iters`` overrides the
    count. Returns Y unchanged when it is already feasible.
    """
    solver, default_iters = _DUAL_SOLVERS[resolve_dual_solver(method)]
    yf = y.to(torch.float32)
    a = yf.abs()
    r = torch.as_tensor(radius, dtype=torch.float32, device=y.device)
    csum, dks = _sorted_column_stats(a)
    lam = solver(a, csum, dks, r, default_iters if iters is None else iters)
    t, _ = _caps_for_lambda(lam, csum, dks)
    x = torch.sign(yf) * torch.minimum(a, t[None, :])
    return torch.where(l1inf_norm(yf) <= r, yf, x).to(y.dtype)


def project_l1inf_exact_bisect(y: torch.Tensor, radius,
                               iters: int = _BISECT_ITERS) -> torch.Tensor:
    """Bisection variant (the cross-check oracle of the tests)."""
    return project_l1inf_exact(y, radius, iters=iters, method="bisect")
