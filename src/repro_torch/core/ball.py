"""Vector norm-ball projections — the primitives every level of the multi-level
projection is built from (port of ``repro/core/ball.py``).

Plain PyTorch on any device. Every function works on the *last* axis of its
input unless stated otherwise and takes a scalar or broadcastable ``radius``
(a Python number or a tensor).

Three ℓ1 θ-solvers, registered by name:

* ``sort``   — sort + prefix-sum threshold. O(n log n), exact.
* ``bisect`` — 64 fixed bisection steps on the soft-threshold θ. O(k·n),
  elementwise ops and reductions only; accurate to ~2^-64 of the range.
* ``filter`` — Michelot/Condat fixed point over a shrinking active set
  (aliases ``michelot``, ``condat``). O(n) expected, exact at the fixed
  point. The loop runs without autograd and only finds the active set; θ is
  recomputed from it in closed form, so gradients flow as for ``sort``.

Ball contract: ``ball_theta`` returns θ <= 0 when ``sum(a) <= radius``, so
the soft threshold is the identity inside the ball. Simplex contract: always
solve the equality (θ may be negative).
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict, NamedTuple, Sequence, Union

import torch

Scalar = Union[float, torch.Tensor]

_BISECT_ITERS = 64  # enough for float32 exactness on well-scaled data


def _as(radius, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(radius, dtype=like.dtype, device=like.device)


def _soft_threshold(a: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    return torch.clamp(a - theta, min=0.0)


# --------------------------------------------------------------------------- #
# θ solvers: sum(max(a - θ, 0)) == radius for non-negative a
# --------------------------------------------------------------------------- #


def simplex_threshold_sort(a: torch.Tensor, radius: Scalar) -> torch.Tensor:
    """Threshold θ with sum(max(a - θ, 0)) == radius for non-negative ``a``
    (sort-based, exact); θ = -1 when ``sum(a) <= radius``."""
    radius = _as(radius, a)
    csum, thetas, k = _sorted_candidates(a, radius)
    theta = torch.take_along_dim(thetas, k[..., None] - 1, dim=-1)[..., 0]
    inside = csum[..., -1] <= radius
    return torch.where(inside, torch.full_like(theta, -1.0), theta)


def _sorted_candidates(a: torch.Tensor, radius: torch.Tensor):
    """Descending prefix sums, candidate θ_k = (csum_k - r)/k, and the
    largest valid k (>= 1)."""
    a_sorted = torch.sort(a, dim=-1, descending=True).values
    csum = torch.cumsum(a_sorted, dim=-1)
    n = a.shape[-1]
    ks = torch.arange(1, n + 1, dtype=a.dtype, device=a.device)
    thetas = (csum - radius[..., None]) / ks
    valid = a_sorted > thetas
    k = torch.clamp(valid.sum(dim=-1), min=1)
    return csum, thetas, k


def _bisect(a: torch.Tensor, radius: torch.Tensor, lo: torch.Tensor,
            hi: torch.Tensor, iters: int) -> torch.Tensor:
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        phi = _soft_threshold(a, mid[..., None]).sum(dim=-1)
        too_small = phi > radius  # θ too small -> raise lo
        lo = torch.where(too_small, mid, lo)
        hi = torch.where(too_small, hi, mid)
    return 0.5 * (lo + hi)


def simplex_threshold_bisect(a: torch.Tensor, radius: Scalar,
                             iters: int = _BISECT_ITERS) -> torch.Tensor:
    """Bisection on φ(θ) = sum(max(a-θ, 0)) = radius over [0, max(a)];
    θ = -1 when ``sum(a) <= radius``."""
    radius = _as(radius, a)
    hi = torch.amax(a, dim=-1)
    theta = _bisect(a, radius, torch.zeros_like(hi), hi, iters)
    inside = a.sum(dim=-1) <= radius
    return torch.where(inside, torch.full_like(theta, -1.0), theta)


@torch.no_grad()
def _filter_theta(a: torch.Tensor, radius: torch.Tensor) -> torch.Tensor:
    """Michelot fixed-point θ for the *equality* constraint, batched.

    θ₀ = (Σa - r)/n; repeat θ ← (Σ_{aᵢ>θ} aᵢ - r)/#{aᵢ>θ} until the active set
    stops shrinking (at most n sweeps). Converged rows sit at a fixed point,
    so the loop runs until every row converged without disturbing them.
    """
    n = a.shape[-1]
    s0 = a.sum(dim=-1)
    r = torch.broadcast_to(radius, s0.shape)
    theta = (s0 - r) / n
    count = torch.full(s0.shape, n, dtype=torch.int64, device=a.device)
    done = torch.zeros(s0.shape, dtype=torch.bool, device=a.device)
    it = 0
    while not bool(done.all()) and it < n + 2:
        active = a > theta[..., None]
        new_count = active.sum(dim=-1)
        ssum = torch.where(active, a, torch.zeros_like(a)).sum(dim=-1)
        new_theta = (ssum - r) / torch.clamp(new_count, min=1).to(a.dtype)
        # empty active set (radius ~0 edge): current θ already clips everything
        new_theta = torch.where(new_count > 0, new_theta, theta)
        converged = (new_count == count) | (new_count == 0)
        theta = torch.where(done, theta, new_theta)
        count = torch.where(done, count, new_count)
        done = done | converged
        it += 1
    return theta


def _filter_theta_diff(a: torch.Tensor, radius: torch.Tensor) -> torch.Tensor:
    """``_filter_theta`` with θ recomputed in closed form from the active set
    the loop found, so autograd sees θ = (Σ_{active} aᵢ - r)/#active."""
    theta0 = _filter_theta(a.detach(), radius.detach())
    active = a.detach() > theta0[..., None]
    count = active.sum(dim=-1)
    ssum = torch.where(active, a, torch.zeros_like(a)).sum(dim=-1)
    r = torch.broadcast_to(radius, ssum.shape)
    theta = (ssum - r) / torch.clamp(count, min=1).to(a.dtype)
    return torch.where(count > 0, theta, theta0)


def simplex_threshold_filter(a: torch.Tensor, radius: Scalar) -> torch.Tensor:
    """Michelot/Condat filtering θ (ball contract: θ = -1 when inside)."""
    radius = _as(radius, a)
    theta = _filter_theta_diff(a, radius)
    inside = a.sum(dim=-1) <= radius
    return torch.where(inside, torch.full_like(theta, -1.0), theta)


# --------------------------------------------------------------------------- #
# Backend registry
# --------------------------------------------------------------------------- #


class L1Method(NamedTuple):
    """One ℓ1/simplex θ-solver backend.

    ``ball_theta``    — θ with the ball contract (θ <= 0 ⇒ identity inside).
    ``simplex_theta`` — θ for the equality constraint (may be negative).
    ``complexity``    — human-readable work bound.
    ``differentiable``— safe under autograd.
    """

    ball_theta: Callable[[torch.Tensor, Scalar], torch.Tensor]
    simplex_theta: Callable[[torch.Tensor, Scalar], torch.Tensor]
    complexity: str
    differentiable: bool


def _simplex_theta_sort(a: torch.Tensor, radius: Scalar) -> torch.Tensor:
    _, thetas, k = _sorted_candidates(a, _as(radius, a))
    return torch.take_along_dim(thetas, k[..., None] - 1, dim=-1)[..., 0]


def _simplex_theta_bisect(a: torch.Tensor, radius: Scalar) -> torch.Tensor:
    # bisection over [min(a)-radius/n, max(a)] (θ may be negative)
    radius = _as(radius, a)
    hi = torch.amax(a, dim=-1)
    lo = torch.amin(a, dim=-1) - radius / a.shape[-1]
    return _bisect(a, radius, lo, hi, _BISECT_ITERS)


def _simplex_theta_filter(a: torch.Tensor, radius: Scalar) -> torch.Tensor:
    return _filter_theta_diff(a, _as(radius, a))


_L1_METHODS: Dict[str, L1Method] = {}
_L1_ALIASES: Dict[str, str] = {}

DEFAULT_METHOD = "sort"


def register_l1_method(name: str, method: L1Method, *,
                       aliases: Sequence[str] = ()) -> None:
    """Register an ℓ1 θ-solver backend under ``name`` (and ``aliases``)."""
    _L1_METHODS[name] = method
    for alias in aliases:
        _L1_ALIASES[alias] = name


def resolve_method(method: str | None, *, default: str = DEFAULT_METHOD) -> str:
    """Canonicalize a backend name (None → default, aliases → canonical);
    ``ValueError`` for unknown names."""
    if method is None:
        method = default
    name = _L1_ALIASES.get(method, method)
    if name not in _L1_METHODS:
        raise ValueError(
            f"unknown l1 method {method!r}; available: {sorted(_L1_METHODS)}")
    return name


def available_methods() -> tuple:
    """Canonical names of all registered ℓ1 backends."""
    return tuple(sorted(_L1_METHODS))


def method_info(method: str) -> L1Method:
    """Registry record for a (possibly aliased) backend name."""
    return _L1_METHODS[resolve_method(method)]


register_l1_method("sort", L1Method(
    simplex_threshold_sort, _simplex_theta_sort,
    complexity="O(n log n)", differentiable=True))
register_l1_method("bisect", L1Method(
    simplex_threshold_bisect, _simplex_theta_bisect,
    complexity="O(k n), k=64 fixed", differentiable=True))
register_l1_method("filter", L1Method(
    simplex_threshold_filter, _simplex_theta_filter,
    complexity="O(n) expected", differentiable=True),
    aliases=("michelot", "condat"))


# --------------------------------------------------------------------------- #
# Projections
# --------------------------------------------------------------------------- #


def project_simplex(y: torch.Tensor, radius: Scalar = 1.0,
                    method: str = "sort") -> torch.Tensor:
    """Euclidean projection onto {x >= 0, sum(x) == radius} over the last axis."""
    theta = _L1_METHODS[resolve_method(method)].simplex_theta(y, radius)
    return torch.clamp(y - theta[..., None], min=0.0)


def project_l1(y: torch.Tensor, radius: Scalar,
               method: str = "sort") -> torch.Tensor:
    """Euclidean projection onto the ℓ1 ball of ``radius`` over the last axis."""
    a = torch.abs(y)
    theta = _L1_METHODS[resolve_method(method)].ball_theta(a, radius)
    return torch.sign(y) * _soft_threshold(
        a, torch.clamp(theta, min=0.0)[..., None])


project_l1_sort = functools.partial(project_l1, method="sort")
project_l1_bisect = functools.partial(project_l1, method="bisect")
project_l1_filter = functools.partial(project_l1, method="filter")


def _l2_scale(nrm: torch.Tensor, radius: torch.Tensor) -> torch.Tensor:
    """Rescale factor onto the ℓ2 ball; the 1e-30 floor keeps 0/0 out."""
    return torch.where(nrm > radius, radius / torch.clamp(nrm, min=1e-30),
                       torch.ones_like(nrm))


def project_l2(y: torch.Tensor, radius: Scalar) -> torch.Tensor:
    """Projection onto the ℓ2 ball over the last axis: pure rescale."""
    radius = _as(radius, y)
    nrm = torch.linalg.vector_norm(y, dim=-1, keepdim=True)
    return y * _l2_scale(nrm, radius[..., None])


def project_linf(y: torch.Tensor, radius: Scalar) -> torch.Tensor:
    """Projection onto the ℓ∞ ball: elementwise clip. ``radius`` broadcasts
    over the leading axes."""
    radius = _as(radius, y)
    if radius.ndim:
        radius = radius[..., None]
    return torch.minimum(torch.maximum(y, -radius), radius)


# --------------------------------------------------------------------------- #
# Per-norm dispatch tables
# --------------------------------------------------------------------------- #

_NORM_NAMES = {1: "1", "1": "1", 2: "2", "2": "2",
               math.inf: "inf", "inf": "inf"}


def canonical_norm(norm) -> str:
    """Canonical name ('1' | '2' | 'inf') of a norm spec, or ValueError."""
    try:
        return _NORM_NAMES[norm]
    except (KeyError, TypeError):
        raise ValueError(f"unsupported norm {norm!r}") from None


def project_ball(y: torch.Tensor, norm, radius: Scalar,
                 method: str = "sort") -> torch.Tensor:
    """Project the last axis of ``y`` onto the ``norm``-ball
    (``norm`` ∈ {1, 2, math.inf, 'inf'})."""
    q = canonical_norm(norm)
    if q == "1":
        return project_l1(y, radius, method=method)
    if q == "2":
        return project_l2(y, radius)
    return project_linf(y, radius)


def _dims(axes) -> tuple:
    return (axes,) if isinstance(axes, int) else tuple(axes)


def norm_reduce(y: torch.Tensor, norm, axes) -> torch.Tensor:
    """Aggregate ``y`` over ``axes`` with the given norm (the v_q of the paper)."""
    q = canonical_norm(norm)
    dims = _dims(axes)
    if q == "1":
        return torch.abs(y).sum(dim=dims)
    if q == "2":
        return torch.sqrt(torch.square(y).sum(dim=dims))
    return torch.amax(torch.abs(y), dim=dims)


def ball_norm(x: torch.Tensor, norm, axis=-1) -> torch.Tensor:
    """Vector norm along ``axis`` (thin wrapper used by tests/invariants)."""
    return norm_reduce(x, norm, axis)


def expand_at(radii: torch.Tensor, axes) -> torch.Tensor:
    """Insert size-1 axes at ``axes`` (positions in the result), like
    ``jnp.expand_dims``."""
    for ax in sorted(_dims(axes)):
        radii = radii.unsqueeze(ax)
    return radii


def project_grouped(y: torch.Tensor, norm, radii: torch.Tensor, inner_axes,
                    method: str = "sort") -> torch.Tensor:
    """Project every group of ``y`` onto its own ``norm``-ball.

    A group is a slice over ``inner_axes``; ``radii`` has the shape of the
    remaining (outer) axes.
    """
    inner_axes = tuple(a % y.ndim for a in _dims(inner_axes))
    outer_axes = tuple(a for a in range(y.ndim) if a not in inner_axes)
    q = canonical_norm(norm)
    u_b = expand_at(radii, inner_axes)
    if q == "inf":
        return torch.minimum(torch.maximum(y, -u_b), u_b)
    if q == "2":
        nrm = torch.sqrt(torch.square(y).sum(dim=inner_axes, keepdim=True))
        return y * _l2_scale(nrm, u_b)
    # q == "1": move the group axes last, flatten, batched l1 projection
    perm = outer_axes + inner_axes
    yt = y.permute(perm)
    outer_shape = yt.shape[: len(outer_axes)]
    inner_size = math.prod(yt.shape[len(outer_axes):])
    proj = project_l1(yt.reshape(-1, inner_size), radii.reshape(-1),
                      method=method)
    proj = proj.reshape(tuple(outer_shape) + tuple(yt.shape[len(outer_axes):]))
    inv = tuple(perm.index(i) for i in range(y.ndim))
    return proj.permute(inv)

