"""Schedule IR for multi-level projections — compile ν, then execute
(port of ``repro/core/schedule.py``).

A norm design ``levels = [(q₁, k₁), ..., (q_L, k_L)]`` compiles to

    ReduceLevel(q₁, axes₁) → … → ReduceLevel(q_{L-1}, axes_{L-1})
        → OuterSolve(q_L)
    → ApplyGroup(q_{L-1}, axes_{L-1}) → … → ApplyGroup(q₁, axes₁)

a forward sweep of norm aggregations, one vector projection of the fully
aggregated (small) tensor, and a backward sweep of group-wise applies that
reuse the forward aggregates (ℓ2 apply = rescale by the *saved* group norm,
ℓ∞ apply = clip, only an ℓ1 apply solves a θ per group).

:func:`execute` runs the schedule with plain PyTorch ops on any device; the
generated CUDA kernels (``kernels/codegen``) run the same schedule fused.
``batch_dims`` prepends carried-through axes: they are outer axes of every
level and the OuterSolve runs batched over them.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch

from repro_torch.obs import profile as obs_profile

from . import ball

Level = Tuple[object, int]


class ReduceLevel(NamedTuple):
    """Aggregate ``axes`` of the current tensor with ``norm`` (forward sweep)."""

    norm: str                 # canonical '1' | '2' | 'inf'
    axes: Tuple[int, ...]     # absolute axes in this step's input tensor


class OuterSolve(NamedTuple):
    """Project the fully aggregated tensor (flattened past the batch axes)
    onto the ``norm``-ball — the single θ-solve of the whole design."""

    norm: str


class ApplyGroup(NamedTuple):
    """Shrink each group (a slice over ``axes``) of the matching reduce's
    input to the radius computed one level up (backward sweep)."""

    norm: str
    axes: Tuple[int, ...]


Step = Union[ReduceLevel, OuterSolve, ApplyGroup]


class Schedule(NamedTuple):
    """A compiled norm design: the step list plus its static shape plan.

    ``stage_shapes[i]`` is the input shape of the i-th reduce (so
    ``stage_shapes[0]`` is the tensor shape and ``stage_shapes[-1]`` the shape
    the OuterSolve sees, batch axes included).
    """

    shape: Tuple[int, ...]
    batch_dims: int
    levels: Tuple[Tuple[str, int], ...]
    steps: Tuple[Step, ...]
    stage_shapes: Tuple[Tuple[int, ...], ...]

    @property
    def reduces(self) -> Tuple[ReduceLevel, ...]:
        return tuple(s for s in self.steps if isinstance(s, ReduceLevel))

    @property
    def applies(self) -> Tuple[ApplyGroup, ...]:
        return tuple(s for s in self.steps if isinstance(s, ApplyGroup))

    @property
    def solve(self) -> OuterSolve:
        return next(s for s in self.steps if isinstance(s, OuterSolve))

    @property
    def solve_size(self) -> int:
        """Length of the vector the OuterSolve's θ-solver sees (per batch
        element)."""
        lead = self.stage_shapes[-1][self.batch_dims:]
        return math.prod(lead) if lead else 1

    @property
    def level_group_sizes(self) -> Tuple[int, ...]:
        """Aggregated extent g_t of each ReduceLevel — the group length of the
        matching apply."""
        return tuple(math.prod(self.stage_shapes[i][a] for a in red.axes)
                     for i, red in enumerate(self.reduces))

    @property
    def canonical_shape(self) -> Tuple[int, ...]:
        """The collapsed view ``batch… + (g_1, …, g_{L-1}, solve_size)``.

        Each reduce level's axes fuse into one axis and the surviving axes
        flatten into the last axis; every level's axes are contiguous and in
        order, so the reshape is a view. This is the shape the CUDA kernels
        (``kernels/codegen``) index.
        """
        batch = self.shape[:self.batch_dims]
        return batch + self.level_group_sizes + (self.solve_size,)

    @property
    def canonical_stage_shapes(self) -> Tuple[Tuple[int, ...], ...]:
        """Collapsed ``stage_shapes``: entry i is the canonical input shape of
        the i-th reduce (entry -1 is what the OuterSolve sees)."""
        canon = self.canonical_shape
        b = self.batch_dims
        return tuple(canon[:b] + canon[b + i:]
                     for i in range(len(self.reduces) + 1))


def canonical_levels(levels: Sequence[Level]) -> Tuple[Tuple[str, int], ...]:
    """Canonicalize a norm design to ``(('1'|'2'|'inf', n_axes), ...)``."""
    return tuple((ball.canonical_norm(q), int(k)) for q, k in levels)


def check_levels(shape, levels: Sequence[Level], batch_dims: int = 0) -> None:
    """Validate that ν covers exactly the non-batch axes of ``shape``."""
    total = sum(k for _, k in levels)
    if total != len(shape) - batch_dims:
        covered = f"{len(shape)} - {batch_dims} batch" if batch_dims \
            else str(len(shape))
        raise ValueError(
            f"norm design {list(levels)} covers {total} axes but tensor has "
            f"{covered}")
    for _, k in levels:
        if k < 1:
            raise ValueError("each level must aggregate at least one axis")


@functools.lru_cache(maxsize=None)
def _compile_cached(shape, levels, batch_dims):
    check_levels(shape, levels, batch_dims)
    b = batch_dims
    steps = []
    stage_shapes = [shape]
    cur = shape
    for q, k in levels[:-1]:
        steps.append(ReduceLevel(q, tuple(range(b, b + k))))
        cur = cur[:b] + cur[b + k:]
        stage_shapes.append(cur)
    steps.append(OuterSolve(levels[-1][0]))
    for q, red in zip(reversed([q for q, _ in levels[:-1]]),
                      reversed(steps[:-1])):
        steps.append(ApplyGroup(q, red.axes))
    return Schedule(shape, b, levels, tuple(steps), tuple(stage_shapes))


def compile_schedule(shape, levels: Sequence[Level],
                     batch_dims: int = 0) -> Schedule:
    """Lower a norm design against a shape into a reduce/solve/apply schedule."""
    return _compile_cached(tuple(int(s) for s in shape),
                           canonical_levels(levels), int(batch_dims))


# --------------------------------------------------------------------------- #
# Step primitives
# --------------------------------------------------------------------------- #


def apply_group(y: torch.Tensor, norm: str, radii: torch.Tensor, axes,
                agg: Optional[torch.Tensor], method: str) -> torch.Tensor:
    """One ApplyGroup step: shrink each group of ``y`` to its radius.

    ``agg`` is the matching forward aggregate (the group norms); the ℓ2 apply
    rescales by it instead of recomputing the norm.
    """
    if norm == "inf":
        u_b = ball.expand_at(radii, axes)
        return torch.minimum(torch.maximum(y, -u_b), u_b)
    if norm == "2" and agg is not None:
        # the 1e-30 floor keeps an all-zero group (agg == 0) out of 0/0
        scale = torch.where(agg > radii, radii / torch.clamp(agg, min=1e-30),
                            torch.ones_like(agg))
        return y * ball.expand_at(scale, axes)
    return ball.project_grouped(y, norm, radii, inner_axes=axes, method=method)


def solve_outer(top: torch.Tensor, norm: str, radius, batch_dims: int,
                method: str) -> torch.Tensor:
    """The OuterSolve: flatten past the batch axes, project, restore shape."""
    lead = tuple(top.shape[:batch_dims])
    flat = top.reshape(lead + (-1,))
    return ball.project_ball(flat, norm, radius, method=method).reshape(top.shape)


def execute(y: torch.Tensor, sched: Schedule, radius,
            method: str = "sort") -> torch.Tensor:
    """Run a compiled schedule with plain PyTorch ops on ``y``'s device.

    The forward sweep keeps every reduce input and output; the OuterSolve
    runs on the final aggregate; the backward sweep applies through the saved
    stages.
    """
    method = ball.resolve_method(method)
    inputs = [y]
    aggs = []
    for t, red in enumerate(sched.reduces):
        with obs_profile.stage_scope(red, t):
            v = ball.norm_reduce(inputs[-1], red.norm, axes=red.axes)
        aggs.append(v)
        inputs.append(v)
    with obs_profile.stage_scope(sched.solve):
        w = solve_outer(inputs[-1], sched.solve.norm, radius,
                        sched.batch_dims, method)
    for i, app in zip(reversed(range(len(aggs))), sched.applies):
        with obs_profile.stage_scope(app, i):
            w = apply_group(inputs[i], app.norm, w, app.axes, aggs[i], method)
    return w


# --------------------------------------------------------------------------- #
# Collective-bytes model of the mesh executor (core/sharded.py)
# --------------------------------------------------------------------------- #

_L1_APPLY_SWEEPS = 65  # distributed bisect: 64 φ-psums + the initial pmax


def sharded_collective_bytes(shape, levels: Sequence[Level], spec,
                             mesh_sizes, itemsize: int = 4, *,
                             batch_dims: int = 0) -> dict:
    """Per-step collective payload of the sharded schedule vs gathering the
    tensor (pure arithmetic; the JAX package's model, plus batch axes).

    ``spec`` maps each tensor axis to a mesh axis name (or None);
    ``mesh_sizes`` maps mesh axis names to their rank counts. A payload is
    what one rank's collective carries:

    * a ReduceLevel over a sharded axis all-reduces its output aggregate;
    * the OuterSolve all-gathers the final aggregate iff a sharded non-batch
      axis survives every reduce;
    * an ℓ∞/ℓ2 ApplyGroup is local; an ℓ1 ApplyGroup whose group spans a
      sharded axis runs the distributed bisection, ``_L1_APPLY_SWEEPS``
      collectives over the group count.

    The leading ``batch_dims`` axes ride along in every payload at their
    per-rank extent (a sharded batch axis carries its own slice only), and
    so does a sharded axis that survives into a reduce's or an ℓ1 apply's
    aggregate (the JAX model counts that axis whole; the two agree wherever
    one axis is sharded). Each
    step also gives its number of collective ``calls`` (one per reduce or
    gather, ``_L1_APPLY_SWEEPS`` per distributed bisection).
    """
    sched = compile_schedule(shape, levels, batch_dims)
    b = sched.batch_dims
    names = [spec[a] if a < len(spec) else None for a in range(len(shape))]

    def ranks(n) -> int:   # an axis name, or a tuple of them
        return math.prod(mesh_sizes[a] for a in ((n,) if isinstance(n, str) else n))

    batch_local = math.prod(-(-d // ranks(n)) if n else d
                            for d, n in zip(shape[:b], names[:b]))

    def payload(stage_shape, stage_names=None) -> int:
        """Bytes of a stage's aggregate on one rank: with ``stage_names``,
        a sharded axis that survives to the stage at its per-rank extent."""
        dims = stage_shape[b:]
        if stage_names is not None:
            dims = [-(-d // ranks(n)) if n else d
                    for d, n in zip(dims, stage_names[b:])]
        return batch_local * math.prod(dims) * itemsize

    steps = []
    stage_names = [list(names)]
    for i, red in enumerate(sched.reduces):
        cur = stage_names[-1]
        coll = [cur[a] for a in red.axes if cur[a]]
        out_names = [n for a, n in enumerate(cur) if a not in red.axes]
        steps.append({"step": f"reduce_{red.norm}",
                      "bytes": payload(sched.stage_shapes[i + 1], out_names)
                      if coll else 0,
                      "calls": int(bool(coll))})
        stage_names.append(out_names)
    gather = any(stage_names[-1][b:])
    steps.append({"step": f"solve_{sched.solve.norm}",
                  "bytes": payload(sched.stage_shapes[-1]) if gather else 0,
                  "calls": sum(1 for n in stage_names[-1][b:] if n)})
    for i, app in zip(reversed(range(len(sched.reduces))), sched.applies):
        coll = [stage_names[i][a] for a in app.axes if stage_names[i][a]]
        spans = app.norm == "1" and coll
        steps.append({"step": f"apply_{app.norm}",
                      "bytes": payload(sched.stage_shapes[i + 1],
                                       stage_names[i + 1])
                      * _L1_APPLY_SWEEPS if spans else 0,
                      "calls": _L1_APPLY_SWEEPS if spans else 0})
    total = sum(s["bytes"] for s in steps)
    gathered = math.prod(shape) * itemsize
    return {
        "per_step": steps,
        "schedule_bytes": total,
        "schedule_calls": sum(s["calls"] for s in steps),
        "gather_bytes": gathered,
        "ratio": gathered / max(total, 1),
    }
