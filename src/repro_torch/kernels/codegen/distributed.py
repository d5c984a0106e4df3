"""Sharded codegen lowering — the generated CUDA kernels as the shard-local
stages of the mesh executor (port of ``repro/kernels/codegen/distributed.py``).

The mesh executor (``core/sharded.py``) runs a compiled schedule as local
stages stitched by the collective plan: one psum/pmax combine per sharded
ReduceLevel, a small all-gather + replicated θ-solve + re-slice for the
OuterSolve, local applies (with a distributed bisection for a mesh-spanning
ℓ1 group). This module builds the *same* body with the local stages lowered
through ``kernels/codegen``:

* the shard's reduce sweep is ONE streaming pass (``codegen_reduce`` on the
  local schedule's tile plan), producing every intermediate aggregate and
  the final level's RAW accumulator;
* when the final reduce level spans the mesh, its combine splices between
  the kernels on the raw accumulator (psum for ℓ1/ℓ2 — ℓ2 accumulates
  squares — pmax for ℓ∞) BEFORE the monoid's finalize, so the payload is
  exactly the plain body's;
* the OuterSolve gathers the finalized aggregate over surviving sharded
  axes in the *uncollapsed* surviving-axes view, solves replicated (the
  ``l1ball`` kernel for an ℓ1 solve by "bisect" or "filter"), and slices
  the local radii back out — the plain body's plan verbatim;
* the apply sweep is ONE fused pass (``codegen_apply``) — unless the final
  level is an ℓ1 whose group spans the mesh: then the distributed bisection
  (``core.sharded._grouped_l1_collective``) runs on the last intermediate
  aggregate and ``codegen_partial_apply`` resumes the chain one level down.

Leading batch axes are the kernels' leading launch axis (JAX vmaps the
batch-free body); the collectives carry the batch. The collective sequence
is the plain body's by construction, so ``sharded_collective_bytes``
describes both.

Eligibility (:func:`shardable`): a sharded tensor axis must be a batch axis,
a surviving (solve) axis, or an axis of the FINAL reduce level — an axis of
an *intermediate* level folds inside the reduce kernel, with no splice point
for its combine. The local schedule must tile (``plan_tiles``), and an ℓ1
outer solve must fit the ``l1ball`` kernel once gathered.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch

from repro_torch.core import ball, schedule as sched_mod
from repro_torch.core.schedule import Schedule
from repro_torch.obs import profile as obs_profile
from repro_torch.parallel import sharding

from .. import l1ball
from .lowering import (_solve_outer_batched, codegen_apply,
                       codegen_partial_apply, codegen_reduce, finalize)
from .tiling import L1_KERNEL_MAX, plan_tiles


def _level_of_axis(levels, batch_dims: int, axis: int) -> int:
    """The (0-indexed) level owning tensor axis ``axis``; levels consume
    contiguous axis runs left to right after the batch prefix."""
    off = batch_dims
    for t, (_, k) in enumerate(levels):
        if axis < off + k:
            return t
        off += k
    raise ValueError(f"axis {axis} not covered by levels {levels}")


def local_shape(shape: Sequence[int], axis_names: Sequence[Optional[str]],
                mesh) -> Tuple[int, ...]:
    """Per-shard shape of ``shape`` under ``axis_names`` — ceil division,
    the executor's zero-padded shards."""
    return sharding.local_shape(shape, axis_names, mesh)


def shardable(shape, levels, axis_names: Sequence[Optional[str]], mesh,
              dtype, batch_dims: int = 0) -> bool:
    """Can this design's shard-local stages lower through codegen?

    False when an *intermediate* reduce level's axis is sharded (its fold is
    inside the reduce kernel — no splice point for the combine), when the
    local per-shard schedule has no Hopper tiling, or when an ℓ1 outer
    solve over the gathered aggregate is longer than the ``l1ball`` kernel
    takes.
    """
    levels = sched_mod.canonical_levels(levels)
    L = len(levels)
    b = batch_dims
    for a, n in enumerate(axis_names):
        if n is None or a < b:
            continue
        if _level_of_axis(levels, b, a) < L - 2:
            return False
    lshape = local_shape(shape, axis_names, mesh)
    lsched = sched_mod.compile_schedule(lshape[b:], levels)
    if plan_tiles(lsched, dtype) is None:
        return False
    surv = lsched.stage_shapes[-1]
    gathered = math.prod(d * (sharding.entry_size(n, mesh.shape) if n else 1)
                         for d, n in zip(surv, axis_names[len(shape) - len(surv):]))
    return levels[-1][0] != "1" or gathered <= L1_KERNEL_MAX


def _solve_outer(v: torch.Tensor, norm: str, radii: torch.Tensor,
                 method: str) -> torch.Tensor:
    """Per-item outer solve of the (B, m) aggregate: the ``l1ball`` kernel
    for an ℓ1 solve by a kernel method, ``core.ball`` for "sort"."""
    if norm == "1" and method not in l1ball.KERNEL_METHODS:
        return ball.project_ball(v, "1", radii, method=method)
    return _solve_outer_batched(v, norm, radii, method)


def make_codegen_schedule_body(sched: Schedule,
                               axis_names: Sequence[Optional[str]], mesh,
                               dtype, *, method: str = "bisect",
                               device=None) -> Callable:
    """Build ``(y_local, radius) -> x_local`` with the shard-local stages
    lowered through the generated kernels.

    ``sched`` is the GLOBAL schedule on the (padded, evenly divisible)
    shape; the local schedule and its tile plan derive from the per-shard
    shape. On a CUDA ``device`` the tile plan is the measured one of the
    local shard's shape (``codegen.autotune_tiles`` on it, batch axes
    included), rank 0's verdict on every rank; otherwise the heuristic
    one, a function of shapes alone. Gate with
    :func:`shardable` first; raises ``ValueError`` when the design has no
    codegen lowering on this mesh.
    """
    from repro_torch.core.sharded import _grouped_l1_collective

    b = sched.batch_dims
    levels = sched.levels
    L = len(levels)
    names = tuple(axis_names)
    if not shardable(sched.shape, levels, names, mesh, dtype, b):
        raise ValueError(
            f"no sharded codegen lowering for levels={levels} on "
            f"shape={sched.shape} with axes {names}: an intermediate reduce "
            "axis is sharded, or the local shard does not tile")
    if any(d % sharding.entry_size(n, mesh.shape) for d, n in zip(sched.shape, names) if n):
        raise ValueError(
            "make_codegen_schedule_body needs even shards — the executor "
            "compiles the schedule on the zero-padded shape")
    lshape = local_shape(sched.shape, names, mesh)
    lsched = sched_mod.compile_schedule(lshape[b:], levels)
    norms = [q for q, _ in levels]
    tp = plan_tiles(lsched, dtype)
    if device is not None and torch.device(device).type == "cuda":
        from . import autotune_tiles

        tp = autotune_tiles(lshape, levels, dtype, method=method,
                            device=device, mesh=mesh)
    count = math.prod(lshape[:b])

    # final reduce level (index L-2): the mesh axes its combine spans
    n_reduced = sum(k for _, k in levels[:-1])
    n_before_fin = sum(k for _, k in levels[:-2])
    fin_coll = tuple(names[a] for a in range(b + n_before_fin, b + n_reduced)
                     if names[a]) if L > 1 else ()
    # surviving (solve) axes: the last level's run, after the batch axis
    surv_names = names[b + n_reduced:]
    surv_loc = lsched.stage_shapes[-1]
    surv_glob = tuple(d * sharding.entry_size(n, mesh.shape) if n else d
                      for d, n in zip(surv_loc, surv_names))

    def _solve_sliced(v, norm, radii):
        """Replicated outer solve with the surviving-axes gather/re-slice."""
        if not any(surv_names):
            return _solve_outer(v, norm, radii, method)
        g = v.reshape((count,) + surv_loc)
        for ax, n in enumerate(surv_names):
            if n:
                g = mesh.all_gather(g, n, axis=ax + 1)
        u = _solve_outer(g.reshape(count, -1), norm, radii, method)
        u = u.reshape((count,) + surv_glob)
        for ax, n in enumerate(surv_names):
            if n:
                u = u.narrow(ax + 1, mesh.axis_index(n) * surv_loc[ax],
                             surv_loc[ax])
        return u.reshape(v.shape).contiguous()

    def body(y_loc: torch.Tensor, radius) -> torch.Tensor:
        radii = torch.as_tensor(radius, dtype=y_loc.dtype,
                                device=y_loc.device).expand(count).contiguous()
        if L == 1:
            # degenerate flat solve: the whole design IS the OuterSolve
            with obs_profile.scope(f"codegen_solve_{norms[0]}"):
                return _solve_sliced(y_loc.reshape(count, -1), norms[0],
                                     radii).reshape(y_loc.shape)
        yc = y_loc.reshape((count,) + tp.canon_shape).contiguous()
        with obs_profile.scope("codegen_partial_reduce"):
            aggs, acc = codegen_reduce(yc, tp, norms[:-1], raw=True)
            if fin_coll:
                # the final level's combine on the RAW accumulator (ℓ2 still
                # squared), then finalize
                acc = mesh.pmax(acc, fin_coll) if norms[-2] == "inf" \
                    else mesh.psum(acc, fin_coll)
            vfin = finalize(norms[-2], acc)
        with obs_profile.scope(f"codegen_solve_{norms[-1]}"):
            u = _solve_sliced(vfin, norms[-1], radii)
        with obs_profile.scope("codegen_apply"):
            if norms[-2] == "1" and fin_coll:
                # the final level's ℓ1 groups span the mesh: distributed
                # θ-solve on the last resident stage, then resume the
                # epilogue below it
                src = yc if L == 2 else aggs[-1]
                w = _grouped_l1_collective(src, u, (1,), fin_coll, vfin, mesh)
                x = w if L == 2 else codegen_partial_apply(
                    yc, aggs, w.contiguous(), tp, norms[:-1])
            else:
                x = codegen_apply(yc, aggs, vfin.contiguous(), u, tp,
                                  norms[:-1])
        return x.reshape(y_loc.shape)

    return body
