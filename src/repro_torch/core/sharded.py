"""Mesh-native schedule executor — a compiled norm design on a mesh of
``torch.distributed`` ranks (port of ``repro/core/sharded.py``).

Each rank holds its shard of the tensor and runs the same program on it
(SPMD; the JAX package runs one ``shard_map`` body). The compiled schedule
maps onto the mesh step by step:

    ReduceLevel  — local norm-reduce; ONE collective combine (psum / pmax)
                   only when the level aggregates a sharded axis, and the
                   payload is the reduced aggregate, not the tensor
    OuterSolve   — all-gather of the FINAL aggregate (only if a sharded
                   axis survives every reduce), replicated θ-solve, local
                   re-slice of the per-group radii
    ApplyGroup   — local: ℓ∞ is a clip, ℓ2 rescales by the saved (already
                   global) group norm; an ℓ1 apply whose group spans the
                   mesh runs a distributed bisection on θ (64 small psums)

``multilevel_project_sharded`` takes and returns this rank's shard: the
ceil-division slice of each sharded axis, zero-padded past the end of the
axis (``parallel.sharding.shard`` cuts it so). Zeros are fixed points of
every level, so the padded tensor projects to the padded projection. The
weight itself never moves between ranks. ``backend="codegen"`` runs the
shard-local stages through the generated CUDA kernels
(``kernels/codegen/distributed.py``) with the same collective plan.

Every rank must issue the same collectives in the same order, so every
choice of code path is made from shapes alone, and a timed choice
(``method="auto"``) is made on rank 0 and broadcast.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.obs import profile as obs_profile
from repro_torch.parallel import mesh as mesh_mod
from repro_torch.parallel.sharding import entry_size, local_shape

from . import ball
from . import schedule as sched_mod

_BISECT_ITERS = 64
BACKENDS = ("plain", "codegen")


def parse_spec(spec, ndim: int, mesh) -> Tuple[object, ...]:
    """THE parser of spec entries for the schedule executor (the planner's
    ``canonical_sharding`` and the projection hook delegate here).

    Returns the per-tensor-axis mesh axis name padded to ``ndim``: a name,
    or a tuple of names where the entry shards one tensor axis over
    several mesh axes (row-major over them, ``parallel.sharding``'s
    layout; a collective over such an axis spans all of them). A name that
    is not a mesh axis raises.
    """
    entries = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    names = []
    for entry in entries[:ndim]:
        if entry is None:
            names.append(None)
            continue
        entry = tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)
        for a in entry:
            if a not in mesh.shape:
                raise ValueError(
                    f"spec names mesh axis {a!r} but mesh has "
                    f"{tuple(mesh.shape)}")
        names.append(str(entry[0]) if len(entry) == 1
                     else tuple(str(a) for a in entry))
    return tuple(names)


def _grouped_l1_collective(y: torch.Tensor, radii: torch.Tensor, axes,
                           axis_names: Tuple[str, ...],
                           group_sum: torch.Tensor, mesh) -> torch.Tensor:
    """Distributed grouped-ℓ1 apply: each group spans mesh axes
    ``axis_names``.

    Bisection on the soft-threshold θ where every φ(θ) evaluation is a local
    partial sum plus one small psum over the group count — the group's data
    never moves. ``group_sum`` is the saved global ℓ1 aggregate, the
    inside-the-ball test for free.
    """
    a = y.abs()
    hi = mesh.pmax(a.amax(dim=axes), axis_names)
    lo = torch.zeros_like(hi)
    for _ in range(_BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        phi = torch.clamp(a - ball.expand_at(mid, axes), min=0.0).sum(dim=axes)
        too_small = mesh.psum(phi, axis_names) > radii
        lo = torch.where(too_small, mid, lo)
        hi = torch.where(too_small, hi, mid)
    theta = torch.where(group_sum <= radii, torch.zeros_like(lo),
                        torch.clamp(0.5 * (lo + hi), min=0.0))
    return torch.sign(y) * torch.clamp(a - ball.expand_at(theta, axes), min=0.0)


def make_schedule_body(sched: sched_mod.Schedule,
                       axis_names: Sequence[Optional[str]], mesh,
                       method: str = "sort"):
    """Build the plain body ``(y_local, radius) -> x_local`` of a schedule.

    ``sched`` is the GLOBAL schedule (on the padded shape);
    ``axis_names[a]`` is the mesh axis the a-th tensor axis is sharded over
    (None = local). Collectives and PyTorch ops only; the method is resolved
    here, at build time.
    """
    method = ball.resolve_method(method)
    b = sched.batch_dims

    def body(y_loc, radius):
        inputs = [y_loc]
        aggs = []
        stage_names = [tuple(axis_names)]
        for t, red in enumerate(sched.reduces):
            cur, names = inputs[-1], stage_names[-1]
            coll = tuple(names[a] for a in red.axes if names[a])
            with obs_profile.stage_scope(red, t):
                if red.norm == "1":
                    v = cur.abs().sum(dim=red.axes)
                    v = mesh.psum(v, coll) if coll else v
                elif red.norm == "2":
                    s = torch.square(cur).sum(dim=red.axes)
                    v = torch.sqrt(mesh.psum(s, coll) if coll else s)
                else:
                    v = cur.abs().amax(dim=red.axes)
                    v = mesh.pmax(v, coll) if coll else v
            aggs.append(v)
            inputs.append(v)
            stage_names.append(tuple(
                n for a, n in enumerate(names) if a not in red.axes))

        # OuterSolve: gather the surviving sharded axes (small), solve
        # replicated, slice the local radii back out
        top, names = inputs[-1], stage_names[-1]
        local_sizes = top.shape
        with obs_profile.stage_scope(sched.solve):
            g = top
            for ax in range(b, len(names)):
                if names[ax]:
                    g = mesh.all_gather(g, names[ax], axis=ax)
            w = sched_mod.solve_outer(g, sched.solve.norm, radius, b, method)
            for ax in range(b, len(names)):
                if names[ax]:
                    idx = mesh.axis_index(names[ax])
                    w = w.narrow(ax, idx * local_sizes[ax], local_sizes[ax])

        # backward sweep: local applies; only a mesh-spanning ℓ1 group needs
        # the distributed θ-solve
        for i, app in zip(reversed(range(len(aggs))), sched.applies):
            names = stage_names[i]
            coll = tuple(names[a] for a in app.axes if names[a])
            with obs_profile.stage_scope(app, i):
                if app.norm == "1" and coll:
                    w = _grouped_l1_collective(inputs[i], w, app.axes, coll,
                                               aggs[i], mesh)
                else:
                    w = sched_mod.apply_group(inputs[i], app.norm, w,
                                              app.axes, aggs[i], method)
        return w

    return body


def _resolve_sharded_method(method: str, sched: sched_mod.Schedule, dtype,
                            mesh, device=None) -> str:
    """``method="auto"``: the planner's θ-solver verdict for the replicated
    outer solve's length, timed on rank 0 and broadcast, so that every rank
    solves alike."""
    if method != "auto":
        return ball.resolve_method(method)
    from . import plan as _plan

    return mesh.broadcast_choice(
        sorted(ball.available_methods()),
        lambda: _plan.best_l1_method(sched.solve_size, dtype, device=device))


def multilevel_project_sharded(y: torch.Tensor, levels, radius, *, mesh,
                               spec, shape: Optional[Sequence[int]] = None,
                               method: str = "sort", batch_dims: int = 0,
                               backend: str = "plain") -> torch.Tensor:
    """MP^ν on a mesh: this rank's shard ``y`` in, its projected shard out.

    ``spec`` names the mesh axis of each tensor axis (None = unsharded, or
    a tuple of axes: :func:`parse_spec`); ``shape`` is the global shape (by
    default the padded one, ``y.shape`` times the sharded axes' sizes).
    ``y`` has :func:`~repro_torch.parallel.sharding.local_shape` of it and
    zeros where its slice runs past the end of an axis. The leading
    ``batch_dims`` axes are independent projections (the training hook's
    stacked layers). ``method`` is the θ-solver of the replicated outer
    solve and of local ℓ1 applies (``"auto"``: timed on rank 0); a
    mesh-spanning ℓ1 group always takes the distributed bisection.

    ``backend`` picks the shard-local stages: ``"plain"`` (PyTorch ops) or
    ``"codegen"`` (the generated kernels on a CUDA shard, their plain
    versions on a CPU one); gate ``"codegen"`` with
    ``kernels.codegen.distributed.shardable``, ineligible designs raise.
    Raises without an initialized process group (an ``AbstractMesh``
    needs none: its collectives take meta tensors).
    """
    if not isinstance(mesh, mesh_mod.AbstractMesh):
        mesh_mod.require_process_group("multilevel_project_sharded")
    if backend not in BACKENDS:
        raise ValueError(f"unknown sharded backend {backend!r}: expected one "
                         f"of {BACKENDS}")
    names = parse_spec(spec, y.ndim, mesh)
    padded = tuple(d * entry_size(n, mesh.shape) if n else d
                   for d, n in zip(y.shape, names))
    if shape is not None:
        if local_shape(shape, names, mesh) != tuple(y.shape):
            raise ValueError(
                f"shard {tuple(y.shape)} is not this rank's slice of "
                f"{tuple(shape)} under {names} (want "
                f"{local_shape(shape, names, mesh)})")
        y = _zero_pad_region(y, shape, names, mesh)
    sched = sched_mod.compile_schedule(padded, levels, batch_dims)
    meth = _resolve_sharded_method(method, sched, y.dtype, mesh,
                                   device=y.device.type)
    if backend == "codegen":
        from repro_torch.kernels.codegen import distributed as _dist

        body = _dist.make_codegen_schedule_body(sched, names, mesh, y.dtype,
                                                method=meth, device=y.device)
    else:
        body = make_schedule_body(sched, names, mesh, method=meth)
    return body(y, torch.as_tensor(radius, dtype=y.dtype, device=y.device))


def _zero_pad_region(y, shape, names, mesh):
    """``y`` with zeros wherever this rank's slice runs past ``shape``."""
    cut = []
    for a, (d, n) in enumerate(zip(shape, names)):
        if n:
            valid = d - mesh.axis_index(n) * y.shape[a]
            if valid < y.shape[a]:
                cut.append((a, max(valid, 0)))
    if not cut:
        return y
    y = y.clone()
    for a, valid in cut:
        y.narrow(a, valid, y.shape[a] - valid).zero_()
    return y


# --------------------------------------------------------------------------- #
# The two historical specials — thin wrappers over the schedule body/executor
# --------------------------------------------------------------------------- #


def bilevel_project_sharded(y_local: torch.Tensor, radius, p=1, q="inf", *,
                            axis_name: str, mesh,
                            method: str = "sort") -> torch.Tensor:
    """Bi-level ν = [(q, 1), (p, 1)] on the (n, m_local) shard, columns
    sharded over ``axis_name``; even shards only."""
    sched = sched_mod.compile_schedule(
        (y_local.shape[0], y_local.shape[1] * mesh.shape[axis_name]),
        [(q, 1), (p, 1)])
    body = make_schedule_body(sched, (None, axis_name), mesh, method=method)
    return body(y_local, torch.as_tensor(radius, dtype=y_local.dtype,
                                         device=y_local.device))


def trilevel_project_sharded(y_local: torch.Tensor, radius, *, axis_name: str,
                             mesh, method: str = "sort") -> torch.Tensor:
    """Tri-level ℓ1,∞,∞ on the (c, n, m_local) shard, last axis sharded over
    ``axis_name``; even shards only."""
    c, n, m = y_local.shape
    sched = sched_mod.compile_schedule(
        (c, n, m * mesh.shape[axis_name]), [("inf", 1), ("inf", 1), ("1", 1)])
    body = make_schedule_body(sched, (None, None, axis_name), mesh,
                              method=method)
    return body(y_local, torch.as_tensor(radius, dtype=y_local.dtype,
                                         device=y_local.device))


def _check_divides(m: int, mesh, axis_name: str, what: str) -> None:
    size = mesh.shape[axis_name]
    if m % size:
        raise ValueError(
            f"{what}: sharded axis of extent {m} is not divisible by mesh "
            f"axis {axis_name!r} of size {size} — the per-rank slice of the "
            "outer solve would silently be wrong. Use "
            "multilevel_project_sharded, which takes zero-padded shards.")


def make_sharded_bilevel(mesh, axis_name: str, p=1, q="inf",
                         method: str = "sort"):
    """``fn(y_local, radius, shape)``: the bi-level projection with columns
    (axis 1) sharded over ``axis_name``, through the schedule executor;
    ``shape`` is the global shape, whose columns ``axis_name`` must divide."""
    if method != "auto":
        method = ball.resolve_method(method)  # fail at build time

    def fn(y, radius, shape):
        _check_divides(shape[1], mesh, axis_name, "make_sharded_bilevel")
        return multilevel_project_sharded(
            y, [(q, 1), (p, 1)], radius, mesh=mesh, spec=(None, axis_name),
            shape=shape, method=method)

    return fn


def make_sharded_trilevel(mesh, axis_name: str, method: str = "sort"):
    """``fn(y_local, radius, shape)``: tri-level ℓ1,∞,∞ with the last axis
    sharded over ``axis_name``, through the schedule executor."""
    if method != "auto":
        method = ball.resolve_method(method)

    def fn(y, radius, shape):
        _check_divides(shape[-1], mesh, axis_name, "make_sharded_trilevel")
        return multilevel_project_sharded(
            y, [("inf", 1), ("inf", 1), ("1", 1)], radius, mesh=mesh,
            spec=(None, None, axis_name), shape=shape, method=method)

    return fn


def sharded_collective_bytes(shape, levels, spec, mesh, itemsize: int = 4, *,
                             batch_dims: int = 0) -> dict:
    """Collective payload of this design on this mesh vs gathering the
    tensor (``schedule.sharded_collective_bytes`` on the mesh's sizes)."""
    names = parse_spec(spec, len(shape), mesh)
    return sched_mod.sharded_collective_bytes(
        tuple(shape), levels, names, dict(mesh.shape), itemsize,
        batch_dims=batch_dims)
