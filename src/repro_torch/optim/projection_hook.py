"""The paper's technique as a training feature (port of
``repro/optim/projection_hook.py``, single-device part).

``apply_projection(params, spec, step)`` applies the multi-level projection
(``core.multilevel``) to every parameter whose path matches ``spec.pattern``,
every ``spec.every`` steps.

The projection operates on the TRAILING ``sum(k for _, k in levels)`` axes of
each matched leaf; leading axes ('layers', 'experts' stacks) are batch axes
of one schedule execution (the JAX package vmaps over them): each slice is
projected independently. ``spec.transpose`` projects the reversed trailing
axes (groups = rows, e.g. SAE feature selection).

The projection runs the plain schedule executor (``core.schedule.execute``)
in PyTorch ops on the leaf's device, as the JAX training step runs its jnp
schedule: no kernel.

Passing ``mesh=`` and ``param_specs=`` to :func:`make_projection_hook` makes
the projection mesh-native: the parameters are this rank's shards
(``parallel.sharding.shard``), and every matched leaf whose projected
(trailing) axes are sharded runs the mesh executor
(``core.sharded.multilevel_project_sharded``) in place — collective reduces
of the aggregates, a gathered small outer solve, local applies — with its
leading stacked axes as batch dims. On a CUDA leaf whose design
``kernels.codegen.distributed.shardable`` accepts, the shard-local stages
are the generated kernels. Leaves with unsharded trailing axes (or without
specs) keep the single-device path.

``method="auto"`` is resolved once per hook and per (final-level length,
dtype, device) through the planner's ``best_l1_method`` on the leaf's
device, and memoised; on a sharded leaf rank 0's verdict is broadcast.
"""

from __future__ import annotations

import re

import torch

from repro_torch import _tree
from repro_torch.configs.types import ProjectionSpec
from repro_torch.core import ball, multilevel, schedule as sched_mod, sharded
from repro_torch.core.masks import sparsity
from repro_torch.parallel.sharding import entry_size

SHARD_BACKENDS = ("auto",) + sharded.BACKENDS


def _method_resolver(spec: ProjectionSpec):
    """Per-leaf θ-solver resolution, done once per hook.

    A fixed name is validated through the registry immediately (config
    errors surface once). ``"auto"`` returns ``resolve(shape, dtype,
    device, mesh=None)``: the planner's ``best_l1_method`` for the final
    level's length of the leaf's trailing axes (reversed under
    ``transpose``), memoised per (length, dtype, device). With ``mesh`` (a
    sharded leaf, ``shape`` its global shape) rank 0 times and broadcasts,
    so that every rank solves alike.
    """
    if spec.method != "auto":
        method = ball.resolve_method(spec.method)
        return lambda shape, dtype, device, mesh=None: method
    from repro_torch.core import plan as planmod

    need = sum(k for _, k in spec.levels)
    cache = {}

    def resolve(shape, dtype, device, mesh=None):
        trailing = tuple(shape[len(shape) - need:])
        if spec.transpose:
            trailing = trailing[::-1]
        n_final = multilevel._final_level_size(trailing, spec.levels)
        key = (n_final, planmod.dtype_name(dtype), torch.device(device).type,
               mesh is not None)
        if key not in cache:
            def pick():
                return planmod.best_l1_method(n_final, dtype, device=key[2])

            cache[key] = pick() if mesh is None else mesh.broadcast_choice(
                sorted(ball.available_methods()), pick)
        return cache[key]

    return resolve


def _project_leaf(w: torch.Tensor, levels, radius, method: str,
                  transpose: bool = False) -> torch.Tensor:
    """Project the trailing axes of ``w``; leading axes are batch axes. An
    empty leaf (a stack cut to no layers) is its own projection."""
    if not w.numel():
        return w
    need = sum(k for _, k in levels)
    batch = w.ndim - need
    perm = None
    if transpose:
        perm = tuple(range(batch)) + tuple(reversed(range(batch, w.ndim)))
        w = w.permute(perm)
    sched = sched_mod.compile_schedule(w.shape, levels, batch)
    x = sched_mod.execute(w, sched, radius, method=method)
    if perm is not None:
        x = x.permute(perm)  # reversing the trailing axes is an involution
    return x.contiguous()


def _resolve_shard_backend(backend: str, shape, levels, names, mesh, dtype,
                           batch_dims: int, device: torch.device) -> str:
    """Pick the mesh executor's shard-local stages for one sharded leaf.

    ``"auto"`` lowers them through the generated kernels when the leaf is
    on a CUDA device and ``shardable`` accepts the design (a function of
    shapes alone, so every rank picks alike); otherwise the plain body —
    the same collective plan without the kernels."""
    if backend != "auto":
        return backend
    if device.type != "cuda":
        return "plain"
    from repro_torch.kernels.codegen import distributed as _dist

    ok = _dist.shardable(shape, list(levels), names, mesh, dtype, batch_dims)
    return "codegen" if ok else "plain"


def _sharded_leaf_names(mesh, pspec, ndim: int, need: int):
    """The leaf's per-axis mesh axis names IF the mesh executor should run
    it: some trailing (projected) axis sharded and the spec representable
    (``plan.canonical_sharding`` is the one parser of specs)."""
    if pspec is None:
        return None
    from repro_torch.core import plan as planmod

    key = planmod.canonical_sharding((mesh, pspec), ndim)
    if key is None or not any(n is not None for n in key.spec[ndim - need:]):
        return None
    return key.spec


def _project_leaf_sharded(w: torch.Tensor, spec: ProjectionSpec, radius,
                          method: str, mesh, names,
                          backend: str = "auto") -> torch.Tensor:
    """Project this rank's shard ``w`` of one leaf in place through the
    mesh executor: leading stacked axes are batch dims, and the weight is
    never gathered. ``names`` are the per-axis mesh axis names."""
    need = sum(k for _, k in spec.levels)
    batch = w.ndim - need
    perm = None
    if spec.transpose:
        # reverse the projected axes (an involution: the same permutation
        # restores the layout) and the names with them
        perm = tuple(range(batch)) + tuple(reversed(range(batch, w.ndim)))
        w = w.permute(perm).contiguous()
        names = tuple(names[a] for a in perm)
    padded = tuple(d * entry_size(n, mesh.shape) if n else d
                   for d, n in zip(w.shape, names))
    be = _resolve_shard_backend(backend, padded, spec.levels, names, mesh,
                                w.dtype, batch, w.device)
    x = sharded.multilevel_project_sharded(
        w, list(spec.levels), radius, mesh=mesh, spec=names, method=method,
        batch_dims=batch, backend=be)
    if perm is not None:
        x = x.permute(perm)
    return x.contiguous()


def _spec_table(param_specs):
    """Path string → spec of a spec tree (tuples are leaves)."""
    if param_specs is None:
        return {}
    return dict(_tree.leaves_with_paths(param_specs))


def _matches(spec: ProjectionSpec):
    pat = re.compile(spec.pattern)
    need = sum(k for _, k in spec.levels)
    return lambda name, w: w.ndim >= need and pat.search(name) is not None


def _projector(spec: ProjectionSpec, mesh=None, param_specs=None,
               backend: str = "auto"):
    """``project_all(params)``: every matched leaf projected, the rest as
    they are. The regex compiles and the solver validates here, once."""
    match = _matches(spec)
    resolve = _method_resolver(spec)
    need = sum(k for _, k in spec.levels)
    specs_by_path = _spec_table(param_specs) if mesh is not None else {}

    def one(name, w):
        if match(name, w) and w.numel():   # an empty leaf is its own projection
            names = None
            if mesh is not None:
                names = _sharded_leaf_names(mesh, specs_by_path.get(name),
                                            w.ndim, need)
            if names is not None:
                padded = tuple(d * entry_size(n, mesh.shape) if n else d
                               for d, n in zip(w.shape, names))
                method = resolve(padded, w.dtype, w.device, mesh)
                return _project_leaf_sharded(
                    w, spec, spec.radius, method, mesh, names,
                    backend=backend).to(w.dtype)
            method = resolve(w.shape, w.dtype, w.device)
            return _project_leaf(w, spec.levels, spec.radius, method,
                                 transpose=spec.transpose).to(w.dtype)
        return w

    return lambda params: _tree.map_with_path(one, params)


def make_projection_hook(spec: ProjectionSpec | None, *, mesh=None,
                         param_specs=None, backend: str = "auto"):
    """Build the training-time projection hook once and return
    ``hook(params, step) -> params``. ``step`` is an int or a 0-d tensor;
    off-cadence steps return ``params`` untouched.

    With ``mesh`` (a ``parallel.mesh.Mesh``) and ``param_specs`` (the spec
    tree of ``models.params.param_specs``), ``params`` are this rank's
    shards and every matched leaf whose projected axes are sharded runs the
    mesh executor in place. ``backend`` picks its shard-local stages:
    ``"auto"`` (the generated kernels on an eligible CUDA leaf, else the
    plain body), ``"plain"`` or ``"codegen"`` — both run the same
    collective plan."""
    if backend not in SHARD_BACKENDS:
        raise ValueError(f"unknown backend {backend!r}: expected one of "
                         f"{SHARD_BACKENDS}")
    if spec is None or not spec.enabled:
        return lambda params, step: params
    project_all = _projector(spec, mesh, param_specs, backend)

    def hook(params, step):
        if spec.every <= 1 or int(step) % spec.every == 0:
            return project_all(params)
        return params

    return hook


def project_tree(params, spec: ProjectionSpec):
    """Unconditionally project matched leaves."""
    return _projector(spec)(params)


def apply_projection(params, spec: ProjectionSpec, step):
    """Project every ``spec.every`` steps. One-shot form of
    :func:`make_projection_hook` — prefer the hook in loops."""
    return make_projection_hook(spec)(params, step)


def matched_names(params, spec: ProjectionSpec):
    """List of projected parameter paths (for logging/tests)."""
    match = _matches(spec)
    return [name for name, w in _tree.leaves_with_paths(params)
            if hasattr(w, "ndim") and match(name, w)]


def tree_sparsity(params, spec: ProjectionSpec):
    """Column-sparsity % of each projected leaf (paper's metric, per tensor)."""
    match = _matches(spec)
    return {name: sparsity(w.reshape(-1, w.shape[-1]), axis=0)
            for name, w in _tree.leaves_with_paths(params)
            if match(name, w) and w.numel()}
