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
schedule: no kernel. The mesh-native sharded path (``mesh=``,
``param_specs=``) waits for the mesh executor, and ``method="auto"`` for the
planner's ``best_l1_method``.
"""

from __future__ import annotations

import re

import torch

from repro_torch import _tree
from repro_torch.configs.types import ProjectionSpec
from repro_torch.core import ball, schedule as sched_mod
from repro_torch.core.masks import sparsity


def _method_resolver(spec: ProjectionSpec):
    """Per-leaf θ-solver resolution, done once per hook: a fixed name is
    validated through the registry immediately (config errors surface
    once)."""
    if spec.method == "auto":
        raise ValueError("method='auto' needs the planner's best_l1_method, "
                         "which the port has not ported yet; name a solver "
                         f"({', '.join(ball.available_methods())})")
    method = ball.resolve_method(spec.method)
    return lambda shape, dtype: method


def _project_leaf(w: torch.Tensor, levels, radius, method: str,
                  transpose: bool = False) -> torch.Tensor:
    """Project the trailing axes of ``w``; leading axes are batch axes."""
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


def _matches(spec: ProjectionSpec):
    pat = re.compile(spec.pattern)
    need = sum(k for _, k in spec.levels)
    return lambda name, w: w.ndim >= need and pat.search(name) is not None


def _projector(spec: ProjectionSpec):
    """``project_all(params)``: every matched leaf projected, the rest as
    they are. The regex compiles and the solver validates here, once."""
    match = _matches(spec)
    resolve = _method_resolver(spec)

    def one(name, w):
        if match(name, w):
            return _project_leaf(w, spec.levels, spec.radius,
                                 resolve(w.shape, w.dtype),
                                 transpose=spec.transpose).to(w.dtype)
        return w

    return lambda params: _tree.map_with_path(one, params)


def make_projection_hook(spec: ProjectionSpec | None):
    """Build the training-time projection hook once and return
    ``hook(params, step) -> params``. ``step`` is an int or a 0-d tensor;
    off-cadence steps return ``params`` untouched."""
    if spec is None or not spec.enabled:
        return lambda params, step: params
    project_all = _projector(spec)

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
            for name, w in _tree.leaves_with_paths(params) if match(name, w)}
