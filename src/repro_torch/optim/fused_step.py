"""Fused AdamW-update + multi-level-projection epilogue (port of
``repro/optim/fused_step.py``).

Per leaf, in one sequence: AdamW math (f32) → **project (still f32)** → cast
to the param / master dtype. The projection acts on the f32 *pre-cast*
update; on the f32/no-master path the sequence is operation for operation
the unfused ``adamw.update`` + projection hook.

The JAX package donates the incoming state and params to the step (XLA
reuses their buffers for the outputs); here :func:`fused_update` writes the
new values into the incoming param, moment and master tensors and returns
them, so a training loop holds one live copy of its state.
:func:`make_fused_step` is the single entry ``step(grads, state,
params)``: with ``donate=True`` it updates in place, with ``donate=False``
it leaves the caller's params and state untouched and returns new ones.
int8 block-quantized moments (``moment_dtype="int8"``) dequantize, update
and requantize inside the same per-leaf pass.

The θ-solver resolution reuses the projection hook's resolver, so a fused
step and the standalone hook always agree on solvers.
"""

from __future__ import annotations

import torch

from repro_torch import _tree
from repro_torch.configs.types import ProjectionSpec, TrainConfig

from . import adamw
from .projection_hook import _matches, _method_resolver, _project_leaf


def fused_update(grads, state, params, cfg: TrainConfig,
                 spec: ProjectionSpec | None = None):
    """One fused AdamW+project step: ``(params, state, metrics)``.

    The math of :func:`repro_torch.optim.adamw.update`, but every leaf
    matching ``spec.pattern`` is projected onto the multi-level ball before
    the param/master casts, and the results are written into ``params``
    and ``state`` in place (their old values are dead after the step).
    ``spec`` defaults to ``cfg.projection``; a disabled or absent spec gives
    a plain AdamW step.
    """
    if spec is None:
        spec = cfg.projection
    on = spec is not None and spec.enabled
    step = state["step"] + 1
    gnorm, clip = adamw.grad_clip_factor(grads, cfg)
    one_leaf = adamw.make_leaf_update(cfg, step, clip)
    match = _matches(spec) if on else None
    resolve = _method_resolver(spec) if on else None
    project_now = on and (spec.every <= 1 or int(step) % spec.every == 0)

    master = state.get("master")
    src = master if master is not None else params
    flat_g = _tree.leaves_with_paths(grads)
    flat = zip(flat_g, _tree.leaves_up_to(grads, state["m"]),
               _tree.leaves_up_to(grads, state["v"]), _tree.leaves(src),
               _tree.leaves(params))
    for (name, g), m, v, ps, p in flat:
        pnew, mq, vq = one_leaf(g, m, v, ps)
        if project_now and match(name, pnew):
            pnew = _project_leaf(pnew, spec.levels, spec.radius,
                                 resolve(pnew.shape, pnew.dtype, pnew.device),
                                 transpose=spec.transpose)
        p.copy_(pnew)
        adamw._assign(m, mq)
        adamw._assign(v, vq)
        if master is not None:
            ps.copy_(pnew)
    state["step"].add_(1)
    metrics = {"grad_norm": gnorm, "lr": adamw.lr_schedule(step, cfg)}
    return params, state, metrics


def make_fused_step(cfg: TrainConfig, spec: ProjectionSpec | None = None, *,
                    donate: bool = True):
    """Single entry ``step(grads, state, params) -> (params, state,
    metrics)`` of :func:`fused_update`.

    ``donate=True`` (the incoming state and params are dead after the
    step) writes the outputs into them, one live copy of the state;
    ``donate=False`` leaves the caller's params and state as they were and
    returns new tensors.
    """
    def step(grads, state, params):
        if not donate:
            state = _tree.tree_map(torch.clone, state)
            params = _tree.tree_map(torch.clone, params)
        return fused_update(grads, state, params, cfg, spec)

    return step

