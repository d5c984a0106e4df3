"""AdamW from scratch with float32 moments (port of ``repro/optim/adamw.py``).

The schedule and the per-leaf update follow the JAX package operation for
operation (python scalars against float32 tensors, as JAX's weak types
compute), so the port's steps match the reference's to float32 rounding. The int8 block-quantized moments (``moment_dtype="int8"``)
wait for a later slice; asking for them raises.

Under a mesh (``mesh=``, ``param_specs=``) the trees hold this rank's
shards: :func:`global_norm` psums each leaf's squared norm over the axes
it is sharded on (a replicated leaf counts once), and the weight-decay
rule reads each leaf's full shape.
"""

from __future__ import annotations

import math

import torch

from repro_torch import _tree
from repro_torch.configs.types import TrainConfig
from repro_torch.parallel import collectives, sharding


def _check(cfg: TrainConfig) -> None:
    if cfg.moment_dtype != "float32":
        raise ValueError(f"moment_dtype {cfg.moment_dtype!r}: the port keeps "
                         "float32 moments; int8 block-quantized moments wait "
                         "for a later slice")


# ------------------------------------------------------------------- schedule
def lr_schedule(step: torch.Tensor, cfg: TrainConfig) -> torch.Tensor:
    """Linear warmup then cosine to 0.1·lr; ``step`` is a 0-d tensor, the
    result a 0-d float32 tensor on its device."""
    s = step.float()
    warm = torch.clamp(s / max(cfg.warmup, 1), max=1.0)
    prog = torch.clamp((s - cfg.warmup) / max(cfg.total_steps - cfg.warmup, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


# ---------------------------------------------------------------------- state
def init(params, cfg: TrainConfig):
    """Optimizer state tree mirroring params: ``{"step", "m", "v"[, "master"]}``."""
    _check(cfg)
    dev = _tree.leaves(params)[0].device
    state = {
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        "m": _tree.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                  device=p.device), params),
        "v": _tree.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                  device=p.device), params),
    }
    if cfg.master_dtype and cfg.master_dtype != cfg.param_dtype:
        mdt = getattr(torch, cfg.master_dtype)
        state["master"] = _tree.tree_map(lambda p: p.to(mdt), params)
    return state


def state_specs(param_specs_tree, params_template, cfg: TrainConfig):
    """Specs tree matching :func:`init`'s structure: each float32 moment
    takes its parameter's spec, the step is replicated."""
    _check(cfg)
    out = {"step": (), "m": param_specs_tree, "v": param_specs_tree}
    if cfg.master_dtype and cfg.master_dtype != cfg.param_dtype:
        out["master"] = param_specs_tree
    return out


# --------------------------------------------------------------------- update
def global_norm(tree, mesh=None, param_specs=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares; under a mesh, each group of
    leaves sharded on the same live axes is psummed over them once (a
    replicated leaf counts once), the groups in a fixed order, so every
    rank gets the same bits."""
    if mesh is None:
        sums = [x.float().square().sum() for x in _tree.leaves(tree)]
        return torch.sqrt(torch.stack(sums).sum())
    groups = {}
    for x, sp in zip(_tree.leaves(tree), _tree.leaves(param_specs)):
        axes = collectives.live_axes(mesh, sharding.spec_axes(sp))
        groups.setdefault(axes, []).append(x.float().square().sum())
    total = None
    for axes in sorted(groups):
        part = collectives.psum(torch.stack(groups[axes]).sum(), mesh, axes)
        total = part if total is None else total + part
    return torch.sqrt(total)


def grad_clip_factor(grads, cfg: TrainConfig, mesh=None, param_specs=None):
    """(gnorm, clip): the global-norm clip multiplier shared by both steps."""
    gnorm = global_norm(grads, mesh, param_specs)
    if not cfg.grad_clip:
        return gnorm, torch.ones_like(gnorm)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    return gnorm, clip


def make_leaf_update(cfg: TrainConfig, step: torch.Tensor, clip):
    """Build the per-leaf AdamW update ``one_leaf(g, m, v, p) -> (pnew, m', v')``
    shared by :func:`update` and the fused projected step
    (``optim/fused_step.py``). ``pnew`` comes back in f32 — casting to the
    param/master dtype is the caller's epilogue, which is what lets the
    fused step slot the projection in before the cast. Elementwise, so it
    runs on a stacked leaf whole (the JAX package maps over its leading
    axis only to bound a giant model's working set)."""
    _check(cfg)
    lr = lr_schedule(step, cfg)
    b1, b2, eps = cfg.beta1, cfg.beta2, cfg.eps
    # python scalars against float32 tensors, as JAX's weak types compute
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()

    def one_leaf(g, m, v, p, shape=None):
        """``shape``: the leaf's full shape where ``p`` is a shard of it."""
        gf = g.float() * clip
        pf = p.float()
        mf = b1 * m + (1 - b1) * gf
        vf = b2 * v + (1 - b2) * gf * gf
        upd = (mf / bc1) / (torch.sqrt(vf / bc2) + eps)
        # decay true matrices only (stacked norm scales (L, d) are exempt)
        shape = p.shape if shape is None else shape
        if p.ndim >= 2 and min(shape[-2:]) >= 64 and cfg.weight_decay:
            upd = upd + cfg.weight_decay * pf
        return pf - lr * upd, mf, vf

    return one_leaf


def update(grads, state, params, cfg: TrainConfig, *, mesh=None,
           param_specs=None, inplace: bool = False):
    """One AdamW step. Returns (new_params, new_state, metrics); the inputs
    are left as they were, or, with ``inplace``, the new values are written
    into ``params`` and ``state`` leaf by leaf and those are returned (as
    the JAX package's donated step; one leaf's temporaries at a time).
    ``mesh``/``param_specs``: the trees are this rank's shards (module
    docstring)."""
    step = state["step"] + 1
    gnorm, clip = grad_clip_factor(grads, cfg, mesh, param_specs)
    one_leaf = make_leaf_update(cfg, step, clip)
    master = state.get("master")
    src = master if master is not None else params
    srcs = _tree.leaves(src)
    shapes = [None] * len(srcs) if mesh is None else [
        sharding.global_shape(p.shape, sp, mesh)
        for p, sp in zip(srcs, _tree.leaves(param_specs))]
    flat = list(zip(_tree.leaves(grads), _tree.leaves(state["m"]),
                    _tree.leaves(state["v"]), srcs, shapes,
                    _tree.leaves(params)))
    metrics = {"grad_norm": gnorm, "lr": lr_schedule(step, cfg)}
    if inplace:
        for g, m, v, ps, shape, p in flat:
            pnew, mq, vq = one_leaf(g, m, v, ps, shape)
            m.copy_(mq)
            v.copy_(vq)
            p.copy_(pnew)
            if master is not None:
                ps.copy_(pnew)
        state["step"].add_(1)
        return params, state, metrics
    outs = [one_leaf(g, m, v, ps, shape) for g, m, v, ps, shape, _ in flat]
    new_src = _tree.unflatten_like(grads, [o[0] for o in outs])
    new_state = {"step": step,
                 "m": _tree.unflatten_like(grads, [o[1] for o in outs]),
                 "v": _tree.unflatten_like(grads, [o[2] for o in outs])}
    if master is not None:
        new_state["master"] = _tree.tree_map(lambda x, m: x.to(m.dtype),
                                             new_src, master)
    new_params = _tree.tree_map(lambda x, p: x.to(p.dtype), new_src, params)
    return new_params, new_state, metrics
