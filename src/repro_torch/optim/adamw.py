"""AdamW from scratch, with float32 or int8 block-quantized moments (port
of ``repro/optim/adamw.py``).

The schedule and the per-leaf update follow the JAX package operation for
operation (python scalars against float32 tensors, as JAX's weak types
compute), so the port's steps match the reference's to float32 rounding.

``moment_dtype="int8"`` stores m and v as int8 with a float32 scale per
256-element block of the trailing axis (:func:`quantize_blockwise`: linear
symmetric for m, linear positive for v, which is kept in the square-root
domain): dequantize → float32 update → requantize every step. A
layer-stacked leaf (three axes or more) updates one layer slice at a time,
as the JAX package maps over it, which bounds the float32 working set to
one layer.

Under a mesh (``mesh=``, ``param_specs=``) the trees hold this rank's
shards: :func:`global_norm` psums each leaf's squared norm over the axes
it is sharded on (a replicated leaf counts once), and the weight-decay
rule reads each leaf's full shape. An int8 moment quantizes this rank's
shard, which equals the global quantization only where the trailing axis
is not sharded or its per-rank extent is a multiple of 256; :func:`update`
raises on any other leaf (:func:`check_int8_mesh`), whether its state came
from :func:`init` or from a checkpoint, and the block scales shard with
the trailing axis.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import _tree
from repro_torch.configs.types import TrainConfig
from repro_torch.parallel import collectives, sharding

_BLOCK = 256
_MOMENT_DTYPES = ("float32", "int8")


def _check(cfg: TrainConfig) -> None:
    if cfg.moment_dtype not in _MOMENT_DTYPES:
        raise ValueError(f"moment_dtype {cfg.moment_dtype!r}: the port keeps "
                         f"moments in one of {_MOMENT_DTYPES}")


# ------------------------------------------------------------- int8 moments
def _pad_to_block(n: int) -> int:
    return -(-n // _BLOCK) * _BLOCK


def quantize_blockwise(x: torch.Tensor, signed: bool = True):
    """x (...) float32 -> ``{"q": int8 (..., n padded to 256), "s": float32
    scales (..., n_blocks)}``; the trailing axis is blocked. Rounds half to
    even, as ``jnp.round``."""
    shape = tuple(x.shape)
    n = shape[-1]
    npad = _pad_to_block(n)
    xp = F.pad(x, (0, npad - n)) if npad != n else x
    xb = xp.reshape(shape[:-1] + (npad // _BLOCK, _BLOCK))
    s = (xb.abs() if signed else xb).amax(dim=-1, keepdim=True) / 127.0
    s = torch.clamp(s, min=1e-12)
    q = torch.clamp(torch.round(xb / s), -127, 127).to(torch.int8)
    return {"q": q.reshape(shape[:-1] + (npad,)), "s": s[..., 0].float()}


def dequantize_blockwise(qs, n: int) -> torch.Tensor:
    """The float32 tensor of ``quantize_blockwise``'s ``qs``, its trailing
    axis cut back to ``n``."""
    q, s = qs["q"], qs["s"]
    shape = tuple(q.shape)
    xb = q.reshape(shape[:-1] + (shape[-1] // _BLOCK, _BLOCK)).float()
    return (xb * s[..., None]).reshape(shape)[..., :n]


def check_int8_mesh(shapes, param_specs, mesh) -> None:
    """Raise unless every leaf's int8 moments quantize the same blocks on
    each rank as on one device: its trailing axis is not sharded on
    ``mesh`` (a mesh or a ``{name: size}`` mapping), or its per-rank extent
    is a multiple of 256. ``shapes``: the leaves' full shapes, a tree of
    the ``param_specs`` structure or a list in its leaf order."""
    sizes = sharding.mesh_shape_dict(mesh)
    flat = shapes if isinstance(shapes, list) else _tree.leaves(shapes)
    for (name, sp), shape in zip(_tree.leaves_with_paths(param_specs), flat):
        shape = tuple(shape)
        if not shape:
            continue
        entry = tuple(sp)[len(shape) - 1] if len(tuple(sp)) == len(shape) \
            else None
        names = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        ranks = math.prod(sizes.get(a, 1) for a in names)
        local = -(-shape[-1] // ranks)
        if ranks > 1 and local % _BLOCK:
            raise ValueError(
                f"{name}: int8 moments quantize each rank's shard in blocks "
                f"of {_BLOCK} along the trailing axis, which equals the "
                f"global quantization only when that axis is unsharded or "
                f"its per-rank extent is a multiple of {_BLOCK}; here "
                f"{shape[-1]} over {ranks} ranks gives {local}")


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
    """Optimizer state tree mirroring params: ``{"step", "m", "v"[,
    "master"]}``; an int8 moment is ``{"q", "s"}`` where params has a
    tensor."""
    _check(cfg)
    quant = cfg.moment_dtype == "int8"
    dev = _tree.leaves(params)[0].device

    def mom(p):
        z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return quantize_blockwise(z) if quant else z

    state = {
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        "m": _tree.tree_map(mom, params),
        "v": _tree.tree_map(mom, params),
    }
    if cfg.master_dtype and cfg.master_dtype != cfg.param_dtype:
        mdt = getattr(torch, cfg.master_dtype)
        state["master"] = _tree.tree_map(lambda p: p.to(mdt), params)
    return state


def state_specs(param_specs_tree, params_template, cfg: TrainConfig):
    """Specs tree matching :func:`init`'s structure: each float32 moment
    takes its parameter's spec, the step is replicated. An int8 moment's
    ``q`` takes the parameter's spec and its block scales ``s`` too (each
    rank holds the scales of its own blocks; the JAX package replicates
    their trailing axis, which GSPMD quantizes globally)."""
    _check(cfg)
    quant = cfg.moment_dtype == "int8"
    mom = (_tree.tree_map(lambda sp: {"q": sp, "s": sp}, param_specs_tree)
           if quant else param_specs_tree)
    out = {"step": (), "m": mom, "v": mom}
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


def _at(qs, i):
    """Layer slice ``i`` of an int8 moment."""
    return {"q": qs["q"][i], "s": qs["s"][i]}


_SLICE = 1 << 25   # elements of a leaf that an in-place update takes at a time


def _slices(p: torch.Tensor) -> list:
    """Indices of ``p`` that an in-place update takes in turn: slices of its
    leading axis of at most ``_SLICE`` elements, or the whole leaf where it
    is smaller or has no leading axis to cut."""
    if p.ndim == 0 or p.numel() <= _SLICE or p.shape[0] == 1:
        return [...]
    rows = max(1, _SLICE * p.shape[0] // p.numel())
    return [slice(i, i + rows) for i in range(0, p.shape[0], rows)]


def _assign(dst, src) -> None:
    """Write a moment (a tensor, or an int8 ``{"q", "s"}``) in place."""
    if isinstance(dst, dict):
        dst["q"].copy_(src["q"])
        dst["s"].copy_(src["s"])
    else:
        dst.copy_(src)


def make_leaf_update(cfg: TrainConfig, step: torch.Tensor, clip):
    """Build the per-leaf AdamW update ``one_leaf(g, m, v, p) -> (pnew, m', v')``
    shared by :func:`update` and the fused projected step
    (``optim/fused_step.py``). ``pnew`` comes back in f32 — casting to the
    param/master dtype is the caller's epilogue, which is what lets the
    fused step slot the projection in before the cast. Elementwise, so a
    float32-moment leaf runs whole (the JAX package maps over its leading
    axis only to bound a giant model's working set); an int8-moment leaf of
    three axes or more runs one layer slice at a time, as JAX's does."""
    _check(cfg)
    lr = lr_schedule(step, cfg)
    b1, b2, eps = cfg.beta1, cfg.beta2, cfg.eps
    # python scalars against float32 tensors, as JAX's weak types compute
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()
    quant = cfg.moment_dtype == "int8"

    def one(g, m, v, p, shape):
        gf = g.float() * clip
        pf = p.float()
        # v is stored int8 in the SQRT domain: linear int8 underflows small
        # second moments inside a block and m/sqrt(v) then explodes
        mf = dequantize_blockwise(m, p.shape[-1]) if quant else m
        vf = dequantize_blockwise(v, p.shape[-1]) ** 2 if quant else v
        mf = b1 * mf + (1 - b1) * gf
        vf = b2 * vf + (1 - b2) * gf * gf
        upd = (mf / bc1) / (torch.sqrt(vf / bc2) + eps)
        # decay true matrices only (stacked norm scales (L, d) are exempt)
        if p.ndim >= 2 and min(shape[-2:]) >= 64 and cfg.weight_decay:
            upd = upd + cfg.weight_decay * pf
        if quant:
            return (pf - lr * upd, quantize_blockwise(mf),
                    quantize_blockwise(torch.sqrt(vf), signed=False))
        return pf - lr * upd, mf, vf

    def one_leaf(g, m, v, p, shape=None):
        """``shape``: the leaf's full shape where ``p`` is a shard of it."""
        shape = tuple(p.shape if shape is None else shape)
        if not (quant and p.ndim >= 3 and p.shape[0] > 1):
            return one(g, m, v, p, shape)
        # one layer slice at a time: each slice's moments are read before
        # its results land, so the outputs are filled slice by slice
        pnew = torch.empty(p.shape, dtype=torch.float32, device=p.device)
        mq = {k: torch.empty_like(t) for k, t in m.items()}
        vq = {k: torch.empty_like(t) for k, t in v.items()}
        for i in range(p.shape[0]):
            a, b, c = one(g[i], _at(m, i), _at(v, i), p[i], shape[1:])
            pnew[i] = a
            _assign(_at(mq, i), b)
            _assign(_at(vq, i), c)
        return pnew, mq, vq

    return one_leaf


def update(grads, state, params, cfg: TrainConfig, *, mesh=None,
           param_specs=None, inplace: bool = False):
    """One AdamW step. Returns (new_params, new_state, metrics); the inputs
    are left as they were, or, with ``inplace``, the new values are written
    into ``params`` and ``state`` leaf by leaf and those are returned (as
    the JAX package's donated step; the temporaries of one leaf, or of one
    slice of a large float32-moment leaf's leading axis, at a time).
    ``mesh``/``param_specs``: the trees are this rank's shards (module
    docstring); int8 moments are held to :func:`check_int8_mesh` first."""
    master = state.get("master")
    src = master if master is not None else params
    srcs = _tree.leaves(src)
    shapes = [None] * len(srcs) if mesh is None else [
        sharding.global_shape(p.shape, sp, mesh)
        for p, sp in zip(srcs, _tree.leaves(param_specs))]
    if mesh is not None and cfg.moment_dtype == "int8":
        check_int8_mesh(shapes, param_specs, mesh)
    step = state["step"] + 1
    gnorm, clip = grad_clip_factor(grads, cfg, mesh, param_specs)
    one_leaf = make_leaf_update(cfg, step, clip)
    flat = list(zip(_tree.leaves(grads), _tree.leaves_up_to(grads, state["m"]),
                    _tree.leaves_up_to(grads, state["v"]), srcs, shapes,
                    _tree.leaves(params)))
    metrics = {"grad_norm": gnorm, "lr": lr_schedule(step, cfg)}
    if inplace:
        for g, m, v, ps, shape, p in flat:
            # a float32-moment leaf in slices of its leading axis: each
            # slice's temporaries live only while its results land
            quant = isinstance(m, dict)
            for i in [...] if quant else _slices(ps):
                mi, vi = (m, v) if quant else (m[i], v[i])
                pnew, mq, vq = one_leaf(g[i], mi, vi, ps[i], shape)
                _assign(mi, mq)
                _assign(vi, vq)
                p[i].copy_(pnew)
                if master is not None:
                    ps[i].copy_(pnew)
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
