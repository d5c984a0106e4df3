"""Sharding rules: logical axes → mesh axes (port of
``repro/parallel/sharding.py``), and the helpers that go between a full
tensor (or tree) and one rank's shard.

Mesh axes: ("data", "model") single-pod, ("pod", "data", "model")
multi-pod. Policy: tensor parallelism over 'model' for heads / kv_heads /
ffn / experts / vocab / ssm_in; FSDP over 'data' on the 'embed' (d_model)
axis of every weight when ``fsdp`` (replicated across pods); the batch
over ('pod', 'data'). A spec is a tuple with one entry per tensor axis: a
mesh axis name, a tuple of them (the axis sharded over their product,
the first major) or None (the port's ``PartitionSpec``).

:func:`cache_spec_tree` gives the specs of any family's decode cache (or
recurrent state) from its leaves' shapes.

A rank holds the ceil-division slice of each sharded axis; the last ranks'
slices run past the end of the axis and hold zeros there, exactly the
zero-padding ``core.sharded.multilevel_project_sharded`` works on (zeros
are fixed points of every level of a norm design).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch import _tree

from .mesh import rank_coords


def mesh_shape_dict(mesh) -> Dict[str, int]:
    """Axis name → size of a :class:`~repro_torch.parallel.mesh.Mesh`, or of
    a plain ``{name: size}`` mapping (in mesh order)."""
    return dict(mesh.shape) if hasattr(mesh, "shape") else dict(mesh)


def batch_axes(mesh) -> tuple:
    """Mesh axes the batch dim shards over."""
    return ("pod", "data") if "pod" in mesh_shape_dict(mesh) else ("data",)


def dp_shards(mesh) -> int:
    shp = mesh_shape_dict(mesh)
    return math.prod(shp[a] for a in batch_axes(mesh))


def param_rules(mesh, *, fsdp: bool = True) -> Dict[str, object]:
    """logical axis -> mesh axis for parameters."""
    return {
        "heads": "model",
        "kv_heads": "model",
        "ffn": "model",
        "expert_ff": None,       # experts already consume 'model'
        "experts": "model",
        "vocab": "model",
        "ssm_in": "model",
        "embed": "data" if fsdp else None,
        "layers": None,
        "super": None,
    }


def act_rules(mesh, shape=None) -> Dict[str, object]:
    """logical axis -> mesh axis for activations (``shape`` is unused, as
    in the JAX package)."""
    b_ax = batch_axes(mesh)
    return {"batch": b_ax[0] if len(b_ax) == 1 else b_ax, "cache_seq": "model"}


def _shardable(dim: int, axes, shp) -> Optional[object]:
    if axes is None:
        return None
    t = axes if isinstance(axes, tuple) else (axes,)
    return axes if dim % math.prod(shp[a] for a in t) == 0 else None


def _batch_entry(mesh, n: int):
    """The mesh axes a batch of ``n`` shards over: ('pod', 'data') when it
    divides, 'data' as the fallback, else None (replicated)."""
    shp = mesh_shape_dict(mesh)
    cand = batch_axes(mesh)
    ax = _shardable(n, cand if len(cand) > 1 else cand[0], shp)
    if ax is None and len(cand) > 1:
        ax = _shardable(n, cand[1], shp)
    return ax


def batch_spec(mesh, global_batch: int, extra_dims: int = 1) -> tuple:
    """Spec for (batch, ...) arrays — shards batch over ('pod','data') when
    it divides, over ('data',) as fallback, else replicates (B=1)."""
    return (_batch_entry(mesh, global_batch),) + (None,) * extra_dims


def tokens_spec(mesh, shape, microbatch: int) -> tuple:
    """(n_micro, micro_global, seq) training batch."""
    return (None, _batch_entry(mesh, microbatch), None)


def cache_spec_tree(cfg, mesh, cache_tree, shape):
    """Specs for a decode cache tree (``make_cache`` of any family, e.g.
    built on ``meta``): the batch dim over the batch axes, the cache's
    length over "model". ``cfg`` is unused, as in the JAX package.

    Per leaf: the leading axis is a layer stack (replicated); the first
    later axis of ``shape.global_batch`` entries is the batch, sharded over
    ('pod', 'data') where that divides it, else over 'data'; the axis right
    after it, if at least 1024 long and divisible by the "model" size, is
    the cache length and goes over "model"; failing that, a matrix-memory
    state (mLSTM's C: trailing (dk, dv)) shards dk over "model" where it is
    at least 512 and divisible."""
    shp = mesh_shape_dict(mesh)
    b = shape.global_batch
    b_ax = batch_axes(mesh)
    b_ax = b_ax if len(b_ax) > 1 else b_ax[0]

    def one(leaf):
        dims = tuple(leaf.shape)
        parts = [None] * len(dims)
        for i, size in enumerate(dims):
            if size == b and i >= 1:
                if _shardable(size, b_ax, shp):
                    parts[i] = b_ax
                elif isinstance(b_ax, tuple) and _shardable(size, b_ax[-1], shp):
                    parts[i] = b_ax[-1]
                break
        for i in range(1, len(dims)):
            if parts[i - 1] is not None or dims[i - 1] == b:
                if dims[i] >= 1024 and dims[i] % shp["model"] == 0:
                    parts[i] = "model"
                break
        if "model" not in parts and len(dims) >= 2 and dims[-2] >= 512 \
                and dims[-2] % shp["model"] == 0:
            parts[-2] = "model"
        return tuple(parts)

    return _tree.tree_map(one, cache_tree)


def _names(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def entry_size(entry, sizes) -> int:
    """The ranks a spec entry (None, an axis or axes) splits over."""
    return math.prod(sizes[a] for a in _names(entry))


def _coord(entry, coords, sizes) -> int:
    """This rank's index along a spec entry (row-major over its axes)."""
    c = 0
    for a in _names(entry):
        c = c * sizes[a] + coords[a]
    return c


def _spec(spec, ndim: int) -> Tuple[Optional[str], ...]:
    spec = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    if len(spec) != ndim:
        raise ValueError(f"spec {spec} has more entries than {ndim} axes")
    return spec


def local_shape(shape: Sequence[int], spec, mesh) -> Tuple[int, ...]:
    """One rank's shard shape of a ``shape`` tensor under ``spec``: ceil
    division on each sharded axis."""
    sizes = mesh_shape_dict(mesh)
    return tuple(-(-int(d) // entry_size(n, sizes))
                 for d, n in zip(shape, _spec(spec, len(shape))))


def global_shape(shape: Sequence[int], spec, mesh) -> Tuple[int, ...]:
    """The full shape of a shard of ``shape`` under ``spec`` whose axes are
    not padded (a parameter's: :func:`param_specs` shards only where the
    mesh divides)."""
    sizes = mesh_shape_dict(mesh)
    return tuple(int(d) * entry_size(n, sizes)
                 for d, n in zip(shape, _spec(spec, len(shape))))


def spec_axes(spec) -> Tuple[str, ...]:
    """Every mesh axis a spec shards over."""
    return tuple(a for entry in spec for a in _names(entry))


def shard(full: torch.Tensor, spec, mesh, rank: Optional[int] = None
          ) -> torch.Tensor:
    """This rank's shard of ``full`` (or ``rank``'s, given a mesh or a
    ``{name: size}`` mapping): its ceil-division slice of every sharded
    axis, zero-padded where the slice runs past the axis. A new contiguous
    tensor on ``full``'s device."""
    spec = _spec(spec, full.ndim)
    sizes = mesh_shape_dict(mesh)
    coords = mesh.coords if rank is None else rank_coords(rank, sizes)
    lshape = local_shape(full.shape, spec, sizes)
    out = full.new_zeros(lshape)
    src, dst = [], []
    for d, loc, n in zip(full.shape, lshape, spec):
        start = _coord(n, coords, sizes) * loc
        stop = min(d, start + loc)
        src.append(slice(start, max(start, stop)))
        dst.append(slice(0, max(0, stop - start)))
    out[tuple(dst)] = full[tuple(src)]
    return out


def unshard(shards: Sequence[torch.Tensor], spec, mesh,
            shape: Sequence[int]) -> torch.Tensor:
    """The full ``shape`` tensor from every rank's shard (``shards[r]`` is
    rank r's), the padding dropped: the inverse of :func:`shard`."""
    spec = _spec(spec, len(shape))
    sizes = mesh_shape_dict(mesh)
    padded = tuple(loc * entry_size(n, sizes)
                   for loc, n in zip(local_shape(shape, spec, sizes), spec))
    full = shards[0].new_zeros(padded)
    for r, piece in enumerate(shards):
        coords = rank_coords(r, sizes)
        full[tuple(slice(_coord(n, coords, sizes) * loc,
                         (_coord(n, coords, sizes) + 1) * loc)
                   for loc, n in zip(piece.shape, spec))] = piece
    return full[tuple(slice(0, int(d)) for d in shape)].contiguous()


def _spec_map(fn, specs, *trees):
    """``fn(spec, *leaves)`` over a spec tree (tuples are its leaves) and
    trees of its structure."""
    if isinstance(specs, dict):
        return {k: _spec_map(fn, v, *(t[k] for t in trees)) for k, v in specs.items()}
    return fn(specs, *trees)


def shard_tree(tree, specs, mesh, rank: Optional[int] = None):
    """This rank's shards of a full tree under a spec tree of its structure
    (the counterpart of ``device_put`` under ``named(mesh, specs)``)."""
    return _spec_map(lambda sp, x: shard(x, sp, mesh, rank), specs, tree)


def unshard_tree(trees: Sequence, specs, mesh):
    """The full tree from every rank's tree of shards (``trees[r]`` is rank
    r's): the inverse of :func:`shard_tree` where no axis is padded (the
    parameter specs shard an axis only where its mesh axes divide it)."""
    sizes = mesh_shape_dict(mesh)

    def one(sp, *pieces):
        return unshard(list(pieces), sp, sizes,
                       global_shape(pieces[0].shape, sp, sizes))

    return _spec_map(one, specs, *trees)

