"""Sharding rules: logical axes → mesh axes (port of
``repro/parallel/sharding.py``, the parameter part), and the two helpers
that go between a full tensor and one rank's shard.

Mesh axes: ("data", "model"). Policy: tensor parallelism over 'model' for heads / kv_heads / ffn /
experts / vocab / ssm_in; FSDP over 'data' on the 'embed' (d_model) axis of
every weight when ``fsdp``. A spec is a tuple with one entry per tensor
axis: a mesh axis name or None (the port's ``PartitionSpec``).

A rank holds the ceil-division slice of each sharded axis; the last ranks'
slices run past the end of the axis and hold zeros there, exactly the
zero-padding ``core.sharded.multilevel_project_sharded`` works on (zeros
are fixed points of every level of a norm design).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from .mesh import rank_coords


def mesh_shape_dict(mesh) -> Dict[str, int]:
    """Axis name → size of a :class:`~repro_torch.parallel.mesh.Mesh`, or of
    a plain ``{name: size}`` mapping (in mesh order)."""
    return dict(mesh.shape) if hasattr(mesh, "shape") else dict(mesh)


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


def _spec(spec, ndim: int) -> Tuple[Optional[str], ...]:
    spec = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    if len(spec) != ndim:
        raise ValueError(f"spec {spec} has more entries than {ndim} axes")
    return spec


def local_shape(shape: Sequence[int], spec, mesh) -> Tuple[int, ...]:
    """One rank's shard shape of a ``shape`` tensor under ``spec``: ceil
    division on each sharded axis."""
    sizes = mesh_shape_dict(mesh)
    return tuple(-(-int(d) // sizes[n]) if n else int(d)
                 for d, n in zip(shape, _spec(spec, len(shape))))


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
        start = coords[n] * loc if n else 0
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
    padded = tuple(loc * sizes[n] if n else loc
                   for loc, n in zip(local_shape(shape, spec, sizes), spec))
    full = shards[0].new_zeros(padded)
    for r, piece in enumerate(shards):
        coords = rank_coords(r, sizes)
        full[tuple(slice(coords[n] * loc, (coords[n] + 1) * loc) if n else slice(None)
                   for loc, n in zip(piece.shape, spec))] = piece
    return full[tuple(slice(0, int(d)) for d in shape)].contiguous()
