"""Parameter templates: one declaration drives init and counting (port of
``repro/models/params.py``).

A model is declared as a tree (nested dicts) of ``ParamDef`` (shape + logical
axes + init). From the same template:

  * ``init_params``  — materialized tensors on a device, each leaf drawn from
                       its own ``torch.Generator`` seeded from (seed, path)
  * ``count_params`` — exact parameter count without allocation
  * ``abstract_params`` — ``meta`` tensors of each leaf's shape (the dry
                       run's stand-ins: shapes and dtypes, no storage)

  * ``param_specs``  — the spec tree (logical axes → mesh axes) a mesh
                       shards the parameters by

The logical axes are the JAX package's, so are the specs.

JAX's and torch's generators give different numbers from one seed, so a
parity test builds parameters once (in either package) and carries them
across with ``interop.from_numpy_tree``; the init *statistics* (normal,
``scaled`` = 1/sqrt(fan_in) over all leading axes, ones, zeros) are the same.
"""

from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Dict, Optional, Tuple

import torch

from repro_torch import _device, _tree


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]        # logical axis names (len == len(shape))
    init: str = "normal"                   # normal | zeros | ones | scaled
    scale: float = 0.02                    # stddev for 'normal'; 'scaled' -> 1/sqrt(fan_in)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes} rank mismatch")


def is_def(x) -> bool:
    return isinstance(x, ParamDef)


def _leaf_seed(seed: int, path: str) -> int:
    # crc32 of the path, NOT hash(): python string hashing is per-process
    # randomized; the leaf's stream must not depend on its neighbours
    return (int(seed) * 0x9E3779B97F4A7C15 + zlib.crc32(path.encode())) % (1 << 63)


def init_params(template, seed: int, dtype=torch.float32, *, device=None,
                shard=None):
    """Materialize a template on ``device`` (``"cuda"`` by default; ``"cpu"``
    when asked). Each leaf draws from a ``torch.Generator`` on that device
    seeded from ``seed`` and the leaf's path, so layouts can be refactored
    without changing unrelated leaves. ``shard(path, leaf)``, when given,
    replaces each leaf as soon as it is drawn (a rank keeping its shard
    holds one whole leaf at a time)."""
    dev = _device.resolve(device)
    keep = shard or (lambda path, x: x)

    def one(path: str, pd: ParamDef):
        return keep(path, draw(path, pd))

    def draw(path: str, pd: ParamDef):
        if pd.init == "zeros":
            return torch.zeros(pd.shape, dtype=dtype, device=dev)
        if pd.init == "ones":
            return torch.ones(pd.shape, dtype=dtype, device=dev)
        gen = torch.Generator(device=dev).manual_seed(_leaf_seed(seed, path))
        if pd.init == "scaled":
            fan_in = pd.shape[0] if len(pd.shape) == 1 else math.prod(pd.shape[:-1])
            std = 1.0 / max(math.sqrt(fan_in), 1.0)
        else:
            std = pd.scale
        x = torch.randn(pd.shape, generator=gen, dtype=torch.float32, device=dev)
        return x.mul_(std).to(dtype)

    return _tree.map_with_path(one, template)


def abstract_params(template, dtype=torch.float32, *, shape=None):
    """The template as ``meta`` tensors of ``dtype``: each leaf's shape, or
    ``shape(path, pd)`` when given (a rank's local shard shape), and no
    allocation on any device (``jax.ShapeDtypeStruct`` leaves in the JAX
    package)."""
    size = shape or (lambda path, pd: pd.shape)
    return _tree.map_with_path(
        lambda path, pd: torch.empty(size(path, pd), dtype=dtype, device="meta"),
        template)


def count_params(template) -> int:
    return int(sum(math.prod(pd.shape) for pd in _tree.leaves(template)))


def param_specs(template, rules: Dict[str, Optional[str]],
                mesh_shape: Dict[str, int]):
    """Spec tree: per leaf a tuple with one entry per axis, the mesh axis it
    is sharded over or None. ``rules`` maps logical axis -> mesh axis (or a
    tuple of mesh axes, or None).

    A dim is sharded only when the mapped mesh axes divide it; otherwise
    that dim replicates. A mesh axis is used at most once per param (first
    logical axis wins).
    """

    def one(_, pd: ParamDef):
        used = set()
        parts = []
        for dim, ax in zip(pd.shape, pd.axes):
            mesh_ax = rules.get(ax) if ax else None
            if mesh_ax is None:
                parts.append(None)
                continue
            axes_tuple = mesh_ax if isinstance(mesh_ax, tuple) else (mesh_ax,)
            size = math.prod(mesh_shape[a] for a in axes_tuple)
            if dim % size == 0 and not (set(axes_tuple) & used):
                used.update(axes_tuple)
                parts.append(mesh_ax)
            else:
                parts.append(None)
        return tuple(parts)

    return _tree.map_with_path(one, template)
