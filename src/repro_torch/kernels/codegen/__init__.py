"""repro_torch.kernels.codegen — compile any schedule IR to the generated
CUDA pipeline (port of ``repro/kernels/codegen``).

* ``tiling``   — the Hopper launch planner: canonical view, row splits, and
  the limits that make it reject a design;
* ``lowering`` — the reduce and apply kernel wrappers beside their plain
  versions, and ``generate``/``generate_batched`` (differentiable: their
  backward is ``backward.schedule_vjp``);
* ``backward`` — the residual VJP of a compiled schedule in PyTorch ops;
* this module — the cached entry points the planner backends
  (``kernels/plan_backends.py``) and ``kernels/ops.py`` build on.

The measured block-size search of the JAX package (``autotune_tiles``) is
not ported yet: ``build_tuned`` builds the heuristic plan.
"""

from __future__ import annotations

import functools
from typing import Callable, Sequence

import torch

from repro_torch import _device
from repro_torch.core.plan import dtype_name, torch_dtype
from repro_torch.core.schedule import canonical_levels, compile_schedule

from . import backward, lowering, tiling  # noqa: F401
from .lowering import generate, generate_batched  # noqa: F401
from .tiling import TilePlan, plan_tiles  # noqa: F401


def supported(shape, levels, dtype) -> bool:
    """True when the Hopper tiler accepts (shape, levels, dtype) — the
    availability gate of the ``codegen`` planner backends."""
    try:
        sched = compile_schedule(shape, levels)
    except ValueError:
        return False
    return plan_tiles(sched, torch_dtype(dtype)) is not None


@functools.lru_cache(maxsize=None)
def _cached_build(shape, levels, dtype: str, method: str, device: str,
                  batched: bool) -> Callable:
    sched = compile_schedule(shape, levels)
    gen = lowering.generate_batched if batched else lowering.generate
    return gen(sched, torch_dtype(dtype), method=method, device=device)


def build(shape, levels, dtype, *, method: str = "bisect",
          device=None) -> Callable:
    """The generated ``(y, radius, out=None) -> x`` callable for one
    workload, cached."""
    dev = _device.resolve(device)
    return _cached_build(tuple(int(s) for s in shape), canonical_levels(levels),
                         dtype_name(dtype), method, dev.type, False)


def build_tuned(shape, levels, dtype, *, method: str = "bisect",
                device=None) -> Callable:
    """Like :func:`build`; the measured tile search is not ported yet, so
    this is the heuristic plan (the planner backend's build path)."""
    return build(shape, levels, dtype, method=method, device=device)


def build_batched(shape, levels, dtype, *, method: str = "bisect",
                  device=None) -> Callable:
    """The generated ``(ys, radii, out=None) -> xs`` callable for a serving
    bucket of ``shape``-shaped items, cached."""
    dev = _device.resolve(device)
    return _cached_build(tuple(int(s) for s in shape), canonical_levels(levels),
                         dtype_name(dtype), method, dev.type, True)


def codegen_project(y: torch.Tensor, levels: Sequence, radius, *,
                    method: str = "bisect") -> torch.Tensor:
    """Project ``y`` through the generated pipeline on ``y``'s device (the
    kernels for a CUDA tensor, their plain versions for a CPU one)."""
    fn = build(y.shape, levels, y.dtype, method=method, device=y.device.type)
    return fn(y, radius)
