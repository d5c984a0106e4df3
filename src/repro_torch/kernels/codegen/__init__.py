"""repro_torch.kernels.codegen — compile any schedule IR to the generated
CUDA pipeline (port of ``repro/kernels/codegen``).

* ``tiling``   — the Hopper launch planner: canonical view, row splits, and
  the limits that make it reject a design;
* ``lowering`` — the reduce and apply kernel wrappers beside their plain
  versions, and ``generate``/``generate_batched`` (differentiable: their
  backward is ``backward.schedule_vjp``);
* ``backward`` — the residual VJP of a compiled schedule in PyTorch ops;
* this module — the cached entry points the planner backends
  (``kernels/plan_backends.py``) and ``kernels/ops.py`` build on, and the
  measured tile search.

**The tile search** (:func:`autotune_tiles`, the JAX package's measured
block-size search re-aimed at Hopper launch geometry): the candidates of
``tiling.candidate_tile_plans`` — the heuristic plan and its neighbours in
the reduce's packs and row splits and the apply's rows a split or lead
chunk — each run the full generated pipeline (reduce → θ-solve → apply) on
uniform data of the workload's shape. On a CUDA device a round times
each candidate's ``_TUNE_CALLS`` back-to-back calls between CUDA events,
queued behind a spin kernel (``torch.cuda._sleep``) that lasts twice their
host work, so the window holds the device's time alone (a lone call's
window holds its host work, several times the kernels' time at these
shapes; a CUDA graph would hide it too, but capturing in the planner's
warm threads stops every other thread's device synchronize); the best of
``_TUNE_REPS`` interleaved rounds counts, one search at a time. A
candidate replaces the heuristic only where its best round beats the
heuristic's by more than either one's spread between rounds; the verdict
is cached per (shape,
levels, dtype, device). Elsewhere nothing is timed (on the CPU the kernels
do not run) and the heuristic plan is the answer. :func:`build_tuned`, the
planner backend's build path, builds with the verdict; ``distributed.py``
tunes the local shard's shape, rank 0's verdict shared by every rank. The
search's launches — each candidate's ``_TUNE_WARM`` warm-up calls and
``_TUNE_REPS`` × ``_TUNE_CALLS`` timed ones — count in the kernels'
``launches`` and, apart, in ``search_launches`` (``_build.searching``).
"""

from __future__ import annotations

import functools
import itertools
import math
import threading
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch import _device
from repro_torch.core.plan import dtype_name, torch_dtype
from repro_torch.core.schedule import canonical_levels, compile_schedule

from .. import _build
from . import backward, lowering, tiling  # noqa: F401
from .lowering import generate, generate_batched  # noqa: F401
from .tiling import TilePlan, candidate_tile_plans, plan_tiles  # noqa: F401

# measured tile plans, keyed on (shape, levels, dtype, device), and on the
# mesh too where the ranks share one verdict: one search per workload and
# process
_TUNED_TILES: Dict[Tuple, TilePlan] = {}
_TUNE_LOG: Dict[Tuple, dict] = {}   # each search's candidates and times
_SEARCHES = itertools.count(1)      # the searches' ordinals in this process
_TUNE_WARM = 2          # untimed calls of each candidate first (builds, lazy init)
_TUNE_CALLS = 5         # back-to-back pipeline calls a round times
_TUNE_REPS = 5          # interleaved rounds; a candidate's time is its best
_SEARCH_LOCK = threading.Lock()   # one search at a time: none times another's


def clear_tile_cache() -> None:
    """Drop every cached tile verdict and the search log (benches, tests)."""
    _TUNED_TILES.clear()
    _TUNE_LOG.clear()


def tile_search_log() -> Dict[Tuple, dict]:
    """Per searched workload key: ``{"search", "plans", "ms", "spread",
    "fastest", "winner"}`` (the search's ordinal in this process, the
    candidates, each one's best and worst-less-best round in ms a call, the
    fastest one's index, the verdict's index)."""
    return dict(_TUNE_LOG)


def _tile_key(shape, levels, dtype, device, mesh=None) -> Tuple:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (tuple(int(s) for s in shape), canonical_levels(levels),
           dtype_name(dtype), str(dev))
    if mesh is not None:
        key += ((tuple(mesh.axis_names),
                 tuple(mesh.shape[n] for n in mesh.axis_names)),)
    return key


def _time_candidates(fns, y, r, out, cuda: bool):
    """Each candidate's best round and its spread (worst less best), in ms
    a call, over ``_TUNE_REPS`` interleaved rounds after ``_TUNE_WARM``
    calls each. On the card a round is ``_TUNE_CALLS`` back-to-back calls
    between two CUDA events, queued behind a spin kernel that outlasts
    their host work twice over, so the window holds the device's time
    alone; elsewhere it is one call on the host clock."""
    times = [[] for _ in fns]
    host = 0.0
    for fn in fns:
        for _ in range(_TUNE_WARM):
            t0 = time.perf_counter()
            fn(y, r, out)
        host = max(host, time.perf_counter() - t0)  # the last, warm call's
    if not cuda:
        for _ in range(_TUNE_REPS):
            for i, fn in enumerate(fns):
                t0 = time.perf_counter()
                fn(y, r, out)
                times[i].append((time.perf_counter() - t0) * 1e3)
    else:
        pad = int(2e3 * _TUNE_CALLS * host * _spin_cycles_per_ms())
        events = []
        for _ in range(_TUNE_REPS):
            for i, fn in enumerate(fns):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda._sleep(pad)
                start.record()
                for _ in range(_TUNE_CALLS):
                    fn(y, r, out)
                end.record()
                events.append((i, start, end))
        events[-1][2].synchronize()   # one stream: every round has ended
        for i, start, end in events:
            times[i].append(start.elapsed_time(end) / _TUNE_CALLS)
    return [min(t) for t in times], [max(t) - min(t) for t in times]


@functools.lru_cache(maxsize=None)
def _spin_cycles_per_ms() -> float:
    """Cycles of ``torch.cuda._sleep`` a millisecond on this card."""
    n = 1 << 22
    torch.cuda._sleep(n)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(n)
    end.record()
    end.synchronize()
    return n / start.elapsed_time(end)


def _verdict(best, spread) -> int:
    """The fastest candidate where it beats the heuristic (index 0) by more
    than either one's spread between rounds, else the heuristic."""
    w = min(range(len(best)), key=best.__getitem__)
    return w if best[0] - best[w] > max(spread[0], spread[w]) else 0


def autotune_tiles(shape, levels, dtype, *, method: str = "bisect",
                   measure: Optional[bool] = None,
                   device=None, mesh=None) -> Optional[TilePlan]:
    """The measured tile search (module docstring) for projecting a
    ``shape`` tensor (leading axes beyond the design's are batch items, the
    kernels' batch) on ``device`` (the card by default). ``measure=None``
    measures only on a CUDA device; ``measure=False`` returns the heuristic
    plan; ``measure=True`` times on any device (on the CPU, the plain
    versions by the host clock). With ``mesh`` every rank searches (so all
    make the same launches) and rank 0's verdict is every rank's
    (``Mesh.broadcast_choice``): ranks that hold copies of one slice
    project it with one geometry, bit for bit. The verdict is cached per
    (shape, levels, dtype, device[, mesh]). Returns ``None`` when the
    design cannot be generated."""
    dev = _device.resolve(device)
    dtype = torch_dtype(dtype)
    key = _tile_key(shape, levels, dtype, dev, mesh)
    if key in _TUNED_TILES:
        return _TUNED_TILES[key]
    b = len(key[0]) - sum(k for _, k in key[1])
    sched = compile_schedule(key[0], key[1], b)
    base = compile_schedule(key[0][b:], key[1]) if b else sched
    batch = math.prod(key[0][:b])
    cands = candidate_tile_plans(base, dtype, batch)
    if not cands:
        return None
    if measure is None:
        measure = dev.type == "cuda"
    if len(cands) == 1 or not measure:
        _TUNED_TILES[key] = cands[0]
        return cands[0]
    gen = torch.Generator(device=dev).manual_seed(0)
    y = torch.rand(key[0], generator=gen, dtype=dtype, device=dev)
    out = torch.empty_like(y)
    r = torch.tensor(1.0, dtype=dtype, device=dev)
    fns = [lowering.generate(sched, dtype, method=method, device=dev,
                             tile_plan=tp) for tp in cands]
    with _SEARCH_LOCK, torch.no_grad(), _build.searching():
        best, spread = _time_candidates(fns, y, r, out, dev.type == "cuda")
    del y, out
    winner = _verdict(best, spread)
    if mesh is not None:
        names = [str(i) for i in range(len(cands))]
        winner = int(mesh.broadcast_choice(names, lambda: str(winner)))
    _TUNE_LOG[key] = {"search": next(_SEARCHES), "plans": cands, "ms": best,
                      "spread": spread, "winner": winner,
                      "fastest": min(range(len(best)), key=best.__getitem__)}
    _TUNED_TILES[key] = cands[winner]
    return cands[winner]


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
                  batched: bool, tile_plan: Optional[TilePlan] = None
                  ) -> Callable:
    sched = compile_schedule(shape, levels)
    gen = lowering.generate_batched if batched else lowering.generate
    return gen(sched, torch_dtype(dtype), method=method, device=device,
               tile_plan=tile_plan)


def build(shape, levels, dtype, *, method: str = "bisect",
          device=None, tile_plan: Optional[TilePlan] = None) -> Callable:
    """The generated ``(y, radius, out=None) -> x`` callable for one
    workload, cached; ``tile_plan`` fixes the launch geometry (a
    ``TilePlan`` is a hashable NamedTuple, so it joins the cache key)."""
    dev = _device.resolve(device)
    return _cached_build(tuple(int(s) for s in shape), canonical_levels(levels),
                         dtype_name(dtype), method, dev.type, False, tile_plan)


def build_tuned(shape, levels, dtype, *, method: str = "bisect",
                device=None) -> Callable:
    """Like :func:`build`, with the measured tile plan: runs (or fetches)
    :func:`autotune_tiles` for the workload and builds with its winner (the
    planner backend's build path)."""
    tp = autotune_tiles(shape, levels, dtype, method=method, device=device)
    return build(shape, levels, dtype, method=method, device=device,
                 tile_plan=tp)


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
