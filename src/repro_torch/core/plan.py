"""Projection planner/autotuner — pick, build and cache the fastest
executable for a projection workload (port of ``repro/core/plan.py``).

    build    — validate the norm design against the shape once
    autotune — ``method="auto"``: time every available backend on synthetic
               data of the exact (shape, dtype, device) and keep the winner
    cache    — the winner and the executable are memoised keyed on
               ``(shape, dtype, levels, radius_kind, device)``
    execute  — ``plan(y, radius, out=None)`` runs the cached executable

Backends are (a) every ℓ1 θ-solver of the ``core.ball`` registry, run
through the plain PyTorch schedule executor on the key's device, and (b)
specialized executables registered with :func:`register_plan_backend`: the
generated CUDA pipeline ``codegen``/``codegen_batch``
(``repro_torch.kernels.plan_backends``), available on ``"cuda"`` keys whose
design the Hopper tiler accepts, and the exact ℓ1,∞ projection
``exact_l1inf`` (``core.exact_l1inf``), available on 2-D bi-level ℓ1,∞
scalar-radius keys on either device. ``make_plan`` plans for the card unless
``device="cpu"`` is asked for, and raises without a CUDA device.

``grad=True`` keys are training keys: the autotuner times forward plus
backward, ``codegen`` competes through its residual VJP
(``kernels/codegen/backward.py``), and ``exact_l1inf`` and the mesh
executor, which have no backward, are not offered.

``sharding=(mesh, spec)`` makes a plan mesh-aware: the key carries the
global shape and a :class:`ShardingKey`, the plan takes this rank's shard,
and the candidates are the mesh executor's bodies, ``sharded`` (plain
PyTorch ops) and ``sharded_codegen`` (the generated kernels, on ``"cuda"``
keys ``kernels.codegen.distributed.shardable`` accepts). Nothing gathers
the tensor, so the generic θ-solvers are no candidates there. Timing runs
on every rank in lock-step (each candidate is collective); rank 0's verdict
is broadcast.

Example (CPU, fixed backend):

>>> import torch
>>> from repro_torch.core import plan
>>> p = plan.make_plan((4, 8), torch.float32, [("inf", 1), ("1", 1)],
...                    method="filter", device="cpu")
>>> p.method
'filter'
>>> X = p(torch.ones(4, 8), 2.0)
>>> round(float(X.abs().amax(dim=0).sum()), 5)   # inside the l1,inf ball
2.0
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch import _device
from repro_torch.obs import metrics as obs_metrics

from . import ball, exact_l1inf, schedule

AUTO = "auto"

_AUTOTUNE_BATCH = 4     # representative batch size for radius_kind="batch"
_AUTOTUNE_REPS = 7      # interleaved timing rounds (min per candidate kept)

_RADIUS_KINDS = ("scalar", "batch")


class ShardingKey(NamedTuple):
    """Canonical, hashable description of a mesh sharding (a PlanKey part).

    ``mesh_axes`` is ``((axis_name, size), ...)`` in mesh order; ``ranks``
    the world ranks the mesh lays out; ``spec`` maps each tensor axis to a
    mesh axis name (or None). The live mesh is kept in a side registry keyed
    on ``(mesh_axes, ranks)``, registered whenever a plan is built from a
    real mesh.
    """

    mesh_axes: Tuple[Tuple[str, int], ...]
    ranks: Tuple[int, ...]
    spec: Tuple[Optional[str], ...]


class PlanKey(NamedTuple):
    """The cache key a plan is specialized on."""

    shape: Tuple[int, ...]                # the global shape under a sharding
    dtype: str                            # torch dtype name, e.g. 'float32'
    levels: Tuple[Tuple[str, int], ...]   # canonical ('1'|'2'|'inf', n_axes)
    radius_kind: str                      # 'scalar' | 'batch'
    device: str                           # 'cuda' | 'cpu'
    sharding: Optional[ShardingKey] = None  # None = single-device workload
    grad: bool = False                    # training key: timed under autograd


class PlanBackend(NamedTuple):
    """A specialized planner backend (e.g. the generated CUDA pipeline).

    ``available(key)`` gates shape/levels/device eligibility; ``build(key)``
    returns the raw ``(y, radius, out=None) -> x`` callable.
    ``batch_native=True`` marks a backend whose callable takes the stacked
    ``(ys, radii)`` serving bucket: it is used as-is for
    ``radius_kind="batch"`` keys and never offered for scalar keys.
    """

    name: str
    available: Callable[[PlanKey], bool]
    build: Callable[[PlanKey], Callable]
    description: str = ""
    batch_native: bool = False


_SPECIALIZED: Dict[str, PlanBackend] = {}
_EXECS: Dict[Tuple[PlanKey, str], Callable] = {}
_PLANS: Dict[Tuple[PlanKey, str], "ProjectionPlan"] = {}
_AUTO_WINNERS: Dict[PlanKey, Tuple[str, Dict[str, float]]] = {}
_L1_WINNERS: Dict[PlanKey, str] = {}
_MESHES: Dict[Tuple[Tuple[Tuple[str, int], ...], Tuple[int, ...]], object] = {}
_KERNEL_BACKENDS_LOADED = False

# hits/misses describe the current cache generation (reset with the caches);
# "evictions" is cumulative over the process
_COUNTER_KEYS = ("plan_hits", "plan_misses", "exec_hits", "exec_misses",
                 "autotune_runs", "autotune_hits")
_COUNTERS: Dict[str, int] = dict.fromkeys(_COUNTER_KEYS, 0)
_EVICTIONS = [0]


def _count(event: str, n: int = 1) -> None:
    _COUNTERS[event] += n


def register_plan_backend(backend: PlanBackend) -> None:
    """Register (or replace) a specialized planner backend by name."""
    _SPECIALIZED[backend.name] = backend


def clear_cache() -> None:
    """Drop every cached plan, executable and autotune verdict, and reset the
    generation counters with them."""
    _EVICTIONS[0] += len(_PLANS) + len(_EXECS) + len(_AUTO_WINNERS)
    _EXECS.clear()
    _PLANS.clear()
    _AUTO_WINNERS.clear()
    _L1_WINNERS.clear()
    _COUNTERS.update(dict.fromkeys(_COUNTER_KEYS, 0))


def cache_info() -> Dict[str, int]:
    """Sizes (``plans``, ``executables``, ``auto_winners``) and lifecycle
    counters of the planner caches since the last :func:`clear_cache`;
    ``evictions`` is cumulative. Mirrored into the obs registry as the
    ``plan_cache`` gauge on every call."""
    info = {"plans": len(_PLANS), "executables": len(_EXECS),
            "auto_winners": len(_AUTO_WINNERS), **_COUNTERS,
            "evictions": _EVICTIONS[0]}
    gauge = obs_metrics.get_registry().gauge(
        "plan_cache", "planner cache sizes and lifecycle counters "
        "(core.plan.cache_info)", labels=("stat",))
    for name, v in info.items():
        gauge.labels(stat=name).set(v)
    return info


canonical_levels = schedule.canonical_levels


def torch_dtype(dtype) -> torch.dtype:
    """A ``torch.dtype`` from itself or its name (``"float32"``)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    dt = getattr(torch, str(dtype), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return dt


def dtype_name(dtype) -> str:
    """The name plan keys carry (``"float32"``) of a dtype or its name."""
    return str(torch_dtype(dtype)).removeprefix("torch.")


def canonical_sharding(sharding, ndim: int) -> Optional[ShardingKey]:
    """Fold ``None``, a :class:`ShardingKey` or a ``(mesh, spec)`` pair
    into a :class:`ShardingKey`, registering the live mesh. ``None`` for
    what the mesh executor does not take — a mesh of one rank or a fully
    replicated spec — which the single-device backends serve."""
    if sharding is None or isinstance(sharding, ShardingKey):
        return sharding
    mesh, spec = sharding
    if mesh.size <= 1:
        return None
    from . import sharded as shmod

    names = shmod.parse_spec(spec, ndim, mesh)  # the one spec parser
    if not any(names):
        return None
    mesh_axes = tuple((str(n), int(s)) for n, s in mesh.shape.items())
    ranks = tuple(range(mesh.size))
    _MESHES[mesh_axes, ranks] = mesh
    return ShardingKey(mesh_axes, ranks, tuple(names))


def _key_mesh(key: PlanKey):
    return _MESHES.get((key.sharding.mesh_axes, key.sharding.ranks))


def _sharded_available(key: PlanKey) -> bool:
    # scalar radius only: a served bucket stacks items, the mesh executor
    # projects one sharded tensor per call; forward keys only, as in the
    # JAX package (no backward through the collectives)
    return (key.sharding is not None and key.radius_kind == "scalar"
            and not key.grad and _key_mesh(key) is not None)


def _build_sharded(key: PlanKey) -> Callable:
    from . import sharded as shmod

    return _sharded_fn(key, "plain", shmod)


def _sharded_fn(key: PlanKey, backend: str, shmod) -> Callable:
    """``(y_local, radius, out)`` through the mesh executor; its outer
    θ-solver is resolved once here, on rank 0, and broadcast."""
    from repro_torch.parallel.sharding import entry_size

    mesh = _key_mesh(key)
    spec, levels = key.sharding.spec, list(key.levels)
    padded = tuple(d * entry_size(n, mesh.shape) if n else d for d, n in zip(
        shmod.local_shape(key.shape, spec, mesh), spec))
    method = shmod._resolve_sharded_method(
        AUTO, schedule.compile_schedule(padded, levels), key.dtype, mesh,
        device=key.device)

    def fn(y, radius, out):
        x = shmod.multilevel_project_sharded(
            y, levels, radius, mesh=mesh, spec=spec, shape=key.shape,
            method=method, backend=backend)
        return x if out is None else out.copy_(x)

    return fn


register_plan_backend(PlanBackend(
    name="sharded",
    available=_sharded_available,
    build=_build_sharded,
    description="mesh executor, plain body: collective reduces, gathered "
                "small outer solve, local applies (core/sharded.py)",
))


_L1INF_LEVELS = (("inf", 1), ("1", 1))


def _exact_l1inf_available(key: PlanKey) -> bool:
    # The EXACT ℓ1,∞ projection (Chu et al. semismooth Newton) targets the
    # same ball as the bi-level design but is a different operator; offering
    # it under method="auto" trades bi-level's looseness for measured speed,
    # as the JAX planner does. Unsharded 2-D scalar-radius forward keys only:
    # its Newton loop and per-column sorts make a pathological backward.
    return (key.levels == _L1INF_LEVELS and len(key.shape) == 2
            and key.radius_kind == "scalar" and key.sharding is None
            and not key.grad)


def _build_exact_l1inf(key: PlanKey) -> Callable:
    def fn(y, radius, out=None):
        x = exact_l1inf.project_l1inf_exact(y, radius)
        return x if out is None else out.copy_(x)

    return fn


register_plan_backend(PlanBackend(
    name="exact_l1inf",
    available=_exact_l1inf_available,
    build=_build_exact_l1inf,
    description="EXACT l1,inf projection (Chu et al. semismooth Newton on "
                "the dual) in PyTorch ops: same ball as the bi-level design, "
                "exact optimum",
))


def _maybe_register_kernel_backends() -> None:
    """Pull in the kernel backends on first use (kernels import core, so core
    cannot import kernels at load). An import error propagates."""
    global _KERNEL_BACKENDS_LOADED
    if not _KERNEL_BACKENDS_LOADED:
        from repro_torch.kernels import plan_backends  # noqa: F401  (registers)

        _KERNEL_BACKENDS_LOADED = True


def _backend_available(backend: PlanBackend, key: PlanKey) -> bool:
    if backend.batch_native and key.radius_kind != "batch":
        return False
    return backend.available(key)


def is_batch_native(name: str) -> bool:
    """True when ``name`` is a registered batch-native specialized backend
    (its executables take stacked ``(ys, radii)`` buckets only); the kernel
    backends register first."""
    _maybe_register_kernel_backends()
    backend = _SPECIALIZED.get(name)
    return backend is not None and backend.batch_native


def _build_backend_fn(key: PlanKey, name: str) -> Callable:
    """Raw ``(y, radius, out) -> x`` callable for one backend on one key."""
    if name in _SPECIALIZED:
        backend = _SPECIALIZED[name]
        if not _backend_available(backend, key):
            raise ValueError(
                f"backend {name!r} is not available for plan key {key}")
        built = backend.build(key)
        if key.radius_kind == "scalar" or backend.batch_native:
            return built

        def per_item(ys, radii, out):
            # the counterpart of JAX's vmap over a per-item executable
            if _device.records_grad(ys, radii):
                x = torch.stack([built(y, r) for y, r in zip(ys, radii)])
                return x if out is None else out.copy_(x)
            out = torch.empty_like(ys) if out is None else out
            for i in range(ys.shape[0]):
                built(ys[i], radii[i], out=out[i])
            return out

        return per_item
    method = ball.resolve_method(name)
    batch_dims = 1 if key.radius_kind == "batch" else 0

    def fn(y, radius, out):
        sched = schedule.compile_schedule(y.shape, key.levels, batch_dims)
        x = schedule.execute(y, sched, radius, method=method)
        return x if out is None else out.copy_(x)

    return fn


def _get_executable(key: PlanKey, name: str) -> Callable:
    ek = (key, name)
    if ek in _EXECS:
        _count("exec_hits")
        return _EXECS[ek]
    _count("exec_misses")
    fn = _build_backend_fn(key, name)
    _EXECS[ek] = fn
    return fn


def _candidates(key: PlanKey) -> List[str]:
    """Backends worth timing for this key (a sharded key: the mesh
    executor's bodies only)."""
    if key.sharding is not None:
        names = []
    elif any(q == "1" for q, _ in key.levels):
        names = list(ball.available_methods())
    else:
        # no ℓ1 level: the θ-solver never runs, one generic executable does
        names = [ball.DEFAULT_METHOD]
    names += [b.name for b in _SPECIALIZED.values()
              if _backend_available(b, key)]
    return names


def _local_shape(key: PlanKey) -> Tuple[int, ...]:
    """The tensor shape a plan for ``key`` takes: this rank's shard of a
    sharded key, else ``key.shape``."""
    if key.sharding is None:
        return key.shape
    from .sharded import local_shape

    return local_shape(key.shape, key.sharding.spec, _key_mesh(key))


def _bench_args(key: PlanKey):
    gen = torch.Generator(device=key.device).manual_seed(0)
    shape = _local_shape(key) if key.radius_kind == "scalar" \
        else (_AUTOTUNE_BATCH,) + key.shape
    y = torch.rand(shape, generator=gen, dtype=torch_dtype(key.dtype),
                   device=key.device)
    if key.radius_kind == "scalar":
        radius = torch.ones((), dtype=y.dtype, device=y.device)
    else:
        radius = torch.ones((_AUTOTUNE_BATCH,), dtype=y.dtype, device=y.device)
    return y, radius


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def _grad_fn(key: PlanKey, name: str) -> Callable:
    """The gradient of ``sum(x ** 2)`` through one backend with respect to
    y: what a training step runs for a ``grad`` key, so what the autotuner
    times there (a backend that wins the forward can lose under autograd)."""
    base = _get_executable(key, name)

    def fn(y, radius, out):
        y = y.detach().requires_grad_(True)
        with torch.enable_grad():
            return torch.autograd.grad(base(y, radius, None).square().sum(),
                                       y)[0]

    return fn


def _autotune(key: PlanKey, names: Optional[List[str]] = None
              ) -> Tuple[str, Dict[str, float]]:
    """Interleaved min-of-rounds shoot-out over every candidate backend
    (or over ``names``).

    Candidates run round-robin and each keeps its fastest round: the fastest
    is the least disturbed by noise, and interleaving keeps drift from
    favouring one candidate. Every call is closed by a device synchronise, so
    the host clock measures the work, not the enqueue. On a sharded key every
    rank runs the same rounds (the candidates are collective) and rank 0's
    winner is broadcast. A ``grad`` key times forward plus backward
    (:func:`_grad_fn`).
    """
    y, radius = _bench_args(key)
    names = _candidates(key) if names is None else names
    make = _grad_fn if key.grad else _get_executable
    fns = {name: make(key, name) for name in names}
    for fn in fns.values():
        for _ in range(2):
            fn(y, radius, None)  # build + warm
    _sync(key.device)
    timings: Dict[str, float] = dict.fromkeys(fns, float("inf"))
    for _ in range(_AUTOTUNE_REPS):
        for name, fn in fns.items():
            t0 = time.perf_counter()
            fn(y, radius, None)
            _sync(key.device)
            timings[name] = min(timings[name],
                                (time.perf_counter() - t0) * 1e6)
    if key.sharding is not None:
        winner = _key_mesh(key).broadcast_choice(
            list(fns), lambda: min(timings, key=timings.get))
    else:
        winner = min(timings, key=timings.get)
    return winner, timings


def best_l1_method(n: int, dtype=torch.float32, *, device=None,
                   grad: bool = False) -> str:
    """Autotuned θ-solver name for flat length-``n`` ℓ1 projections: only
    ``core.ball`` registry methods compete, so the winner runs anywhere a
    method name does (the mesh executor's replicated outer solve, the
    training hook). Timed once per (n, dtype, device, grad) and cached;
    ``grad=True`` times each solver forward plus backward, for a caller
    that differentiates through the solve."""
    dev = _device.resolve(device)
    key = PlanKey((int(n),), dtype_name(dtype), (("1", 1),), "scalar", dev.type,
                  grad=bool(grad))
    if key in _L1_WINNERS:
        _count("autotune_hits")
    else:
        _count("autotune_runs")
        _L1_WINNERS[key] = _autotune(key, list(ball.available_methods()))[0]
    return _L1_WINNERS[key]


def _canonical_backend_name(key: PlanKey, method: str) -> str:
    if method in _SPECIALIZED:
        if not _backend_available(_SPECIALIZED[method], key):
            raise ValueError(
                f"backend {method!r} is not available for shape={key.shape} "
                f"levels={key.levels} dtype={key.dtype} "
                f"radius_kind={key.radius_kind!r} on device={key.device!r}")
        return method
    if key.sharding is not None:
        raise ValueError(
            f"backend {method!r} is not available for a sharded key: the mesh "
            "executor runs 'sharded' or 'sharded_codegen' (nothing gathers "
            "the tensor)")
    try:
        return ball.resolve_method(method)
    except ValueError:
        raise ValueError(
            f"unknown projection backend {method!r}; generic: "
            f"{sorted(ball.available_methods())}, specialized: "
            f"{sorted(_SPECIALIZED)} (or 'auto')") from None


@dataclasses.dataclass(frozen=True, eq=False)
class ProjectionPlan:
    """A shape/dtype/device-specialized multi-level projection.

    Call it like a function: ``plan(y, radius, out=None)``. ``method`` is the
    backend the planner chose (the autotune winner under ``method="auto"``);
    ``timings_us`` holds the per-candidate timings when autotuned. ``out``
    receives the result; the kernel backends may take ``out=y`` and project
    in place.
    """

    key: PlanKey
    method: str
    requested: str
    timings_us: Optional[Dict[str, float]]
    _exec: Callable

    def __call__(self, y: torch.Tensor, radius=1.0,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.key.radius_kind == "scalar":
            expected = _local_shape(self.key)
        else:
            expected = tuple(y.shape[:1]) + self.key.shape
        if tuple(y.shape) != expected:
            raise ValueError(
                f"plan built for shape {self.key.shape} "
                f"(radius_kind={self.key.radius_kind!r}) got {tuple(y.shape)}")
        if dtype_name(y.dtype) != self.key.dtype:
            raise ValueError(
                f"plan built for dtype {self.key.dtype} got {y.dtype}")
        if y.device.type != self.key.device:
            raise ValueError(
                f"plan built for device {self.key.device} got a tensor on "
                f"{y.device}")
        radius = torch.as_tensor(radius, dtype=y.dtype, device=y.device)
        if self.key.radius_kind == "batch" and radius.ndim == 0:
            radius = radius.expand(y.shape[0]).contiguous()
        return self._exec(y, radius, out)


def make_plan(shape, dtype, levels, radius_kind: str = "scalar",
              method: str = AUTO, *, device=None, sharding=None,
              grad: bool = False) -> ProjectionPlan:
    """Build (or fetch from cache) the projection plan for one workload.

    ``shape``/``dtype`` describe one tensor to project (for
    ``radius_kind="batch"`` the plan runs over a leading batch axis with one
    radius per item). ``levels`` is the norm design ν. ``method`` is a
    backend name, or ``"auto"`` to time every available backend on first
    use and cache the winner. ``device`` is ``"cuda"`` (the default; raises
    without a CUDA device) or ``"cpu"``. ``sharding=(mesh, spec)``: ``shape``
    is the global shape and the plan projects this rank's shard through the
    mesh executor (every rank makes the same plan, in the same order).

    ``grad=True`` marks a training key: the projection will be
    differentiated through, so ``method="auto"`` times forward plus
    backward of each candidate, and forward and grad keys keep separate
    verdicts. The plan's executable is the forward either way: every
    backend offered is differentiable (``codegen`` through its residual
    VJP); those without a backward (``exact_l1inf``, the mesh executor) are
    not offered for a grad key.
    """
    _maybe_register_kernel_backends()
    dev = _device.resolve(device)
    shape = tuple(int(s) for s in shape)
    lv = canonical_levels(levels)
    schedule.check_levels(shape, lv)
    if radius_kind not in _RADIUS_KINDS:
        raise ValueError(
            f"radius_kind must be one of {_RADIUS_KINDS}, got {radius_kind!r}")
    key = PlanKey(shape, dtype_name(dtype), lv, radius_kind, dev.type,
                  canonical_sharding(sharding, len(shape)), bool(grad))
    cache_key = (key, method)
    if cache_key in _PLANS:
        _count("plan_hits")
        return _PLANS[cache_key]
    _count("plan_misses")
    timings: Optional[Dict[str, float]] = None
    if method == AUTO:
        if key in _AUTO_WINNERS:
            _count("autotune_hits")
            chosen, timings = _AUTO_WINNERS[key]
        else:
            _count("autotune_runs")
            chosen, timings = _autotune(key)
            _AUTO_WINNERS[key] = (chosen, timings)
    else:
        chosen = _canonical_backend_name(key, method)
    plan = ProjectionPlan(key=key, method=chosen, requested=method,
                          timings_us=timings,
                          _exec=_get_executable(key, chosen))
    _PLANS[cache_key] = plan
    return plan


def validate_backend(shape, dtype, levels, method: str, *, device=None,
                     radius_kind: str = "scalar") -> str:
    """Canonicalize and validate a backend name for a workload without
    building a plan: returns the canonical name (``"auto"`` passes through),
    raises ``ValueError`` for an unknown or unavailable backend. Cheap enough
    for a request-admission path."""
    _maybe_register_kernel_backends()
    if method == AUTO:
        return AUTO
    dev = _device.resolve(device)
    key = PlanKey(tuple(int(s) for s in shape), dtype_name(dtype),
                  canonical_levels(levels), radius_kind, dev.type)
    return _canonical_backend_name(key, method)
