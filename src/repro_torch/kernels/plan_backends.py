"""The generated CUDA pipeline as projection-planner backends (port of
``repro/kernels/plan_backends.py``).

Importing this module registers ``codegen`` (one item per call) and
``codegen_batch`` (a serving bucket per call: the batch is the kernels'
leading launch axis, one radius per item) with ``repro_torch.core.plan``.
Both are available for an unsharded plan key on ``"cuda"`` whose design
the Hopper tiler accepts; ``codegen_batch`` is batch-native, so only
``radius_kind="batch"`` keys see it. ``sharded_codegen`` is the mesh
executor with the generated kernels as its shard-local stages
(``codegen/distributed.py``), available on sharded scalar-radius ``"cuda"``
keys that ``distributed.shardable`` accepts. The planner imports this
module on first use and lets any import error propagate.
"""

from __future__ import annotations

from repro_torch.core import plan as planmod

from . import codegen

# the outer θ-solve: "bisect" has no data-dependent sweep count (stable
# latency for a served plan)
_OUTER_METHOD = "bisect"


def _codegen_available(key: planmod.PlanKey) -> bool:
    return (key.device == "cuda" and key.sharding is None
            and codegen.supported(key.shape, key.levels, key.dtype))


def _build_codegen(key: planmod.PlanKey):
    return codegen.build_tuned(key.shape, key.levels, key.dtype,
                               method=_OUTER_METHOD, device=key.device)


def _build_codegen_batch(key: planmod.PlanKey):
    return codegen.build_batched(key.shape, key.levels, key.dtype,
                                 method=_OUTER_METHOD, device=key.device)


planmod.register_plan_backend(planmod.PlanBackend(
    name="codegen",
    available=_codegen_available,
    build=_build_codegen,
    description="generated CUDA pipeline: one streaming reduce pass -> "
                "l1ball theta-solve -> fused apply (kernels/codegen)",
))

planmod.register_plan_backend(planmod.PlanBackend(
    name="codegen_batch",
    available=_codegen_available,
    build=_build_codegen_batch,
    description="the generated CUDA pipeline over a serving bucket: the "
                "stacked batch is the kernels' leading launch axis",
    batch_native=True,
))


def _sharded_codegen_available(key: planmod.PlanKey) -> bool:
    # the mesh executor's gates (scalar radius, live mesh) plus the kernels'
    # (a CUDA key whose shard-local schedule splices and tiles)
    if key.device != "cuda" or not planmod._sharded_available(key):
        return False
    from .codegen import distributed as dist

    return dist.shardable(key.shape, key.levels, key.sharding.spec,
                          planmod._key_mesh(key),
                          planmod.torch_dtype(key.dtype))


def _build_sharded_codegen(key: planmod.PlanKey):
    from repro_torch.core import sharded as shmod

    return planmod._sharded_fn(key, "codegen", shmod)


planmod.register_plan_backend(planmod.PlanBackend(
    name="sharded_codegen",
    available=_sharded_codegen_available,
    build=_build_sharded_codegen,
    description="mesh executor with the generated CUDA kernels as its "
                "shard-local stages: the 'sharded' collective plan, one "
                "streaming reduce and one fused apply (or the partial apply "
                "after the distributed bisection) per shard "
                "(kernels/codegen/distributed.py)",
))
