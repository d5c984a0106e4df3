"""The generated CUDA pipeline as projection-planner backends (port of
``repro/kernels/plan_backends.py``).

Importing this module registers ``codegen`` (one item per call) and
``codegen_batch`` (a serving bucket per call: the batch is the kernels'
leading launch axis, one radius per item) with ``repro_torch.core.plan``.
Both are available for a plan key on ``"cuda"`` whose design the Hopper
tiler accepts; ``codegen_batch`` is batch-native, so only
``radius_kind="batch"`` keys see it. The planner imports this module on
first use and lets any import error propagate.
"""

from __future__ import annotations

from repro_torch.core import plan as planmod

from . import codegen

# the outer θ-solve: "bisect" has no data-dependent sweep count (stable
# latency for a served plan)
_OUTER_METHOD = "bisect"


def _codegen_available(key: planmod.PlanKey) -> bool:
    return key.device == "cuda" and codegen.supported(key.shape, key.levels,
                                                      key.dtype)


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
