"""Profiler plumbing: the schedule-stage named scopes (port of
``repro/obs/profile.py``).

The schedule executor and the codegen pipeline wrap each stage in a
``torch.profiler.record_function`` range named ``proj/...`` — the same names
the JAX package gives its ``jax.named_scope``s — so a ``torch.profiler``
trace attributes host and device time to the reduce, θ-solve and apply
stages. Outside an active profiler a range costs one cheap host call.
"""

from __future__ import annotations

import torch

SCOPE_PREFIX = "proj"


def stage_name(step, index: int | None = None) -> str:
    """Scope name for one schedule step: ``proj/reduce0_inf``,
    ``proj/solve_1``, ``proj/apply0_inf``."""
    kind = type(step).__name__
    if kind == "ReduceLevel":
        return f"{SCOPE_PREFIX}/reduce{index}_{step.norm}"
    if kind == "OuterSolve":
        return f"{SCOPE_PREFIX}/solve_{step.norm}"
    if kind == "ApplyGroup":
        return f"{SCOPE_PREFIX}/apply{index}_{step.norm}"
    raise TypeError(f"not a schedule step: {step!r}")


def stage_scope(step, index: int | None = None):
    """``record_function`` range for one schedule step."""
    return torch.profiler.record_function(stage_name(step, index))


def scope(name: str):
    """A raw ``proj/``-prefixed range (codegen pipeline stages)."""
    return torch.profiler.record_function(f"{SCOPE_PREFIX}/{name}")

