"""Profiler plumbing: the schedule-stage named scopes (port of
``repro/obs/profile.py``).

The schedule executor and the codegen pipeline wrap each stage in a
``torch.profiler.record_function`` range named ``proj/...`` — the same names
the JAX package gives its ``jax.named_scope``s — so a ``torch.profiler``
trace attributes host and device time to the reduce, θ-solve and apply
stages. Outside an active profiler a range costs one cheap host call.
"""

from __future__ import annotations

import contextlib
import pathlib

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



@contextlib.contextmanager
def capture(path):
    """Capture a ``torch.profiler`` trace of the block (CPU, and CUDA when a
    card is present) into ``path``/``trace.json`` (Chrome trace format).

    ``path`` falsy (None/"") disables capture — launchers pass their
    ``--profile-dir`` flag through unconditionally."""
    if not path:
        yield None
        return
    out = pathlib.Path(path)
    out.mkdir(parents=True, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield out
    prof.export_chrome_trace(str(out / "trace.json"))


def trace_files(path):
    """The capture artifacts under ``path`` (recursive; files only)."""
    root = pathlib.Path(path)
    return sorted(p for p in root.rglob("*") if p.is_file())
