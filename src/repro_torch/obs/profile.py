"""Profiler plumbing: the schedule-stage named scopes (port of
``repro/obs/profile.py``).

The schedule executor and the codegen pipeline wrap each stage in a
``torch.profiler.record_function`` range named ``proj/...`` — the same names
the JAX package gives its ``jax.named_scope``s — so a ``torch.profiler``
trace attributes host and device time to the reduce, θ-solve and apply
stages. Outside an active profiler a range costs one cheap host call.

:func:`device_summary` reads such a trace back: the device work of one
step of the train launcher (``launch/train.py --profile-dir``), by kernel
and by kind, and the step's device idle share. From the command line:

    python -m repro_torch.obs.profile TRACE.json [--step -1] [--top 25]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import sys

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


def host_span(name: str):
    """A host-only range for work outside the device stream (dispatcher
    picks, plan builds): a ``record_function`` named ``name``."""
    return torch.profiler.record_function(name)


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


# device work by kind: the first pattern found in a kernel's name decides
KINDS = (
    ("flash", ("flash_",)),
    ("optimizer", ("multi_tensor_apply", "foreach")),
    ("projection", ("apply_kernel", "namespace)::reduce_kernel", "reduce_finalize",
                    "l1ball_kernel", "clip_kernel", "colmax_kernel", "trilevel_")),
    ("matmul", ("gemm", "nvjet", "xmma", "cutlass", "cublas", "splitKreduce")),
    ("softmax/loss", ("softmax", "SoftMax", "nll_loss", "cross_entropy")),
    ("reduction", ("reduce_kernel",)),
    ("index", ("index", "gather", "scatter", "embedding", "Embedding")),
    ("copy", ("Memcpy", "Memset", "copy", "Copy", "CatArray", "transpose")),
    ("elementwise", ("elementwise",)),
)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
STEP_SYNC = "cudaDeviceSynchronize"  # the train launcher syncs once per step


def kind_of(name: str) -> str:
    for kind, keys in KINDS:
        if any(k in name for k in keys):
            return kind
    return "other"


def _busy_us(spans) -> float:
    """Length of the union of (start, end) spans: time in which some device
    operation ran, on any stream."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def device_summary(trace, step: int = -1, top: int = 25) -> dict:
    """The device operations of one step of a ``torch.profiler`` Chrome
    trace of the train launcher.

    The ``cudaDeviceSynchronize`` calls cut the trace into windows, each
    from the end of one (the trace's start for the first) to the end of the
    next; every device operation that starts inside a window is its own (a
    step's kernels end before its sync returns). The steps are the windows
    that hold a kernel (the launcher's loss readback after the last step
    and the profiler's own closing sync make a window with none), and
    ``step`` indexes them. Returns the window, the device's busy time (the
    union of the operations' spans) and idle share, the time by kind
    (:data:`KINDS`) and the ``top`` operations by total time, all in
    milliseconds."""
    with open(trace) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    ends = sorted(e["ts"] + e["dur"] for e in events if e.get("name") == STEP_SYNC)
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    cuts = [min(e["ts"] for e in events)] + ends
    windows = [(a, b) for a, b in zip(cuts, cuts[1:])
               if any(a <= e["ts"] < b and e["cat"] == "kernel" for e in device)]
    if not windows:
        raise ValueError(f"{trace}: no kernel between {STEP_SYNC} calls, so no "
                         "step to cut out")
    k = step % len(windows)
    t0, t1 = windows[k]
    ops = [e for e in device if t0 <= e["ts"] < t1]
    by_name, by_kind = {}, {}
    for e in ops:
        ms, n = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (ms + e["dur"] / 1e3, n + 1)
    for name, (ms, n) in by_name.items():
        kms, kn = by_kind.get(kind_of(name), (0.0, 0))
        by_kind[kind_of(name)] = (kms + ms, kn + n)
    busy = _busy_us([(e["ts"], e["ts"] + e["dur"]) for e in ops]) / 1e3
    window = (t1 - t0) / 1e3
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {
        "step": k, "steps": len(windows), "window_ms": window,
        "device_busy_ms": busy, "idle_share": 1.0 - busy / window if window else 0.0,
        "operations": len(ops),
        "device_ms": sum(ms for ms, _ in by_name.values()),
        "by_kind": {kd: {"ms": ms, "count": n} for kd, (ms, n) in
                    sorted(by_kind.items(), key=lambda kv: -kv[1][0])},
        "top": [{"name": name, "kind": kind_of(name), "ms": ms, "count": n}
                for name, (ms, n) in ranked],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="device work of one step of a "
                                 "torch.profiler trace of the train launcher")
    ap.add_argument("trace", help="trace.json written by --profile-dir")
    ap.add_argument("--step", type=int, default=-1,
                    help="which step (default: the last)")
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)
    summary = device_summary(args.trace, args.step, args.top)
    print(f"step {summary['step']} of {summary['steps']}: window "
          f"{summary['window_ms']:.3f} ms, device busy "
          f"{summary['device_busy_ms']:.3f} ms (idle share "
          f"{summary['idle_share']:.4f}), {summary['operations']} operations")
    for kind, v in summary["by_kind"].items():
        print(f"  {kind:<13} {v['ms']:10.3f} ms  x{v['count']}")
    for e in summary["top"]:
        print(f"  {e['ms']:10.3f} ms  x{e['count']:<6} [{e['kind']}] {e['name'][:160]}")
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
