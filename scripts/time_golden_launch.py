#!/usr/bin/env python3
"""Time the bi-level golden wrappers' launch path on one card.

    python3 scripts/time_golden_launch.py [--tree DIR]

imports ``repro_torch`` from ``DIR/src`` (default: this checkout), builds
that tree's ``csrc/bilevel_l1inf.cu`` and, at W1 (8192, 2048) and W3
(1000, 10000) float32, times ``clip`` and ``colmax`` beside one PyTorch
call each (``torch.clamp`` with the bounds precomputed, the ℓ∞
``torch.linalg.vector_norm`` over the rows) with ``chip_smoke.py``'s
timers: the CUDA-event time of a lone call (median of 100), its
CUDA-graph replay (the device's time alone, median of 100) and the host
time per call (median of 5 runs of 200 calls enqueued back to back). Each
output is held equal to the plain version first. The timers are this
checkout's whichever tree is timed, so trees are timed alike; to compare
two, time each in its own process on one machine, in the order a, b, b, a:

    for t in a b b a; do python3 scripts/time_golden_launch.py --tree $t; done

Prints the card's name and power limit (``nvidia-smi``), then one JSON
line. Exits 2 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = {"W1": (8192, 2048), "W3": (1000, 10000)}  # chip_smoke.py's W1, W3
SEED = 0
REPS = 100                     # lone calls (and replays) per event median
HOST_RUNS = 5                  # host time per call: median of 5 runs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path, default=ROOT,
                    help="checkout whose src/repro_torch is timed")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("time_golden_launch: no CUDA device", file=sys.stderr)
        return 2
    tree = args.tree.resolve()
    sys.path.insert(0, str(ROOT))           # chip_smoke.py's timers
    sys.path.insert(0, str(tree / "src"))   # the tree under test
    import chip_smoke as cs
    from repro_torch.kernels import bilevel_l1inf as bi

    if not Path(bi.__file__).resolve().is_relative_to(tree):
        raise SystemExit(f"imported {bi.__file__}, not {tree}'s")
    bi.COLMAX.lib(), bi.CLIP.lib()          # build and load off the clock
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = {}
    for wl, shape in SHAPES.items():
        y = torch.randn(shape, generator=gen, device="cuda") * 2.0
        u = bi.colmax_plain(y) * (0.2 + 0.6 * torch.rand(
            shape[1:], generator=gen, device="cuda"))
        lo, hi = -u[None, :], u[None, :]
        cases = {  # kernel, plain, library
            "clip": (lambda: bi.clip(y, u), lambda: bi.clip_plain(y, u),
                     lambda: torch.clamp(y, lo, hi)),
            "colmax": (lambda: bi.colmax(y), lambda: bi.colmax_plain(y),
                       lambda: torch.linalg.vector_norm(y, float("inf"), dim=0)),
        }
        for name, (kern, plain, lib) in cases.items():
            want = plain()
            cs.check_exact(f"{wl} {name}", kern(), want)
            cs.check_exact(f"{wl} {name} library call", lib(), want)
            for who, fn in (("kernel", kern), ("library", lib)):
                rows[f"{wl} {name} {who}"] = {
                    "ms": cs.event_ms(fn, REPS),
                    "graph_ms": cs.graph_ms(fn, REPS),
                    "host_ms": statistics.median(
                        cs.host_call_ms(fn) for _ in range(HOST_RUNS))}
    print(smi)
    print(json.dumps({"tree": str(tree), "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
