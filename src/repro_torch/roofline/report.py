"""The dry run's tables from its records (port of
``repro/roofline/report.py``): one JSON per cell in a directory, as
``launch/dryrun.py`` writes them.

    PYTHONPATH=src python -m repro_torch.roofline.report experiments/dryrun_torch

The tables are the strings the JAX package renders for the same records. A
serving cell's collective term may be None (the port serves on one
device; ``launch/specs.py``): it prints as "-", and :func:`pick_hillclimb`
counts it as 0.
"""

from __future__ import annotations

import glob
import json
import sys


def _fmt_t(seconds):
    if seconds is None:
        return "-"
    return f"{seconds * 1e3:.0f}ms" if seconds < 10 else f"{seconds:.1f}s"


def _fmt_b(b):
    if b is None:
        return "-"
    for unit in ("B", "KB", "MB", "GB", "TB", "PB"):
        if abs(b) < 1024:
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}EB"


def load(out_dir):
    recs = [json.load(open(f)) for f in sorted(glob.glob(f"{out_dir}/*.json"))]
    return sorted(recs, key=lambda r: (r["arch"], r["shape"], r["mesh"]))


def roofline_table(recs, mesh="single"):
    lines = [
        "| arch | shape | compute | memory | collective | bottleneck | "
        "HLO TFLOPs | MODEL/HLO | HBM/dev |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r["mesh"] != mesh:
            continue
        if r["status"] == "skipped":
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                         f"skipped: sub-quadratic required | — | — | — |")
            continue
        if r["status"] != "ok":
            lines.append(f"| {r['arch']} | {r['shape']} | ERROR: "
                         f"{r.get('error','')[:60]} | | | | | | |")
            continue
        rf = r["roofline"]
        mem = r.get("memory", {})
        perdev = (mem.get("argument_bytes") or 0) + (mem.get("temp_bytes") or 0)
        ratio = r.get("useful_ratio")
        lines.append(
            f"| {r['arch']} | {r['shape']} | {_fmt_t(rf['t_compute'])} | "
            f"{_fmt_t(rf['t_memory'])} | {_fmt_t(rf['t_collective'])} | "
            f"**{rf['bottleneck']}** | {rf['flops_global'] / 1e12:.0f} | "
            f"{ratio:.2f} | {_fmt_b(perdev)} |" if ratio else
            f"| {r['arch']} | {r['shape']} | {_fmt_t(rf['t_compute'])} | "
            f"{_fmt_t(rf['t_memory'])} | {_fmt_t(rf['t_collective'])} | "
            f"**{rf['bottleneck']}** | {rf['flops_global'] / 1e12:.0f} | "
            f"- | {_fmt_b(perdev)} |")
    return "\n".join(lines)


def dryrun_table(recs):
    lines = [
        "| arch | shape | mesh | status | compile | args/dev | temp/dev | "
        "collective schedule (bytes/dev) |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r["status"] == "skipped":
            lines.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                         f"SKIP | — | — | — | {r['reason'][:60]} |")
            continue
        if r["status"] != "ok":
            lines.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                         f"ERROR | — | — | — | {r.get('error','')[:60]} |")
            continue
        mem = r.get("memory", {})
        chips = r.get("chips", 1)
        coll = r["roofline"]["coll_breakdown"]
        coll_s = ", ".join(f"{k}:{_fmt_b(v)}" for k, v in
                           sorted(coll.items(), key=lambda kv: -kv[1]))
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok | "
            f"{r.get('compile_s', 0):.0f}s | "
            f"{_fmt_b((mem.get('argument_bytes') or 0) / chips * chips / chips)} | "
            f"{_fmt_b((mem.get('temp_bytes') or 0) / chips * chips / chips)} | "
            f"{coll_s[:110]} |")
    return "\n".join(lines)


def pick_hillclimb(recs):
    """The three §Perf cells: worst compute fraction, most collective-bound,
    and the paper-representative train cell."""
    ok = [r for r in recs if r["status"] == "ok" and r["mesh"] == "single"]

    def frac_compute(r):
        rf = r["roofline"]
        tot = rf["t_compute"] + rf["t_memory"] + (rf["t_collective"] or 0)
        return rf["t_compute"] / tot if tot else 0

    worst = min(ok, key=frac_compute)
    coll = max(ok, key=lambda r: r["roofline"]["t_collective"] or 0)
    return worst, coll


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    out_dir = argv[0] if argv else "experiments/dryrun_torch"
    recs = load(out_dir)
    print("## §Dry-run\n")
    print(dryrun_table(recs))
    print("\n## §Roofline (single: 256 H100s, 32 × 8)\n")
    print(roofline_table(recs, "single"))
    print("\n## §Roofline (multi: 512 H100s, 2 × 32 × 8)\n")
    print(roofline_table(recs, "multi"))
    if not any(r["status"] == "ok" and r["mesh"] == "single" for r in recs):
        return
    worst, coll = pick_hillclimb(recs)
    print(f"\nworst-compute-fraction cell: {worst['arch']} × {worst['shape']}")
    print(f"most collective-bound cell:  {coll['arch']} × {coll['shape']}")


if __name__ == "__main__":
    main()
