"""Fill the dry run's and hillclimb's tables into a markdown template (port
of ``repro/roofline/fill_experiments.py``): each ``<!-- MARKER -->`` of the
template is replaced by its table, and the result written where asked.

    PYTHONPATH=src python -m repro_torch.roofline.fill_experiments \
        TEMPLATE.md OUT.md --dryrun experiments/dryrun_torch \
        --hillclimb experiments/hillclimb_torch

Markers: ``<!-- DRYRUN_MEMORY -->``, ``<!-- ROOFLINE_TABLE -->`` and one
``<!-- PERF_<PREFIX> -->`` per hillclimb cell (``PERF_STABLELM``,
``PERF_SAE_FACTORY``, ...). The JAX package's verdict notes judged its TPU
cost model and are not carried over: a table's notes come from the caller
and default to none.
"""

from __future__ import annotations

import argparse
import glob
import json
from typing import Dict, Optional

from .report import _fmt_b, _fmt_t, load, roofline_table

CARD_BYTES = 80 * 10**9     # an H100 SXM's HBM3
CELLS = (  # marker, variant prefix, baseline (arch, shape)
    ("<!-- PERF_STABLELM -->", "stablelm", "stablelm-1.6b", "train_4k"),
    ("<!-- PERF_SAE_FACTORY -->", "sae_factory", "sae_factory", "train_4k"),
)


def memory_rows(recs):
    """Per single-mesh train_4k and decode_32k cell: arguments and
    temporaries per device, and whether they fit the card's 80 GB."""
    lines = ["| cell | args/dev | temp/dev | fits 80 GB? |",
             "|---|---|---|---|"]
    for r in recs:
        if r["status"] != "ok" or r["mesh"] != "single":
            continue
        if r["shape"] not in ("train_4k", "decode_32k"):
            continue
        mem = r["memory"]
        tot = (mem.get("argument_bytes") or 0) + (mem.get("temp_bytes") or 0)
        fits = "✓" if tot <= CARD_BYTES else f"✗ ({_fmt_b(tot)})"
        lines.append(f"| {r['arch']} × {r['shape']} | "
                     f"{_fmt_b(mem.get('argument_bytes') or 0)} | "
                     f"{_fmt_b(mem.get('temp_bytes') or 0)} | {fits} |")
    return "\n".join(lines)


def perf_table(base_rec, variants, notes: Optional[Dict[str, str]] = None):
    """Baseline and variant rows, the change of the baseline's dominant
    term, and the caller's note per variant (none by default)."""
    notes = notes or {}
    rf0 = base_rec["roofline"]
    lines = [
        "| variant | compute | memory | collective | Δ dominant | verdict |",
        "|---|---|---|---|---|---|",
        f"| baseline | {_fmt_t(rf0['t_compute'])} | {_fmt_t(rf0['t_memory'])} "
        f"| {_fmt_t(rf0['t_collective'])} | — | (paper-faithful) |",
    ]
    dom = rf0["bottleneck"]
    key = f"t_{dom}"
    for v in variants:
        rf = v["roofline"]
        delta = (rf[key] - rf0[key]) / rf0[key] * 100
        note = notes.get(v["variant"], "")
        lines.append(
            f"| {v['variant']} | {_fmt_t(rf['t_compute'])} | "
            f"{_fmt_t(rf['t_memory'])} | {_fmt_t(rf['t_collective'])} | "
            f"{delta:+.0f}% {dom} | {note} |")
    return "\n".join(lines)


def fill(text: str, recs, hillclimb, notes=None) -> str:
    """``text`` with every marker replaced; ``hillclimb`` maps a variant's
    name to its record (the baseline of the SAE factory's cell is its
    ``sae_factory`` variant)."""
    by = {(r["arch"], r["shape"], r["mesh"]): r for r in recs}
    text = text.replace("<!-- DRYRUN_MEMORY -->", memory_rows(recs))
    text = text.replace("<!-- ROOFLINE_TABLE -->", roofline_table(recs, "single"))
    for marker, prefix, arch, shape in CELLS:
        base = by.get((arch, shape, "single")) or hillclimb.get(arch)
        variants = [hillclimb[k] for k in sorted(hillclimb)
                    if k.startswith(prefix) and k != arch]
        if base and variants:
            text = text.replace(marker, perf_table(base, variants, notes))
    return text


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("template")
    ap.add_argument("out")
    ap.add_argument("--dryrun", default="experiments/dryrun_torch")
    ap.add_argument("--hillclimb", default="experiments/hillclimb_torch")
    args = ap.parse_args(argv)
    hc = {}
    for f in glob.glob(f"{args.hillclimb}/*.json"):
        with open(f) as fh:
            v = json.load(fh)
        hc[v["variant"]] = v
    with open(args.template) as f:
        text = f.read()
    with open(args.out, "w") as f:
        f.write(fill(text, load(args.dryrun), hc))
    print(f"{args.out} written")


if __name__ == "__main__":
    main()
