"""CLI for the sparse-SAE training factory of the port
(``training/sae_factory.py``).

    PYTHONPATH=src python -m repro_torch.launch.sae_factory \\
        --arch stablelm-1.6b --out /tmp/sae_run --layers 0,2 \\
        --train-steps 200 --expansion 8

Runs harvest (through the flash-attention kernel on the card) → projected
SAE training (one per layer × seed) → MMCS cross-comparison and writes
``summary.json`` and ``metrics.jsonl`` into ``--out``. ``--full`` harvests
from the full-size architecture instead of its smoke config; ``--device
cpu`` runs the plain PyTorch paths on the CPU (the default is the card).
The JAX CLI's ``--gsp`` (whole-network sparsification, needs the mesh
executor) and ``--checkpoint`` (needs ``runtime/checkpoint``) wait for their
slices.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--out", required=True)
    ap.add_argument("--site", default="resid", choices=["resid", "mlp"])
    ap.add_argument("--layers", default="",
                    help="comma list of layer indices; empty = all")
    ap.add_argument("--harvest-steps", type=int, default=4)
    ap.add_argument("--train-steps", type=int, default=40)
    ap.add_argument("--expansion", type=int, default=4)
    ap.add_argument("--radius", type=float, default=1.0)
    ap.add_argument("--heads", type=int, default=1,
                    help=">1: head-structured dictionary — 3-D encoder "
                         "projected onto the tri-level l1,inf,inf ball")
    ap.add_argument("--seeds", default="0,1")
    ap.add_argument("--full", action="store_true",
                    help="full-size arch (default: smoke config)")
    ap.add_argument("--profile-dir", default="",
                    help="capture a torch.profiler trace of the factory run "
                         "(projection stages appear as proj/* ranges)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the LM and the SAEs run (cpu: the plain "
                         "PyTorch paths)")
    args = ap.parse_args(argv)

    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import profile as obs_profile
    from repro_torch.training import sae_factory as F

    fcfg = F.SAEFactoryConfig(
        arch=args.arch, smoke=not args.full, site=args.site,
        layers=tuple(int(x) for x in args.layers.split(",") if x) or None,
        harvest_steps=args.harvest_steps, train_steps=args.train_steps,
        expansion=args.expansion, radius=args.radius, heads=args.heads)
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    seeds = tuple(int(s) for s in args.seeds.split(","))
    with obs_profile.capture(args.profile_dir):
        summary = F.run_factory(fcfg, out, seeds=seeds, device=args.device)
    obs_metrics.get_registry().write_jsonl(out / "metrics.jsonl")
    # json keys must be strings; layers come out as ints
    summary["layers"] = {str(k): v for k, v in summary["layers"].items()}
    (out / "summary.json").write_text(json.dumps(summary, indent=1,
                                                 default=str) + "\n")
    for layer, rec in summary["layers"].items():
        feasible = all(c["feasible"] for c in rec["constraint"].values())
        print(f"layer {layer}: mmcs={rec['mmcs']} feasible={feasible}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
