"""CLI for the sparse-SAE training factory of the port
(``training/sae_factory.py``).

    PYTHONPATH=src python -m repro_torch.launch.sae_factory \\
        --arch stablelm-1.6b --out /tmp/sae_run --layers 0,2 \\
        --train-steps 200 --expansion 8

Runs harvest (through the flash-attention kernel on the card; ``--attn
chunked`` or ``naive`` for the PyTorch paths, which an MLA model such as
deepseek-v3-671b needs) → projected SAE training (one per layer × seed) →
MMCS cross-comparison and writes ``summary.json`` and ``metrics.jsonl``
into ``--out``. ``--full`` harvests from the full-size architecture
instead of its smoke config; ``--device cpu`` runs the plain PyTorch paths
on the CPU (the default is the card).
``--checkpoint DIR`` harvests from the LM parameters of the latest
``runtime/checkpoint`` state there (a training state's ``params``, or a bare
parameter tree), for example one the JAX launcher wrote. ``--gsp`` also
runs the whole-network GSP sparsification pass (every weight of the LM
projected per step); started by torchrun with several ranks, that pass
spans a (1, world) mesh — the mesh executor path, as the JAX CLI's
``make_host_mesh(1, n_dev)`` — and runs first, on every rank; then the
factory's stages and the summary run on rank 0 (every rank looks for the
``--checkpoint`` first, and all return 1 when there is none):

    torchrun --nproc-per-node 4 -m repro_torch.launch.sae_factory \\
        --out /tmp/sae_run --gsp
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
    ap.add_argument("--checkpoint", default="",
                    help="checkpoint dir to harvest from (runtime/checkpoint "
                         "layout); default: seeded init weights")
    ap.add_argument("--seeds", default="0,1")
    ap.add_argument("--full", action="store_true",
                    help="full-size arch (default: smoke config)")
    ap.add_argument("--gsp", action="store_true",
                    help="also run whole-network GSP sparsification")
    ap.add_argument("--profile-dir", default="",
                    help="capture a torch.profiler trace of the factory run "
                         "(projection stages appear as proj/* ranges)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the LM and the SAEs run (cpu: the plain "
                         "PyTorch paths)")
    ap.add_argument("--attn", default="flash",
                    choices=["naive", "chunked", "flash"],
                    help="the harvest's attention (flash: the CUDA kernels "
                         "on the card; MLA models need chunked or naive)")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import profile as obs_profile
    from repro_torch.runtime import CheckpointManager
    from repro_torch.training import sae_factory as F

    device, mesh, rank = args.device, None, 0
    if args.gsp and dist.is_torchelastic_launched():
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.launch.train import join_world

        device = join_world(None, args.device)
        if dist.get_world_size() > 1:
            mesh = make_host_mesh(1, dist.get_world_size())
            rank = mesh.rank
    fcfg = F.SAEFactoryConfig(
        arch=args.arch, smoke=not args.full, site=args.site,
        layers=tuple(int(x) for x in args.layers.split(",") if x) or None,
        harvest_steps=args.harvest_steps, train_steps=args.train_steps,
        expansion=args.expansion, radius=args.radius, heads=args.heads)
    out = pathlib.Path(args.out)
    seeds = tuple(int(s) for s in args.seeds.split(","))
    lm_params = None
    if args.checkpoint:
        # every rank looks, so that none goes on into GSP's collectives alone
        mgr = CheckpointManager(args.checkpoint)
        if mgr.latest_step() is None:
            if rank == 0:
                print(f"no checkpoint found under {args.checkpoint}",
                      file=sys.stderr)
            return 1
        if rank == 0:
            tree, manifest = mgr.restore(device=device)
            # training states store {"params", "opt"}; bare param trees pass
            lm_params = tree["params"] if (isinstance(tree, dict)
                                           and "params" in tree) else tree
            print(f"harvesting from checkpoint step "
                  f"{manifest.get('step', '?')} at {args.checkpoint}")
    gsp = None
    with obs_profile.capture(args.profile_dir):
        if args.gsp:  # every rank, before rank 0 goes on alone
            gsp = F.gsp_whole_network(args.arch, mesh=mesh, device=device)
        if rank != 0:
            return 0
        out.mkdir(parents=True, exist_ok=True)
        summary = F.run_factory(fcfg, out, seeds=seeds, lm_params=lm_params,
                                device=device, impl=args.attn)
    if gsp is not None:
        summary["gsp"] = gsp
    obs_metrics.get_registry().write_jsonl(out / "metrics.jsonl")
    # json keys must be strings; layers come out as ints
    summary["layers"] = {str(k): v for k, v in summary["layers"].items()}
    (out / "summary.json").write_text(json.dumps(summary, indent=1,
                                                 default=str) + "\n")
    for layer, rec in summary["layers"].items():
        feasible = all(c["feasible"] for c in rec["constraint"].values())
        print(f"layer {layer}: mmcs={rec['mmcs']} feasible={feasible}")
    if args.gsp:
        g = summary["gsp"]
        print(f"gsp: n_projected={g['n_projected']} feasible={g['feasible']} "
              f"mean_col_sparsity={g['mean_col_sparsity']:.1f}%")
    return 0


if __name__ == "__main__":
    sys.exit(main())
