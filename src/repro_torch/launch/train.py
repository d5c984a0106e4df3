"""Training launcher of the port (``repro/launch/train.py``'s CLI).

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
        --batch 8 --microbatch 4 --seq 2048 --steps 50 --radius 30 \\
        --ckpt /tmp/run1

trains the LM on the card (``--device cpu`` runs the plain PyTorch paths;
``--smoke`` the reduced config): state init (or restore from the latest
checkpoint in ``--ckpt``), the deterministic data pipeline, the projected
train step with the fused AdamW+project epilogue, async checkpointing every
``--ckpt-every`` steps and a final save (skipped when the loop has just
written the last step: the JAX launcher writes that state twice), the
straggler monitor, and the
paper's bi-level ℓ1,∞ constraint on ``(w_up|w_gate)`` when ``--radius > 0``.
It prints the JAX launcher's lines: ``step N loss L gnorm G`` every 10
steps and at the last, and ``column sparsity <leaf>: x%``.

Attention runs ``impl="flash"``: the hand-written CUDA forward and dQ /
dK/dV backward kernels on the card, the counterpart of the JAX package's
``"pallas"`` (the JAX launcher trains with ``"chunked"``, or ``"naive"``
under ``--smoke``). ``--mesh`` takes only ``1x1`` (the mesh executor is in,
but a train step sharded over it waits for its slice) and
``--telemetry-every``/``--telemetry-marks`` raise (the telemetry bridge
waits for its slice).
"""

from __future__ import annotations

import argparse
import sys
import time


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-friendly)")
    ap.add_argument("--mesh", default="1x1",
                    help="only 1x1: the port trains on one device")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--radius", type=float, default=0.0,
                    help=">0 enables the bi-level l1,inf constraint")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--profile-dir", default="",
                    help="capture a torch.profiler trace of the run here "
                         "(schedule stages show up as proj/* ranges)")
    ap.add_argument("--telemetry-every", type=int, default=0,
                    help="not ported: raises when set")
    ap.add_argument("--telemetry-marks", action="store_true",
                    help="not ported: raises when set")
    ap.add_argument("--metrics-out", default="",
                    help="write the final obs-registry snapshot (JSON lines) "
                         "to this path")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to train (cpu: the plain PyTorch paths)")
    return ap


def run(argv=None) -> dict:
    """Parse ``argv``, train, and return ``{"state", "losses",
    "grad_norms", "step_seconds", "start", "sparsity"}`` (one entry per step
    run; ``sparsity`` is the printed column sparsity per projected leaf)."""
    args = _parser().parse_args(argv)
    if args.mesh != "1x1":
        raise ValueError(f"--mesh {args.mesh}: the port trains on one device "
                         "(1x1); a train step sharded over the mesh executor "
                         "waits for its slice")
    if args.telemetry_every > 0 or args.telemetry_marks:
        raise ValueError("--telemetry-every/--telemetry-marks: the in-step "
                         "telemetry bridge waits for its slice")

    import torch

    from repro_torch import _device, models
    from repro_torch.configs import registry
    from repro_torch.configs.types import ProjectionSpec, TrainConfig
    from repro_torch.data import DataConfig, DataPipeline
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import profile as obs_profile
    from repro_torch.optim.projection_hook import tree_sparsity
    from repro_torch.runtime import CheckpointManager, StragglerMonitor
    from repro_torch.training import init_state, make_train_step

    dev = _device.resolve(args.device)
    cfg = (registry.smoke_config(args.arch) if args.smoke
           else registry.get_arch(args.arch))
    api = models.get(cfg)
    micro = args.microbatch or args.batch
    proj = None
    if args.radius > 0:
        proj = ProjectionSpec(pattern=r"(w_up|w_gate)", radius=args.radius)
    tcfg = TrainConfig(microbatch=micro, lr=args.lr, total_steps=args.steps,
                       warmup=min(20, args.steps // 5 + 1), remat=not args.smoke,
                       master_dtype="", projection=proj,
                       checkpoint_every=args.ckpt_every)

    pipe = DataPipeline(DataConfig(vocab=cfg.vocab, seq_len=args.seq + 1,
                                   global_batch=args.batch, microbatch=micro))
    mgr = CheckpointManager(args.ckpt, keep=3) if args.ckpt else None
    mon = StragglerMonitor(n_hosts=1)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    state, start = None, 0
    if mgr:
        state, manifest = mgr.restore(device=dev)
        if state is not None:
            start = manifest["step"]
            print(f"[elastic restart] resuming from step {start}")
    if state is None:
        state = init_state(cfg, tcfg, api, tcfg.seed, device=dev)
    step_hist = obs_metrics.get_registry().histogram(
        "train_step_seconds", "end-to-end wall time of one training step")
    step_fn = make_train_step(cfg, tcfg, api, impl="flash")
    out = {"losses": [], "grad_norms": [], "step_seconds": [], "start": start}
    saved = None
    with obs_profile.capture(args.profile_dir):
        for step in range(start, args.steps):
            t0 = time.perf_counter()
            batch = {"tokens": torch.from_numpy(pipe.batch(step)).to(dev)}
            state, metrics = step_fn(state, batch)
            sync()
            dt = time.perf_counter() - t0
            step_hist.observe(dt)
            rep = mon.record({0: dt})
            loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
            out["losses"].append(loss)
            out["grad_norms"].append(gnorm)
            out["step_seconds"].append(dt)
            if mgr and (step + 1) % tcfg.checkpoint_every == 0:
                mgr.save_async(step + 1, state)
                saved = step + 1
            if (step + 1) % 10 == 0 or step + 1 == args.steps:
                msg = f"step {step + 1:5d} loss {loss:.4f} gnorm {gnorm:.2f}"
                if rep.action != "none":
                    msg += f"  [straggler watch: {rep.stragglers}]"
                print(msg)
    if mgr:
        if saved != args.steps:
            mgr.save(args.steps, state)
        mgr.wait()
    out["sparsity"] = {}
    if proj:
        for name, sp in tree_sparsity(state["params"], proj).items():
            out["sparsity"][name] = float(sp)
            print(f"column sparsity {name}: {float(sp):.1f}%")
    if args.metrics_out:
        obs_metrics.get_registry().write_jsonl(args.metrics_out)
        print(f"metrics snapshot -> {args.metrics_out}")
    if args.profile_dir:
        print(f"profiler trace -> {args.profile_dir} "
              f"({len(obs_profile.trace_files(args.profile_dir))} files)")
    out["state"] = state
    return out


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
