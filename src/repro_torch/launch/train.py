"""Training launcher of the port (``repro/launch/train.py``'s CLI).

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
        --batch 8 --microbatch 4 --seq 2048 --steps 50 --radius 30 \\
        --ckpt /tmp/run1

trains the LM on the card (``--device cpu`` runs the plain PyTorch paths;
``--smoke`` the reduced config): state init (or restore from the latest
checkpoint in ``--ckpt``), the deterministic data pipeline, the projected
train step, async checkpointing every ``--ckpt-every`` steps and a final
save (skipped when the loop has just written the last step: the JAX
launcher writes that state twice), the straggler monitor, and the
paper's bi-level ℓ1,∞ constraint on ``(w_up|w_gate|w_in)`` when ``--radius >
0``: the JAX launcher's ``(w_up|w_gate)`` on every dense and MoE model,
which have no ``w_in``, and on the recurrent ones also the Mamba2 and sLSTM
input projections (and, by ``re.search``, mLSTM's ``w_gates``).
It prints the JAX launcher's lines: ``step N loss L gnorm G`` every 10
steps and at the last, and ``column sparsity <leaf>: x%``.

``--mesh DxM`` (or ``PxDxM`` with a "pod" axis) beyond ``1x1`` trains the
sharded step over that mesh, one process per rank, started by torchrun:

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --mesh 2x2 ...

Each rank joins the world through torchrun's rendezvous (``env://``: its
``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``, and the card of
its ``LOCAL_RANK``), or uses a process group already initialised by its
caller: NCCL with one rank per card, gloo when the ranks outnumber the
cards (or on the CPU). The world must be the mesh's size. The parameters and AdamW's state are sharded by
``param_rules(mesh)`` (tensor parallel over "model", FSDP over "data"),
every rank draws the same ``pipe.batch(step)`` and keeps its slice, the
epilogue is the unfused one with the mesh-native projection, the straggler
monitor gets every rank's step time, and only rank 0 prints. A checkpoint
is the full tree in the JAX package's layout, gathered leaf by leaf and
written by rank 0, so it restores into the JAX package and onto any mesh:
on restore every rank loads it on the host and keeps its shard.

``--mesh 1x1`` is the single-device step with the fused AdamW+project
epilogue (the JAX launcher runs its mesh path, unfused, even at 1x1).

Attention runs ``--attn flash`` by default: the hand-written CUDA forward
and dQ / dK/dV backward kernels on the card, the counterpart of the JAX
package's ``"pallas"`` (the JAX launcher trains with ``"chunked"``, or
``"naive"`` under ``--smoke``); under a mesh on each rank's own heads.
``--attn chunked`` or ``naive`` run the PyTorch paths; an MLA model
(deepseek-v3-671b, kimi-k2-1t-a32b), whose q/k and v heads differ in
width, needs one of them. The recurrent families take no ``--attn`` on
one device, as in the JAX package: zamba2-7b's shared attention runs
chunked and xlstm-1.3b has none; under a mesh zamba2-7b's shared attention
takes ``--attn`` on each rank's heads. The launcher says which ran.
whisper-large-v3 (the audio family) trains on zero audio frames, as the
JAX package's does, with
``--attn`` in its encoder's and cross-attention's non-causal and its
decoder's causal attention, and the constraint on both stacks' ``w_up``.
With the constraint on, the launcher names the leaves it projects.
``--layers N`` (the port's own option) cuts the model to its first N
layers at full width (``models.lm.cut_depth``): an MoE model keeps its
dense leading layers and needs more than those, an xLSTM model whole
super-blocks of ``slstm_every`` layers, and whisper keeps N encoder and N
decoder layers. Every family trains under ``--mesh``: the dense and
MoE ones through ``models/lm.py``'s sharded forward (an MoE model's
experts and MLA heads over "model", its dispatch in ``dp_shards`` token
groups, JAX's), the audio, hybrid and recurrent ones through their own
(``models/whisper.py``, ``zamba.py``, ``xlstm.py``). ``--telemetry-every N`` /
``--telemetry-marks``
turn the in-step telemetry bridge (``obs/bridge.py``) on for the run and
give the step its cadence and marks (``training/step.py``); the pending
values are drained into the registry before the run returns.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-friendly)")
    ap.add_argument("--mesh", default="1x1",
                    help="DxM or PxDxM; beyond 1x1 one process per rank")
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
                    help=">0 enables the in-step telemetry bridge and "
                         "ships loss/grad-norm/sparsity/feasibility every "
                         "that many steps")
    ap.add_argument("--telemetry-marks", action="store_true",
                    help="also bracket the optimizer/projection epilogue "
                         "with a timing mark pair (device time on the card)")
    ap.add_argument("--metrics-out", default="",
                    help="write the final obs-registry snapshot (JSON lines) "
                         "to this path")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to train (cpu: the plain PyTorch paths)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the model to this many layers at full width "
                         "(0: the config's depth)")
    ap.add_argument("--attn", default="flash",
                    choices=["naive", "chunked", "flash"],
                    help="attention (flash: the CUDA kernels on the card; "
                         "MLA models need chunked or naive)")
    return ap


def mesh_dims(spec: str):
    """``(sizes, axis names)`` of ``DxM`` or ``PxDxM``."""
    dims = tuple(int(x) for x in spec.split("x"))
    if len(dims) == 2:
        return dims, ("data", "model")
    if len(dims) == 3:
        return dims, ("pod", "data", "model")
    raise ValueError(f"--mesh {spec!r}: expected DxM or PxDxM")


def parse_mesh(spec: str):
    """The ``parallel.mesh.Mesh`` of ``DxM`` or ``PxDxM`` over the
    initialized world (which must hold exactly that many ranks)."""
    from repro_torch.parallel.mesh import Mesh

    sizes, names = mesh_dims(spec)
    return Mesh(sizes, names)


def join_world(size, device: str):
    """Join the world and return this rank's device. A process group the
    caller initialized is used as it is (its current CUDA device); else a
    process that torchrun started initializes the default group from
    torchrun's rendezvous (``init_process_group``'s ``env://``, which reads
    ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``; the card
    is the node-local rank's): NCCL when the ``size`` ranks do not
    outnumber the cards, gloo when they do, on the CPU, or when ``size`` is
    None. Raises unless the world holds ``size`` ranks (any, for None)."""
    import torch
    import torch.distributed as dist

    cpu = device == "cpu"
    mine = not dist.is_initialized()
    if mine:
        if not dist.is_torchelastic_launched():
            raise ValueError(
                f"a mesh of {size} ranks needs one process per rank: start "
                "it with torchrun, or initialize the process group first "
                "(a sharded step never trains on one device)")
        local = dist.get_node_local_rank(fallback_rank=0)
        nccl = not cpu and size is not None and size <= torch.cuda.device_count()
        if nccl:
            torch.cuda.set_device(local)
        dist.init_process_group("nccl" if nccl else "gloo")
    if size is not None and dist.get_world_size() != size:
        raise ValueError(f"the mesh holds {size} ranks, the world "
                         f"{dist.get_world_size()}")
    if cpu:
        return torch.device("cpu")
    if dist.get_backend() == "nccl" or not mine:
        return torch.device("cuda", torch.cuda.current_device())
    local = dist.get_node_local_rank(fallback_rank=0)
    return torch.device("cuda", local % max(1, torch.cuda.device_count()))


def launch_config(args):
    """The ``TrainConfig`` of parsed arguments: bf16 compute, remat but
    under ``--smoke``, the constraint on ``(w_up|w_gate|w_in)`` when
    ``--radius > 0``."""
    from repro_torch.configs.types import ProjectionSpec, TrainConfig

    proj = None
    if args.radius > 0:
        proj = ProjectionSpec(pattern=r"(w_up|w_gate|w_in)", radius=args.radius)
    return TrainConfig(microbatch=args.microbatch or args.batch, lr=args.lr,
                       total_steps=args.steps,
                       warmup=min(20, args.steps // 5 + 1), remat=not args.smoke,
                       master_dtype="", projection=proj,
                       checkpoint_every=args.ckpt_every)


def run(argv=None) -> dict:
    """Parse ``argv``, train, and return ``{"state", "losses",
    "grad_norms", "step_seconds", "collectives", "start", "sparsity"}``
    (one entry per step run; ``collectives`` holds each step's
    ``Mesh.counts()`` under a mesh; ``sparsity`` is the printed column
    sparsity per projected leaf). Under a mesh ``state`` is this rank's
    shards."""
    args = _parser().parse_args(argv)

    from repro_torch.obs import bridge

    telemetry = args.telemetry_every > 0 or args.telemetry_marks
    with bridge.enabled_scope(True) if telemetry else contextlib.nullcontext():
        return _run(args)


def _run(args) -> dict:
    import torch
    import torch.distributed

    from repro_torch import _device, _tree, models
    from repro_torch.configs import registry
    from repro_torch.data import DataConfig, DataPipeline
    from repro_torch.models import lm
    from repro_torch.models import params as PM
    from repro_torch.obs import bridge
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import profile as obs_profile
    from repro_torch.optim import adamw
    from repro_torch.optim.projection_hook import matched_names, tree_sparsity
    from repro_torch.parallel import collectives, sharding
    from repro_torch.runtime import CheckpointManager, StragglerMonitor
    from repro_torch.training import init_state, make_train_step

    cfg = (registry.smoke_config(args.arch) if args.smoke
           else registry.get_arch(args.arch))
    if args.layers:
        cfg = lm.cut_depth(cfg, args.layers)
    sizes, _ = mesh_dims(args.mesh)
    sharded = any(d > 1 for d in sizes)
    if sharded:
        dev = join_world(int(torch.tensor(sizes).prod()), args.device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        mesh = parse_mesh(args.mesh)
        rank, world = mesh.rank, mesh.size
    else:
        dev = _device.resolve(args.device)
        mesh, rank, world = None, 0, 1
    say = print if rank == 0 else (lambda *a, **k: None)
    api = models.get(cfg)
    if cfg.family == "hybrid" and mesh is not None:
        say(f"attention: {args.attn} (the shared block, on each rank's heads)")
    elif cfg.family in lm.RECURRENT:
        # the step passes these forwards no impl, as the JAX package's does
        ran = "chunked (the shared block)" if cfg.family == "hybrid" else "none"
        say(f"attention: {ran}; a {cfg.family} model takes no --attn "
            f"({args.attn} not used)")
    micro = args.microbatch or args.batch
    tcfg = launch_config(args)
    proj = tcfg.projection

    pipe = DataPipeline(DataConfig(vocab=cfg.vocab, seq_len=args.seq + 1,
                                   global_batch=args.batch, microbatch=micro))
    specs = ospecs = None
    if mesh is not None:
        specs = PM.param_specs(api.template(cfg), sharding.param_rules(mesh),
                               sharding.mesh_shape_dict(mesh))
        ospecs = {"params": specs,
                  "opt": adamw.state_specs(specs, api.template(cfg), tcfg)}
    mgr = CheckpointManager(args.ckpt, keep=3) if args.ckpt else None
    mon = StragglerMonitor(n_hosts=world)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def full_tree(tree, tree_specs):
        """The whole tree on rank 0's host (None elsewhere): every rank
        takes part in each leaf's gather."""
        if mesh is None:
            return tree

        def one(x, sp):
            full = collectives.gather_full(x, sp, mesh)
            return full.cpu() if rank == 0 else None

        return _tree.tree_map(one, tree, tree_specs)

    state, start = None, 0
    if mgr:
        state, manifest = mgr.restore(device=dev if mesh is None else "cpu")
        if state is not None:
            start = manifest["step"]
            say(f"[elastic restart] resuming from step {start}")
            if mesh is not None:
                state = _tree.tree_map(lambda x: x.to(dev), sharding.shard_tree(
                    state, ospecs, mesh))
    if state is None:
        state = init_state(cfg, tcfg, api, tcfg.seed, device=dev, mesh=mesh,
                           param_specs=specs)
    if proj:
        params = dict(_tree.leaves_with_paths(state["params"]))
        say(f"constraint {proj.pattern} radius {proj.radius:g} on: " + ", ".join(
            f"{name} {tuple(params[name].shape)}"
            for name in matched_names(state["params"], proj)))
    step_hist = obs_metrics.get_registry().histogram(
        "train_step_seconds", "end-to-end wall time of one training step")
    b_ax = sharding.batch_axes(mesh) if mesh is not None else ("data",)
    step_fn = make_train_step(
        cfg, tcfg, api, impl=args.attn, n_groups=1 if mesh is None else
        sharding.dp_shards(mesh), act_spec=(b_ax if len(b_ax) > 1 else b_ax[0],
                                            None, None),
        mesh=mesh, param_specs=specs, telemetry_every=args.telemetry_every,
        telemetry_marks=args.telemetry_marks)
    out = {"losses": [], "grad_norms": [], "step_seconds": [],
           "collectives": [], "start": start}
    saved = None
    with obs_profile.capture(args.profile_dir):
        for step in range(start, args.steps):
            t0 = time.perf_counter()
            batch = {"tokens": torch.from_numpy(pipe.batch(step)).to(dev)}
            if mesh is not None:
                mesh.reset_counts()
            state, metrics = step_fn(state, batch)
            sync()
            dt = time.perf_counter() - t0
            times = {0: dt}
            if mesh is not None:
                out["collectives"].append(mesh.counts())
                mine = torch.zeros(world, dtype=torch.float64, device=mesh.device)
                mine[rank] = dt
                times = dict(enumerate(mesh.psum(mine, mesh.axis_names).tolist()))
            step_hist.observe(dt)
            rep = mon.record(times)
            loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
            out["losses"].append(loss)
            out["grad_norms"].append(gnorm)
            out["step_seconds"].append(dt)
            if mgr and (step + 1) % tcfg.checkpoint_every == 0:
                host = full_tree(state, ospecs)
                if rank == 0:
                    mgr.save_async(step + 1, host)
                saved = step + 1
            if (step + 1) % 10 == 0 or step + 1 == args.steps:
                msg = f"step {step + 1:5d} loss {loss:.4f} gnorm {gnorm:.2f}"
                if rep.action != "none":
                    msg += f"  [straggler watch: {rep.stragglers}]"
                say(msg)
    if mgr:
        if saved != args.steps:
            host = full_tree(state, ospecs)
            if rank == 0:
                mgr.save(args.steps, host)
        mgr.wait()
    out["sparsity"] = {}
    if proj:
        params = full_tree(state["params"], specs)
        if rank == 0:
            for name, sp in tree_sparsity(params, proj).items():
                out["sparsity"][name] = float(sp)
                say(f"column sparsity {name}: {float(sp):.1f}%")
    bridge.drain()
    if args.metrics_out and rank == 0:
        obs_metrics.get_registry().write_jsonl(args.metrics_out)
        say(f"metrics snapshot -> {args.metrics_out}")
    if args.profile_dir:
        say(f"profiler trace -> {args.profile_dir} "
            f"({len(obs_profile.trace_files(args.profile_dir))} files)")
    if mesh is not None:
        torch.distributed.barrier()
    out["state"] = state
    return out


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
