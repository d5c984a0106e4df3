"""Serving launcher of the port (``repro/launch/serve.py``'s CLI): batched
greedy decoding against a seeded or checkpoint-initialized model.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \\
        --batch 8 --prompt-len 128 --new 64

decodes on the card (``--device cpu`` runs on the CPU; ``--smoke`` the
reduced config; ``--layers N``, the port's own option, cuts the model to
its first N layers at full width: an MoE model keeps its dense leading
layers and needs more than those, an xLSTM model whole super-blocks). An
MLA model (deepseek-v3-671b, kimi-k2-1t-a32b) decodes from its compressed
latent cache, zamba2-7b from its Mamba2 states and its shared attention's
KV cache, xlstm-1.3b from its recurrent state, whisper-large-v3 from its
decoder's self-attention cache and a cross-attention cache that stays
zero, as in the JAX launcher (``models/whisper.py``). The parameters come from
``--ckpt``'s latest checkpoint (its ``params``) or are drawn from seed 0 in
float32; the prompts from ``np.random.default_rng(0)``, as in the JAX
launcher. ``lm.generate`` replays each prompt through the decode step and
continues greedily. It prints requests × new tokens, the seconds and
tok/s, and the first request's tokens.
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
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new", type=int, default=32)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--profile-dir", default="",
                    help="capture a torch.profiler trace of the decode here")
    ap.add_argument("--metrics-out", default="",
                    help="write the obs-registry snapshot (JSON lines) here")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to decode (cpu: the plain PyTorch paths)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the model to this many layers at full width "
                         "(0: the config's depth)")
    return ap


def run(argv=None) -> dict:
    """Parse ``argv``, decode, and return ``{"tokens" (B, new) int32,
    "seconds", "tok_per_s", "requests", "new", "cfg", "params",
    "prompts"}``."""
    args = _parser().parse_args(argv)

    import numpy as np
    import torch

    from repro_torch import _device, _tree, models
    from repro_torch.configs import registry
    from repro_torch.models import lm as LM
    from repro_torch.models import params as PM
    from repro_torch.obs import bridge
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import profile as obs_profile
    from repro_torch.runtime import CheckpointManager
    from repro_torch.serving import lm

    dev = _device.resolve(args.device)
    cfg = (registry.smoke_config(args.arch) if args.smoke
           else registry.get_arch(args.arch))
    if args.layers:
        cfg = LM.cut_depth(cfg, args.layers)
    api = models.get(cfg)
    if args.ckpt:
        # on the host first: only the parameters go to the device, not the
        # optimizer state a training checkpoint also holds
        tree, _ = CheckpointManager(args.ckpt).restore(device="cpu")
        if tree is None:
            raise FileNotFoundError(f"--ckpt {args.ckpt}: no checkpoint there")
        params = _tree.tree_map(lambda x: x.to(dev), tree["params"])
    else:
        params = PM.init_params(api.template(cfg), 0, device=dev)

    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)),
        dtype=torch.int32, device=dev)
    t0 = time.perf_counter()
    with obs_profile.capture(args.profile_dir):
        out = lm.generate(params, cfg, prompts, max_new=args.new)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    tok_s = args.batch * args.new / dt
    print(f"{args.batch} requests × {args.new} new tokens in {dt:.1f}s "
          f"({tok_s:.1f} tok/s)")
    print("first request:", out[0].cpu().numpy())
    if args.metrics_out:
        bridge.drain()
        obs_metrics.get_registry().write_jsonl(args.metrics_out)
        print(f"metrics snapshot -> {args.metrics_out}")
    if args.profile_dir:
        print(f"profiler trace -> {args.profile_dir} "
              f"({len(obs_profile.trace_files(args.profile_dir))} files)")
    return {"tokens": out, "seconds": dt, "tok_per_s": tok_s,
            "requests": args.batch, "new": args.new, "cfg": cfg,
            "params": params, "prompts": prompts}


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
