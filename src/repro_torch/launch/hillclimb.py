"""The hillclimb: walk a train cell under a named ``Tuning`` variant and
record its roofline, to set beside the baseline's (port of
``repro/launch/hillclimb.py``).

    PYTHONPATH=src python -m repro_torch.launch.hillclimb \
        --cell stablelm_probsbf16 --out experiments/hillclimb_torch

Each variant runs as the dry run runs a cell (``launch/dryrun.py``: one
rank of the "single" mesh, 32 × 8 H100s, on ``meta``), and writes
``<out>/<variant>.json``. A variant whose walk raises records the error
and counts as a failure, as the JAX hillclimb counts a variant that fails
to compile.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

from repro_torch.configs import registry
from repro_torch.configs.types import SHAPES
from repro_torch.launch import specs as SP
from repro_torch.launch.dryrun import walk_cell
from repro_torch.launch.mesh import make_abstract_mesh
from repro_torch.roofline import analysis as RF

# (arch, shape, Tuning overrides), by variant name: the JAX package's
VARIANTS = {
    # ---- cell A: kimi-k2 train_4k ----
    "kimi_ep2d": ("kimi-k2-1t-a32b", "train_4k", dict(ep_2d=True)),
    "kimi_scatter": ("kimi-k2-1t-a32b", "train_4k", dict(moe_dispatch="scatter")),
    "kimi_ep2d_scatter": ("kimi-k2-1t-a32b", "train_4k",
                          dict(ep_2d=True, moe_dispatch="scatter")),
    "kimi_ep2d_scatter_mb32": ("kimi-k2-1t-a32b", "train_4k",
                               dict(ep_2d=True, moe_dispatch="scatter",
                                    microbatch=32)),
    # ---- cell B: xlstm train_4k ----
    "xlstm_chunk128": ("xlstm-1.3b", "train_4k", dict(xlstm_chunk=128)),
    "xlstm_chunk256": ("xlstm-1.3b", "train_4k", dict(xlstm_chunk=256)),
    "xlstm_chunk512": ("xlstm-1.3b", "train_4k", dict(xlstm_chunk=512)),
    # ---- cell C: stablelm train_4k (the paper's constraint on) ----
    "stablelm_probsbf16": ("stablelm-1.6b", "train_4k",
                           dict(attn_probs_bf16=True)),
    "stablelm_chunk2048": ("stablelm-1.6b", "train_4k", dict(attn_chunk=2048)),
    "stablelm_probsbf16_c2048": ("stablelm-1.6b", "train_4k",
                                 dict(attn_probs_bf16=True, attn_chunk=2048)),
    "stablelm_mb64": ("stablelm-1.6b", "train_4k",
                      dict(attn_probs_bf16=True, microbatch=64)),
    # the constraint widened to the whole MLP, projected in place by the
    # mesh executor
    "stablelm_proj_all": ("stablelm-1.6b", "train_4k",
                          dict(projection_pattern=r"(w_up|w_gate|w_down)")),
    "kimi_scatter_mb32": ("kimi-k2-1t-a32b", "train_4k",
                          dict(moe_dispatch="scatter", microbatch=32)),
    "kimi_scatter_mb64": ("kimi-k2-1t-a32b", "train_4k",
                          dict(moe_dispatch="scatter", microbatch=64)),
    "xlstm_chunk128_mb64": ("xlstm-1.3b", "train_4k",
                            dict(xlstm_chunk=128, microbatch=64)),
    "xlstm_shard_r": ("xlstm-1.3b", "train_4k", dict(xlstm_shard_r=True)),
    "xlstm_shard_r_chunk128": ("xlstm-1.3b", "train_4k",
                               dict(xlstm_shard_r=True, xlstm_chunk=128)),
    "deepseek_scatter": ("deepseek-v3-671b", "train_4k",
                         dict(moe_dispatch="scatter")),
    # GSP-style whole-network sparsification: every >= 2-D weight projected
    "stablelm_gsp_all": ("stablelm-1.6b", "train_4k",
                         dict(projection_pattern=r".*")),
    # the SAE factory's own train cell: d_model = 2048 activations in, an
    # 8x overcomplete dictionary, the encoder projected every step
    "sae_factory": ("sae_factory", "train_4k", dict()),
    # head-structured factory: 3-D encoder, tri-level l1,inf,inf ball
    "sae_factory_heads8": ("sae_factory", "train_4k", dict(heads=8)),
}


def _sae_factory_cell(mesh, heads=1):
    return SP.sae_factory_cell(2048, mesh, expansion=8,
                               batch=4096, microbatch=512, heads=heads)


def run_variant(name, out_dir):
    arch, shape_name, overrides = VARIANTS[name]
    mesh = make_abstract_mesh("single")
    t0 = time.time()
    rec = dict(variant=name, arch=arch, shape=shape_name,
               overrides={k: str(v) for k, v in overrides.items()})
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{name}.json")
    try:
        if arch == "sae_factory":
            cell = _sae_factory_cell(mesh, heads=overrides.get("heads", 1))
        else:
            cfg = registry.get_arch(arch)
            tune = dataclasses.replace(SP.tuning_for(cfg), **overrides)
            cell = SP.build_cell(cfg, SHAPES[shape_name], mesh, tune=tune)
        costs, _ = walk_cell(cell)
    except Exception as e:  # noqa: BLE001 - record the error, count it
        rec.update(status="error", error=f"{type(e).__name__}: {e}")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        raise
    finally:
        SP.reset_attn_tune()
    roof = RF.analyze(costs, mesh.size)
    rec.update(
        status="ok",
        compile_s=round(time.time() - t0, 1),
        memory={"argument_bytes": int(cell["arg_bytes"]),
                "temp_bytes": int(costs.peak_bytes)},
        roofline=roof.as_dict(),
    )
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    rf = rec["roofline"]
    print(f"[{name}] C={rf['t_compute'] * 1e3:.0f}ms M={rf['t_memory'] * 1e3:.0f}ms "
          f"K={rf['t_collective'] * 1e3:.0f}ms temp/dev="
          f"{costs.peak_bytes / 2**30:.1f}GB -> {rf['bottleneck']}", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", default="all",
                    help="variant name or 'all' or comma list")
    ap.add_argument("--out", default="experiments/hillclimb_torch")
    args = ap.parse_args(argv)
    names = list(VARIANTS) if args.cell == "all" else args.cell.split(",")
    fails = 0
    for n in names:
        try:
            run_variant(n, args.out)
        except Exception as e:  # noqa: BLE001
            fails += 1
            print(f"[{n}] FAIL {type(e).__name__}: {e}", file=sys.stderr)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
