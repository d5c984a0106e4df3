#!/usr/bin/env python3
"""Profile one train step again and again from one snapshot of its state,
on one card: which device events ``torch.profiler`` leaves out of its
window, and whether the step's result stays bit-equal.

    python3 scripts/profile_window.py

builds the port's kernels, then takes ``chip_smoke.py`` phase 10 (d)'s
step (granite-3-2b cut to 8 layers at full width, the batch and radius of
phase 5, the bridge off) built with ``telemetry_every`` 0 and 1, and
profiles 8 calls in the order 0, 1, 1, 0, 0, 1, 1, 0, each after a warm
call, in three ways (``--window``): with the snapshot restored inside the
profiler's window, outside it, and outside it with 128 spin kernels
(``torch.cuda._sleep``, not counted) first in the window. Per call it
prints the device events against the first call's, by name, where the
first difference lies, and whether the params after it are bit-equal to
the first call's.
"""

import argparse
import collections
import dataclasses as dc
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--window", nargs="+",
                    choices=("inside", "outside", "padded"),
                    default=["inside", "outside", "padded"],
                    help="the snapshot restored inside the profiler's "
                         "window, before it opens, or before it opens with "
                         "128 spin kernels first in the window")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from repro_torch import _tree, models
    from repro_torch.configs import registry
    from repro_torch.configs.types import ProjectionSpec, TrainConfig
    from repro_torch.data import DataConfig, DataPipeline
    from repro_torch.kernels import _build
    from repro_torch.obs import bridge
    from repro_torch.training import init_state, make_train_step

    if not torch.cuda.is_available():
        print("profile_window: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False   # as chip_smoke.py
    _build.build_all()
    dev = torch.device("cuda")
    radius, _ = cs.train_radius(dev)
    cfg = dc.replace(registry.get_arch(cs.TRAIN_ARCH),
                     n_layers=cs.TELEMETRY_LAYERS)
    _, batch, micro, seq = cs.train_args()
    tcfg = TrainConfig(microbatch=micro, lr=3e-4, total_steps=3, warmup=1,
                       remat=True, master_dtype="", projection=ProjectionSpec(
                           pattern=r"(w_up|w_gate)", radius=radius))
    api = models.get(cfg)
    pipe = DataPipeline(DataConfig(vocab=cfg.vocab, seq_len=seq + 1,
                                   global_batch=batch, microbatch=micro))
    toks = {"tokens": torch.from_numpy(pipe.batch(0)).to(dev)}
    state = init_state(cfg, tcfg, api, cs.SEED, device=dev)
    snap = _tree.tree_map(torch.clone, state)
    built = {e: make_train_step(cfg, tcfg, api, impl="flash",
                                telemetry_every=e) for e in (0, 1)}
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())

    def restore():
        for d, s_ in zip(_tree.leaves(state), _tree.leaves(snap)):
            d.copy_(s_)

    def profiled(fn, where):
        restore()
        fn(state, toks)
        if where != "inside":
            restore()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            if where == "inside":
                restore()
            for _ in range(128 if where == "padded" else 0):
                torch.cuda._sleep(1)
            fn(state, toks)
            torch.cuda.synchronize()
        evs = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and "spin_kernel" not in e.name),
                     key=lambda e: e.time_range.start)
        return [e.name for e in evs], [p.clone() for p in
                                       _tree.leaves(state["params"])]

    with bridge.enabled_scope(False):
        for where in args.window:
            ref = None
            for i, every in enumerate((0, 1, 1, 0, 0, 1, 1, 0)):
                names, params = profiled(built[every], where)
                if ref is None:
                    ref = names, params
                have, want = collections.Counter(names), collections.Counter(ref[0])
                delta = {k[:60]: have[k] - want[k] for k in have | want
                         if have[k] != want[k]}
                first = next((j for j, (a, b) in enumerate(zip(ref[0], names))
                              if a != b), min(len(names), len(ref[0])))
                same = all(torch.equal(a, b) for a, b in zip(params, ref[1]))
                print(f"{where}, call {i}, telemetry_every={every}: "
                      f"{len(names)} device events; against call 0 "
                      f"{delta or 'the same'}"
                      f"{f', first difference at event {first}' if delta else ''}; "
                      f"params bit-equal to call 0's: {same}", flush=True)
                del params
    return 0


if __name__ == "__main__":
    sys.exit(main())
