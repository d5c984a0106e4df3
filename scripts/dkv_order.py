#!/usr/bin/env python3
"""The bf16 dK/dV kernel's q-tile order, on one card.

    python3 scripts/dkv_order.py [--trials N] [--seed S]

``csrc/flash_bwd.cu``'s ``flash_bwd_dkv_wgmma`` walks its q tiles farthest
from the keys first, the G query heads of a kv head interleaved. This
script builds, beside it, the same kernel walking them nearest first and
head by head (the source with the two index lines changed back) and runs
both on the same inputs: ``--trials`` draws at h2o-danube-1.8b's windowed
shape, q (1, 32, 6144, d) and k/v (1, 8, 6144, d) causal with a window of
4096, d alternating 80 and 64, each held to ``flash_attention_bwd_plain``
at ``chip_smoke.py`` phase 1's bf16 bar (2^-7 |b| + 1e-5 of the largest
entry), counting the dK and dV entries past it and, of those, the ones
where the kernel lies farther than the plain version from a float64
reference (the same masked softmax backward in float64); then the time
of each (CUDA events, median of 20, two rounds a b b a) at granite-3-2b's
q (4, 32, 2048, 64), k/v (4, 8, 2048, 64) causal. Prints the card's name
and power limit, then one JSON line. Exits 2 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# the walk, as the kernel has it and nearest first (producer, then consumer)
FAR_FIRST = ("const int qm = b * hq + hk * group + t % group, q0 = qfirst + "
             "(nq - 1 - t / group) * TQR;",
             "const int q0 = qfirst + (nq - 1 - t / group) * TQR;")
NEAR_FIRST = ("const int qm = b * hq + hk * group + t / nq, q0 = qfirst + "
              "(t % nq) * TQR;",
              "const int q0 = qfirst + (t % nq) * TQR;")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trials", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("dkv_order: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import _build, flash_attention as fa

    src = (_build.CSRC / "flash_bwd.cu").read_text()
    for far, near in zip(FAR_FIRST, NEAR_FIRST):
        if src.count(far) != 1:
            raise SystemExit(f"dkv_order: {far!r} is not in flash_bwd.cu once")
        src = src.replace(far, near)
    out = ROOT / "build" / "dkv_order"
    out.mkdir(parents=True, exist_ok=True)
    (out / "flash_bwd.cu").write_text(src)
    near = _build.Kernel("flash_bwd_dkv_near_first",
                         {"flash_bwd_dkv": fa._DKV_ARGS}, source="flash_bwd")
    near.source = out / "flash_bwd.cu"
    kernels = {"far_first": fa.DKV_KERNEL, "near_first": near}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]

    def dkv(kern, *a, **kw):
        fa.DKV_KERNEL = kern
        try:
            return fa.flash_bwd_dkv(*a, **kw)
        finally:
            fa.DKV_KERNEL = kernels["far_first"]

    def ref64(q, k, v, do, o, lse, window):
        """dK, dV in float64 from the same inputs, o and lse."""
        s = q.shape[2]
        pos = torch.arange(s, device="cuda")
        mask = (pos[None] <= pos[:, None]) & (pos[None] > pos[:, None] - window)
        delta = (do.double() * o.double()).sum(-1)
        dk = torch.zeros(k.shape, dtype=torch.float64, device="cuda")
        dv = torch.zeros_like(dk)
        group = q.shape[1] // k.shape[1]
        for h in range(q.shape[1]):
            kh, qh, doh = h // group, q[0, h].double(), do[0, h].double()
            p = torch.where(mask, torch.exp(
                qh @ k[0, kh].double().T * q.shape[-1] ** -0.5
                - lse[0, h].double()[:, None]), 0.0)
            dv[0, kh] += p.T @ doh
            ds = p * (doh @ v[0, kh].double().T - delta[0, h][:, None])
            dk[0, kh] += ds.T @ qh * q.shape[-1] ** -0.5
        return dk, dv

    g = torch.Generator(device="cuda").manual_seed(args.seed)
    past = dict.fromkeys(kernels, 0)
    farther = dict.fromkeys(kernels, 0)
    for trial in range(args.trials):
        d = 80 if trial % 2 == 0 else 64
        q, k, v, do = (torch.randn(s, generator=g, device="cuda").bfloat16()
                       for s in ((1, 32, 6144, d), (1, 8, 6144, d),
                                 (1, 8, 6144, d), (1, 32, 6144, d)))
        opts = dict(causal=True, window=4096)
        o, lse = fa.flash_attention(q, k, v, **opts)
        delta = (do.float() * o.float()).sum(-1)
        _, pdk, pdv = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, **opts)
        rdk, rdv = ref64(q, k, v, do, o, lse, opts["window"])
        for name, kern in kernels.items():
            dk, dv = dkv(kern, q, k, v, do, lse, delta, **opts)
            for got, want, ref in ((dk, pdk, rdk), (dv, pdv, rdv)):
                w = want.float()
                bar = 1e-5 * w.abs().max() + cs.BF16_RTOL * w.abs()
                bad = (got.float() - w).abs() > bar
                past[name] += int(bad.sum())
                farther[name] += int((bad & ((got.double() - ref).abs()
                                             > (want.double() - ref).abs())).sum())
    qs, ks, causal, window = cs.GRANITE_ATTN
    q, k, v, do = (torch.randn(s, generator=g, device="cuda").bfloat16()
                   for s in (qs, ks, ks, qs))
    o, lse = fa.flash_attention(q, k, v, causal=causal, window=window)
    delta = (do.float() * o.float()).sum(-1)
    ms = {n: [] for n in kernels}
    for name in ("far_first", "near_first", "near_first", "far_first"):
        ms[name].append(cs.event_ms(lambda: dkv(
            kernels[name], q, k, v, do, lse, delta, causal=causal, window=window)))
    print(smi)
    print(json.dumps({"trials": args.trials, "seed": args.seed,
                      "past_bar": past, "kernel_farther_from_float64": farther,
                      "granite_ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
