#!/usr/bin/env python3
"""Time one family of the port's kernels beside a PyTorch call, on one card.

    python3 scripts/time_ab.py FAMILY [--tree DIR]

imports ``repro_torch`` from ``DIR/src`` (default: this checkout), builds
that tree's kernels of FAMILY and times them, float32:

- ``golden``: ``clip`` and ``colmax`` (``csrc/bilevel_l1inf.cu``) at W1
  (8192, 2048) and W3 (1000, 10000) beside ``torch.clamp`` with the bounds
  precomputed and the ℓ∞ ``torch.linalg.vector_norm`` over the rows;
  ``trilevel_apply`` (kernel row 6) at W2 (256, 32, 2048) and W4 (32,
  1000, 2000) in float32 and bf16 beside ``torch.clamp`` with the bounds
  min(v2, u1) precomputed; ``clip`` and ``trilevel_apply`` also beside
  ``Tensor.copy_`` of Y into X (the HBM rate of their traffic);
  ``l1ball`` (kernel rows 3/4) in both methods on one item and on a bucket
  of 8 of W1's aggregate (n = 2048: column maxima of (8192, 2048)
  requests) at a radius fraction and with r just under Σ|v|, and bisect
  on W3's aggregate (10000 values, the shared-memory path);
  ``trilevel_reduce`` (row 5) at W2 (256, 32, 2048) and W4 (32, 1000,
  2000) in float32 and bf16; the W1 and W2 golden pipelines (``bilevel_l1inf_fused``,
  ``trilevel_l1infinf_fused`` with a number radius: events and host time,
  no replay); and the launch floor, ``zero_`` of one float;
- ``codegen``: kernel rows 7 and 10 (``codegen_reduce`` on one item and
  on a bucket of 8; the bi-level ones beside the ℓ∞
  ``torch.linalg.vector_norm`` over the rows), rows 8 (``codegen_apply``,
  one item) and 11 (the same kernel on a bucket of 8), each at the
  server's bi-level (8192, 2048) and
  tri-level (256, 32, 2048) requests (``chip_smoke.py``'s FULL), and row 9
  (``codegen_partial_apply`` at granite-3-2b's wq local shard, 40 × (64, 8,
  2048)), beside ``torch.clamp``; rows 8 and 11 also beside
  ``Tensor.copy_`` of Y into X, which moves the kernel's Y and X bytes and
  nothing else: what the card reaches for that traffic;
- ``flash``: kernel row 12 f32 (``flash_attention`` at the harvest's
  (4, 32, 2048, 64) causal) beside ``scaled_dot_product_attention``, and
  rows 13a and 13b f32 (``flash_bwd_dq``, ``flash_bwd_dkv``) at granite-3-2b's
  q (4, 32, 2048, 64), k/v (4, 8, 2048, 64) causal beside SDPA's float32
  backward (``enable_gqa``: forward+backward and forward, timed apart; the
  backward is their difference); rows 12, 13a and 13b in bf16 at
  granite's shape (held to the plain versions at phase 1's bf16 bars);
- ``harvest``: one warm harvest step of the SAE factory at stablelm-1.6b's
  full width (``chip_smoke.py``'s FACTORY) and its LM forward, on the host
  clock, each ended by a synchronize (median of 3); ``chip_smoke.py``'s
  phase 4 holds what they compute;
- ``held``: one warm train step of ``chip_smoke.py``'s phase 5 held step
  (granite-3-2b at full width cut to 4 layers, float32 compute, the
  projection on, ``impl="flash"``: the float32 forward twice and each
  float32 backward kernel once per layer and microbatch), on the host
  clock (median of 5); phase 5 holds what it computes.

Each kernel's output is held to its plain version first (which also builds
and loads the kernel off the clock), and the PyTorch call to the same. A
kernel's row also carries its bound (``bound_ms``: bytes over 3.35 TB/s,
``chip_smoke.py``'s ``bound_ms``) where the table has one (rows 1, 5, 7, 10).
A kernel or PyTorch call gets ``chip_smoke.py``'s
timers: the CUDA-event time of a lone call (median of 100), its CUDA-graph
replay (the device's time alone, median of 100), the same per call of a
graph of 20 calls (``graph20_ms``: the graph's own launch latency spread
over them) and the host time per call (median of 5 runs of 200 calls
enqueued back to back); SDPA's
forward+backward gets the event time alone (autograd is not captured in a
graph), a golden pipeline no replay. The timers
and shapes are this checkout's whichever tree is timed, so trees are timed
alike; to compare two, time each in its own process on one machine, in
the order a, b, b, a:

    for t in a b b a; do python3 scripts/time_ab.py codegen --tree $t; done

Prints the card's name and power limit (``nvidia-smi``), then one JSON
line. Exits 2 without a CUDA device.

    python3 scripts/time_ab.py --summarize FILE

reads such JSON lines (one per process, any number of a b b a rounds) and
prints, for every row and timer, each tree's median, the first tree's
interquartile range, and in how many pairs the second tree read lower
(pair i: the i-th line of each tree); with more than two trees, each
further tree against the first. It needs no card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = {"W1": (8192, 2048), "W3": (1000, 10000)}  # chip_smoke.py's W1, W3
SEED = 0
REPS = 100                     # lone calls (and replays) per event median
HOST_RUNS = 5                  # host time per call: median of 5 runs
# no CUDA-graph replay: autograd is not captured, and a golden pipeline's
# radius may be copied to the card from the host (the parent's l1ball)
NO_GRAPH = {"sdpa_fwd_bwd", "pipeline"}


def golden_cases(torch, cs, randn, rand):
    """``{name: (check, {who: fn}, bound ms or None)}`` of the bi-level
    golden kernels."""
    from repro_torch.kernels import bilevel_l1inf as bi

    cases = {}
    for wl, shape in SHAPES.items():
        y = randn(shape)
        u = bi.colmax_plain(y) * (0.2 + 0.6 * rand(shape[1:]))
        lo, hi = -u[None, :], u[None, :]
        table = {  # kernel, plain, library
            "clip": (lambda y=y, u=u: bi.clip(y, u),
                     lambda y=y, u=u: bi.clip_plain(y, u),
                     lambda y=y, lo=lo, hi=hi: torch.clamp(y, lo, hi)),
            "colmax": (lambda y=y: bi.colmax(y),
                       lambda y=y: bi.colmax_plain(y),
                       lambda y=y: torch.linalg.vector_norm(y, float("inf"), dim=0)),
        }
        for name, (kern, plain, lib) in table.items():
            def check(tag, kern=kern, plain=plain, lib=lib):
                want = plain()
                cs.check_exact(tag, kern(), want)
                cs.check_exact(f"{tag} library call", lib(), want)
            fns = {"kernel": kern, "library": lib}
            if name == "clip":   # Y's and X's bytes and nothing else
                out = torch.empty_like(y)
                fns["copy"] = lambda y=y, out=out: out.copy_(y)
            nbytes = 4 * ((2 if name == "clip" else 1) * y.numel() + shape[1])
            cases[f"{wl} {name}"] = (check, fns, cs.bound_ms(nbytes, 0)[0])
    cases.update(golden_apply_cases(torch, cs, randn, rand))
    cases.update(golden_solve_cases(torch, cs, randn, rand))
    return cases


def golden_apply_cases(torch, cs, randn, rand):
    """Kernel row 6 (``trilevel_apply``) at W2 (256, 32, 2048) and W4 (32,
    1000, 2000) in float32 and bf16, beside ``torch.clamp`` with the bounds
    min(v2, u1) precomputed."""
    from repro_torch.kernels import trilevel_l1infinf as tri

    cases = {}
    for wl, y32 in (("W2", randn(cs.FULL["trilevel"][0])), ("W4", rand(cs.FIG3[0]))):
        for dt, y in (("", y32), (" bf16", y32.to(torch.bfloat16))):
            v2, v1 = tri.trilevel_reduce_plain(y)
            u1 = v1.float() * (0.2 + 0.6 * rand(v1.shape))
            w2 = torch.minimum(v2, u1.to(y.dtype)[None, :])[None]
            lo2 = -w2
            kern = lambda y=y, v2=v2, u1=u1: tri.trilevel_apply(y, v2, u1)
            lib = lambda y=y, lo2=lo2, w2=w2: torch.clamp(y, lo2, w2)

            def check(tag, kern=kern, lib=lib, y=y, v2=v2, u1=u1):
                want = tri.trilevel_apply_plain(y, v2, u1)
                cs.check_exact(tag, kern(), want)
                cs.check_exact(f"{tag} library call", lib(), want)
            c, n, m = y.shape
            out = torch.empty_like(y)
            cases[f"{wl} trilevel_apply{dt}"] = (
                check, {"kernel": kern, "library": lib,
                        "copy": lambda y=y, out=out: out.copy_(y)},
                cs.bound_ms(y.element_size() * (2 * y.numel() + n * m + m), 0)[0])
    return cases


def golden_solve_cases(torch, cs, randn, rand):
    """Kernel rows 3/4 (``l1ball``), row 5 (``trilevel_reduce``), the W1 and
    W2 golden pipelines and the launch floor (``zero_`` of one float)."""
    from repro_torch.core import multilevel
    from repro_torch.kernels import bilevel_l1inf as bi, codegen, l1ball
    from repro_torch.kernels import trilevel_l1infinf as tri

    cases = {}
    # l1ball on W1's aggregate: the column maxima of BUCKET (8192, 2048)
    # requests, at a radius fraction and with r just under Σ|v| (θ far
    # below max|v|: the most bisection steps); one item and the bucket
    v8 = torch.stack([bi.colmax_plain(randn(SHAPES["W1"])) for _ in range(cs.BUCKET)])
    s8 = v8.sum(1)
    for case, radii8 in (("W1", (0.05 + 0.45 * rand((cs.BUCKET,))) * s8),
                         ("just_under", s8 * (1 - 1e-6))):
        for method in ("bisect", "filter"):
            for b in (1, cs.BUCKET):
                v, radii = v8[:b], radii8[:b]
                kern = lambda v=v, radii=radii, method=method: \
                    l1ball.project_l1_batched(v, radii, method=method)
                plain = lambda v=v, radii=radii, method=method: \
                    l1ball.project_l1_plain(v, radii, method)

                def check(tag, kern=kern, plain=plain, v=v):
                    cs.check_close(tag, kern(), plain(), float(v.max()))
                cases[f"l1ball {method} {case} x{b}"] = (check, {"kernel": kern}, None)
    del v8
    # W3's aggregate (10000 values: the shared-memory path) at η = 1
    v3 = bi.colmax_plain(rand(SHAPES["W3"]))[None]
    r3 = torch.ones(1, device="cuda")
    cases["l1ball bisect W3 x1"] = (
        lambda tag: cs.check_close(tag, l1ball.project_l1_batched(v3, r3),
                                   l1ball.project_l1_plain(v3, r3), 1.0),
        {"kernel": lambda: l1ball.project_l1_batched(v3, r3)}, None)
    # row 5 at W2 and W4 (chip_smoke.py's FULL tri-level request, FIG3),
    # float32 and bf16
    for wl, y32 in (("W2", randn(cs.FULL["trilevel"][0])), ("W4", rand(cs.FIG3[0]))):
        for dt, y in (("", y32), (" bf16", y32.to(torch.bfloat16))):
            def check(tag, y=y):
                for a, b in zip(tri.trilevel_reduce(y), tri.trilevel_reduce_plain(y)):
                    cs.check_exact(tag, a, b)
            c, n, m = y.shape
            cases[f"{wl} trilevel_reduce{dt}"] = (
                check, {"kernel": lambda y=y: tri.trilevel_reduce(y)},
                cs.bound_ms(y.element_size() * (y.numel() + n * m + m), 0)[0])
    # the W1 and W2 golden pipelines at a radius fraction of Y's norm
    for wl, design, shape, levels, fused in (
            ("W1", "bilevel", SHAPES["W1"], cs.BILEVEL, bi.bilevel_l1inf_fused),
            ("W2", "trilevel", cs.FULL["trilevel"][0], cs.TRILEVEL,
             tri.trilevel_l1infinf_fused)):
        y = randn(shape)
        eta = 0.3 * float(multilevel.multilevel_norm(y, levels))
        generated = codegen.build(shape, levels, torch.float32, method="bisect")
        kern = lambda y=y, eta=eta, fused=fused: fused(y, eta)

        def check(tag, kern=kern, y=y, eta=eta, generated=generated):
            cs.check_close(tag, kern(), generated(y, eta), float(y.abs().max()))
        cases[f"{wl} golden pipeline"] = (check, {"pipeline": kern}, None)
    z = torch.zeros(1, device="cuda")
    cases["launch floor"] = (lambda tag: None, {"zero_": z.zero_}, None)
    return cases


def codegen_cases(torch, cs, randn, rand):
    """Kernel rows 7, 10, 8, 11 and 9 of the generated pipeline."""
    from repro_torch.core import schedule
    from repro_torch.kernels.codegen import lowering, tiling

    cases = {}

    def held(kern, plain, lib, scale):
        def check(tag):
            want = plain()
            cs.check_close(tag, kern(), want, scale)
            cs.check_close(f"{tag} library call", lib(), want, scale)
        return check

    for wl, (shape, levels) in cs.FULL.items():
        sched = schedule.compile_schedule(shape, levels)
        tp = tiling.plan_tiles(sched, torch.float32)
        norms = [q for q, _ in sched.levels][:-1]
        yc8 = randn((cs.BUCKET,) + tp.canon_shape)
        aggs8, vfin8 = lowering.reduce_plain(yc8, norms)
        radii = (0.05 + 0.9 * rand((cs.BUCKET,))) * vfin8.sum(1)
        u8 = lowering._solve_outer_batched(vfin8, "1", radii, "bisect")
        for b, row, rrow in ((1, 8, 7), (cs.BUCKET, 11, 10)):
            yc, vfin, u = yc8[:b], vfin8[:b], u8[:b]
            aggs = [a[:b] for a in aggs8]

            def check_reduce(tag, yc=yc, tp=tp, norms=norms, b=b, wl=wl):
                aggs_k, vfin_k = lowering.codegen_reduce(yc, tp, norms)
                aggs_p, vfin_p = lowering.reduce_plain(yc, norms)
                for k, p_ in zip([vfin_k, *aggs_k], [vfin_p, *aggs_p]):
                    cs.check_close(tag, k, p_, float(p_.max()))
                if wl == "bilevel":
                    cs.check_close(f"{tag} library call", torch.linalg.vector_norm(
                        yc, float("inf"), dim=1), vfin_p, float(vfin_p.max()))
            fns = {"kernel": lambda yc=yc, tp=tp, norms=norms:
                   lowering.codegen_reduce(yc, tp, norms)}
            if wl == "bilevel":
                fns["library"] = lambda yc=yc: torch.linalg.vector_norm(
                    yc, float("inf"), dim=1)
            agg_elems = sum(a.numel() for a in aggs)
            cases[f"row {rrow} {wl} x{b}"] = (check_reduce, fns, cs.bound_ms(
                4 * (yc.numel() + agg_elems + b * tp.m), 0)[0])
            out = torch.empty_like(yc)
            w = u[:, None, :] if not aggs \
                else torch.minimum(aggs[-1], u[:, None])[:, None]
            lo = -w
            kern = (lambda yc=yc, aggs=aggs, vfin=vfin, u=u, out=out, tp=tp,
                    norms=norms: lowering.codegen_apply(yc, aggs, vfin, u, tp,
                                                        norms, out=out))
            lib = lambda yc=yc, lo=lo, w=w: torch.clamp(yc, lo, w)
            plain = (lambda yc=yc, aggs=aggs, vfin=vfin, u=u, norms=norms:
                     lowering.apply_plain(yc, aggs, vfin, u, norms))
            cases[f"row {row} {wl} x{b}"] = (
                held(kern, plain, lib, float(yc.abs().max())),
                {"kernel": kern, "library": lib,
                 "copy": lambda yc=yc, out=out: out.copy_(yc)}, None)
    batch, canon, norms = cs.PARTIAL_FULL
    yc, tp, norms, aggs, w = cs.partial_apply_inputs(randn, rand, batch, canon,
                                                     norms, False)
    out = torch.empty_like(yc)
    w_b, lo_b = w[:, None], -w[:, None]
    kern = lambda: lowering.codegen_partial_apply(yc, aggs, w, tp, norms, out=out)
    lib = lambda: torch.clamp(yc, lo_b, w_b)
    cases[f"row 9 wq x{batch}"] = (
        held(kern, lambda: lowering.partial_apply_plain(yc, aggs, w, norms),
             lib, float(yc.abs().max())),
        {"kernel": kern, "library": lib}, None)
    return cases


def flash_cases(torch, cs, randn, rand):
    """Kernel row 12 f32 at the harvest's shape; rows 13a and 13b f32 at
    granite's training shape."""
    import torch.nn.functional as nnf

    from repro_torch.kernels import flash_attention as flash

    qs, ks, causal, window = cs.FLASH_FULL
    q, k, v = randn(qs, 1.0), randn(ks, 1.0), randn(ks, 1.0)
    kern = lambda: flash.flash_attention(q, k, v, causal=causal, window=window)
    lib = lambda: nnf.scaled_dot_product_attention(q, k, v, is_causal=causal)

    def check(tag):
        po, plse = flash.flash_attention_plain(q, k, v, causal=causal,
                                               window=window)
        o, lse = kern()
        cs.check_close(f"{tag} o", o, po, 2.0)
        cs.check_close(f"{tag} lse", lse, plse, 1.0)
        cs.check_close(f"{tag} library call", lib(), po, 2.0)
    cases = {f"row 12 f32 {qs} causal": (check, {"kernel": kern, "library": lib},
                                        None)}

    # granite's training shape: names of their own (the lambdas above read
    # q, k, v, causal and window when they run)
    gs, gk, gcausal, gwindow = cs.GRANITE_ATTN
    gq, gkk, gv, gdo = randn(gs, 1.0), randn(gk, 1.0), randn(gk, 1.0), randn(gs, 1.0)
    opts = dict(causal=gcausal, window=gwindow)
    go, glse = flash.flash_attention(gq, gkk, gv, **opts)
    delta = (gdo * go).sum(-1)
    qq, kk, vv = (x.clone().requires_grad_(True) for x in (gq, gkk, gv))

    def sdpa():
        return nnf.scaled_dot_product_attention(qq, kk, vv, is_causal=gcausal,
                                                enable_gqa=True)

    library = {"sdpa_fwd_bwd": lambda: torch.autograd.grad(sdpa(), (qq, kk, vv), gdo),
               "sdpa_fwd": sdpa}
    dq = lambda: flash.flash_bwd_dq(gq, gkk, gv, gdo, glse, delta, **opts)
    dkv = lambda: flash.flash_bwd_dkv(gq, gkk, gv, gdo, glse, delta, **opts)

    def held(fn, names):
        def check(tag):
            want = dict(zip(("dq", "dk", "dv"), flash.flash_attention_bwd_plain(
                gq, gkk, gv, go, glse, gdo, **opts)))
            got = fn()
            for n, g in zip(names, got if isinstance(got, tuple) else (got,)):
                cs.check_close(f"{tag} {n}", g, want[n], float(want[n].abs().max()))
        return check
    cases[f"row 13a f32 {gs}/{gk} causal"] = (held(dq, ("dq",)),
                                              {"kernel": dq, **library}, None)
    cases[f"row 13b f32 {gs}/{gk} causal"] = (held(dkv, ("dk", "dv")),
                                              {"kernel": dkv}, None)

    # rows 12, 13a and 13b in bf16 (the trainer's type) at granite's shape,
    # held to the plain versions at phase 1's bf16 bars
    bq, bk, bv, bdo = (x.to(torch.bfloat16) for x in (gq, gkk, gv, gdo))
    bo, blse = flash.flash_attention(bq, bk, bv, **opts)
    bdelta = (bdo.float() * bo.float()).sum(-1)
    bf = {"12": lambda: flash.flash_attention(bq, bk, bv, **opts),
          "13a": lambda: flash.flash_bwd_dq(bq, bk, bv, bdo, blse, bdelta, **opts),
          "13b": lambda: flash.flash_bwd_dkv(bq, bk, bv, bdo, blse, bdelta, **opts)}

    def bf16_check(tag):
        po = flash.flash_attention_plain(bq, bk, bv, **opts)[0]
        cs.check_close(f"{tag} o", bf["12"]()[0], po, 2.0, rtol=cs.BF16_RTOL)
        want = flash.flash_attention_bwd_plain(bq, bk, bv, bo, blse, bdo, **opts)
        got = (bf["13a"](), *bf["13b"]())
        for n, g, w in zip(("dq", "dk", "dv"), got, want):
            cs.check_close(f"{tag} {n}", g, w, float(w.abs().max()),
                           rtol=cs.BF16_RTOL)
    for row, fn in bf.items():
        cases[f"row {row} bf16 {gs}/{gk} causal"] = (
            bf16_check if row == "12" else (lambda tag: None), {"kernel": fn}, None)
    return cases


def harvest_rows(torch, cs, tree):
    """One warm harvest step and its LM forward: ``{name: {"host_ms": ms}}``."""
    import dataclasses

    from repro_torch.data import DataConfig, DataPipeline
    from repro_torch.models import lm
    from repro_torch.training import sae_factory as F

    fcfg = F.SAEFactoryConfig(**cs.FACTORY)
    cfg, _, params = F.lm_for(fcfg, device="cuda")
    toks = DataPipeline(DataConfig(
        vocab=cfg.vocab, seq_len=fcfg.seq_len, global_batch=fcfg.lm_batch,
        microbatch=fcfg.lm_batch, seed=fcfg.seed)).batch(0)
    toks = torch.from_numpy(toks.reshape(-1, fcfg.seq_len)).to("cuda")

    def forward():
        with torch.no_grad():
            return lm.forward(params, toks, cfg, impl="flash", remat=False,
                              collect="resid")

    one = dataclasses.replace(fcfg, harvest_steps=1)
    out = ROOT / "build" / "time_ab" / Path(tree).name
    return {"harvest_step": {"host_ms": cs.host_ms(
                lambda: F.harvest_activations(one, out, params=params), reps=3)},
            "forward": {"host_ms": cs.host_ms(forward, reps=3)}}


def held_rows(torch, cs, tree):
    """One warm held train step: ``{"held_step": {"host_ms": ms}}``."""
    from repro_torch.optim import adamw
    from repro_torch.training import make_train_step

    radius, _ = cs.train_radius("cuda")
    cfg, tcfg, api, _, toks, params = cs.held_step_setup("cuda", radius)
    state = {"params": params, "opt": adamw.init(params, tcfg)}
    step = make_train_step(cfg, tcfg, api, impl="flash")
    return {"held_step": {"host_ms": cs.host_ms(lambda: step(state, toks), reps=5)}}


FAMILIES = {"golden": golden_cases, "codegen": codegen_cases,
            "flash": flash_cases, "harvest": harvest_rows, "held": held_rows}
HOST_FAMILIES = ("harvest", "held")  # whole steps on the host clock


def summarize(path: Path) -> None:
    """Medians, the first tree's IQR and pair wins of ``time_ab`` lines."""
    runs = {}
    for line in path.read_text().splitlines():
        if line.startswith("{"):
            r = json.loads(line)
            runs.setdefault(r["tree"], []).append(r["rows"])
    (a, ra), *others = runs.items()
    for b, rb in others:   # each further tree against the first
        print(f"a = {a} ({len(ra)} runs), b = {b} ({len(rb)} runs)")
        for row in ra[0]:
            for timer in ra[0][row]:
                if timer == "bound_ms" or row not in rb[0]:
                    continue
                xa = [r[row][timer] for r in ra]
                xb = [r[row][timer] for r in rb]
                qa = statistics.quantiles(xa, n=4)
                wins = sum(y < x for x, y in zip(xa, xb))
                print(f"{row} {timer}: a {statistics.median(xa):.4f} (IQR "
                      f"{qa[2] - qa[0]:.4f}), b {statistics.median(xb):.4f}, "
                      f"b/a {statistics.median(xb) / statistics.median(xa):.3f}, "
                      f"b lower in {wins}/{min(len(xa), len(xb))} pairs")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("family", nargs="?", choices=sorted(FAMILIES))
    ap.add_argument("--tree", type=Path, default=ROOT,
                    help="checkout whose src/repro_torch is timed")
    ap.add_argument("--summarize", type=Path, metavar="FILE",
                    help="summarize the JSON lines of earlier runs instead")
    args = ap.parse_args(argv)
    if args.summarize is not None:
        summarize(args.summarize)
        return 0
    if args.family is None:
        ap.error("a family to time, or --summarize FILE")

    import torch

    if not torch.cuda.is_available():
        print("time_ab: no CUDA device", file=sys.stderr)
        return 2
    tree = args.tree.resolve()
    sys.path.insert(0, str(ROOT))           # chip_smoke.py's timers and shapes
    sys.path.insert(0, str(tree / "src"))   # the tree under test
    import chip_smoke as cs
    import repro_torch

    if not Path(repro_torch.__file__).resolve().is_relative_to(tree):
        raise SystemExit(f"imported {repro_torch.__file__}, not {tree}'s")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]

    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def randn(shape, scale=2.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    def rand(shape):
        return torch.rand(shape, generator=gen, device="cuda")

    if args.family in HOST_FAMILIES:
        rows = FAMILIES[args.family](torch, cs, tree)
    else:
        rows = {}
        for name, (check, fns, bound) in FAMILIES[args.family](
                torch, cs, randn, rand).items():
            check(name)
            for who, fn in fns.items():
                rows[f"{name} {who}"] = {"ms": cs.event_ms(fn, REPS)}
                if who != "sdpa_fwd_bwd":
                    rows[f"{name} {who}"]["host_ms"] = statistics.median(
                        cs.host_call_ms(fn) for _ in range(HOST_RUNS))
                if who not in NO_GRAPH:
                    rows[f"{name} {who}"]["graph_ms"] = cs.graph_ms(fn, REPS)
                    rows[f"{name} {who}"]["graph20_ms"] = cs.graph_ms(
                        fn, REPS, calls=20)
                if who == "kernel" and bound is not None:
                    rows[f"{name} {who}"]["bound_ms"] = bound
    print(smi)
    print(json.dumps({"tree": str(tree), "family": args.family, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
