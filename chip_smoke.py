#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

1. builds the three CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc``
   per source, started together) and holds each against its plain PyTorch
   version on the card: at the two full-width serving shapes, over the
   design matrix at small ragged sizes, and for ``l1ball`` both bodies over
   several lengths up to the tiler's limit;
2. serves full-width requests through ``ProjectionEngine`` — 8 bi-level
   (8192, 2048) and 8 tri-level (256, 32, 2048) f32 requests through
   ``codegen_batch`` buckets of 8, one of each through ``codegen`` — checks
   every answer against the plain schedule executor on the card and for
   feasibility, and reads each kernel's launch count over each path; then
   measures the engine's bucket and per-request latency, synchronous and
   with the dispatcher thread (whose answers must equal the synchronous
   ones);
3. times each kernel at full width, for the bucket of 8 and for one item,
   with CUDA events (median of 20) beside its bound, its plain version and,
   where one PyTorch call computes the same function, that call.

The widths are the SAE factory's dictionary SAE on stablelm-1.6b:
d_model 2048, d_dict 4 x 2048 = 8192, 32 heads; the projected tensor is the
transposed encoder. Tolerance everywhere: |a - b| <= 1e-5 * max|Y| +
1e-5 * |b| (64-step float32 bisection and another summation order move θ by
a few ulps). Any failure exits non-zero without the final line. Without a
CUDA device, or outside a checkout, it exits 2 and prints no result.

Output: one line per check, then a JSON line ``{"kernels": [...]}``, the
``nvidia-smi`` name and power limit, and last
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
F32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
RTOL = 1e-5
REPS = 20
SEED = 0

BILEVEL = (("inf", 1), ("1", 1))
TRILEVEL = (("inf", 1), ("inf", 1), ("1", 1))
FULL = {  # the two requests the server sees, per workload
    "bilevel": ((8192, 2048), BILEVEL),
    "trilevel": ((256, 32, 2048), TRILEVEL),
}
BUCKET = 8

# tests/test_codegen.py DESIGNS + EXTRA_DESIGNS
DESIGNS = [
    ("l1inf_cols", (32, 64), BILEVEL),
    ("l1inf_rows", (32, 64), BILEVEL),
    ("l1infinf_last", (4, 16, 64), TRILEVEL),
    ("l1infinf_mid", (4, 16, 64), TRILEVEL),
    ("l12_rows", (32, 48), (("2", 1), ("1", 1))),
    ("l11_rows", (32, 48), (("1", 1), ("1", 1))),
    ("flat_l1", (16, 24), (("1", 2),)),
    ("l1inf_uneven", (32, 60), BILEVEL),
    ("l11_uneven", (30, 48), (("1", 1), ("1", 1))),
    ("l111", (3, 10, 20), (("1", 1), ("1", 1), ("1", 1))),
    ("rank4_mixed", (3, 4, 5, 32), (("inf", 1), ("2", 1), ("1", 1), ("1", 1))),
    ("rank4_l2pair", (2, 3, 4, 40), (("2", 2), ("inf", 1), ("1", 1))),
    ("outer_l2", (8, 16), (("inf", 1), ("2", 1))),
    ("outer_inf", (8, 16), (("1", 1), ("inf", 1))),
    ("wide_groups", (6, 200), (("1", 1), ("1", 1))),
]

REPLACES = {  # (kernel, batched) -> the TPU kernel's pallas_call site
    ("codegen_reduce", True): "src/repro/kernels/codegen/lowering.py:512",
    ("codegen_reduce", False): "src/repro/kernels/codegen/lowering.py:183",
    ("codegen_apply", True): "src/repro/kernels/codegen/lowering.py:548",
    ("codegen_apply", False): "src/repro/kernels/codegen/lowering.py:270",
    ("l1ball", True): "src/repro/kernels/l1ball.py:154",
    ("l1ball", False): "src/repro/kernels/l1ball.py:122",
}


class SmokeFailure(RuntimeError):
    pass


def check_close(what, got, want, scale):
    """Max abs error of ``got`` against ``want``; raises past tolerance."""
    import torch

    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise SmokeFailure(f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise SmokeFailure(f"{what}: non-finite values")
    err = (got - want).abs()
    bad = err > 1e-5 * scale + RTOL * want.abs()
    max_err = float(err.max()) if err.numel() else 0.0
    if bool(bad.any()):
        raise SmokeFailure(f"{what}: max abs err {max_err:.3e} past tolerance "
                           f"(scale {scale:.3e})")
    return max_err


def event_ms(fn, reps=REPS):
    """Median milliseconds of ``fn()`` over ``reps`` runs, CUDA events,
    after two warm-up runs."""
    import torch

    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes, nops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to drive", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT} holds no src/repro_torch checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    from repro_torch.core import multilevel, plan as planmod, schedule
    from repro_torch.kernels import _build, l1ball
    from repro_torch.kernels.codegen import lowering, tiling
    from repro_torch.serving.engine import ProjectionEngine

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"{smi}; torch {torch.__version__} cuda {torch.version.cuda}")

    # ---------------------------------------------------------------- build
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s wall; per source "
          + ", ".join(f"{k} {v:.1f} s" for k, v in built.items()))
    for k in _build.KERNELS.values():
        log = k.library.with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"ptxas {k.name}: {line.strip()}")

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(shape, scale=2.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def rand(shape):
        return torch.rand(shape, generator=gen, device=dev)

    # ------------------------------------- phase 1: kernels vs plain versions
    def hold_pipeline(tag, shape, levels, batch):
        """Each kernel of one design against its plain version; returns the
        inputs and max errors per kernel."""
        sched = schedule.compile_schedule(shape, levels)
        tp = tiling.plan_tiles(sched, torch.float32)
        if tp is None:
            raise SmokeFailure(f"{tag}: the tiler rejects {levels} on {shape}")
        norms = [q for q, _ in sched.levels]
        yc = randn((batch,) + tp.canon_shape)
        scale = float(yc.abs().max())
        errs = {}
        if len(norms) == 1:
            radii = rand((batch,)) * yc.abs().flatten(1).sum(1)
            got = l1ball.project_l1_batched(yc, radii)
            torch.cuda.synchronize()
            errs["l1ball"] = check_close(f"{tag} l1ball", got,
                                         l1ball.project_l1_plain(yc, radii), scale)
            return errs, None
        aggs, vfin = lowering.codegen_reduce(yc, tp, norms[:-1])
        torch.cuda.synchronize()
        aggs_p, vfin_p = lowering.reduce_plain(yc, norms[:-1])
        # aggregates are held to their own magnitude
        err = check_close(f"{tag} reduce vfin", vfin, vfin_p,
                          float(vfin_p.max()))
        for t, (a, ap) in enumerate(zip(aggs, aggs_p)):
            err = max(err, check_close(f"{tag} reduce v{t + 1}", a, ap,
                                       float(ap.max())))
        errs["codegen_reduce"] = err
        outer = {"1": vfin_p.sum(1), "2": vfin_p.norm(dim=1),
                 "inf": vfin_p.amax(1)}[norms[-1]]
        radii = (0.05 + 0.9 * rand((batch,))) * outer
        if norms[-1] == "1":
            u = l1ball.project_l1_batched(vfin_p, radii)
            torch.cuda.synchronize()
            u_p = l1ball.project_l1_plain(vfin_p, radii)
            errs["l1ball"] = check_close(f"{tag} l1ball", u, u_p,
                                         float(vfin_p.abs().max()))
        else:
            u_p = lowering._solve_outer_batched(vfin_p, norms[-1], radii, "bisect")
        x = lowering.codegen_apply(yc, aggs_p, vfin_p, u_p, tp, norms[:-1])
        torch.cuda.synchronize()
        x_p = lowering.apply_plain(yc, aggs_p, vfin_p, u_p, norms[:-1])
        errs["codegen_apply"] = check_close(f"{tag} apply", x, x_p, scale)
        return errs, (yc, tp, norms, aggs_p, vfin_p, u_p, radii)

    for name, shape, levels in DESIGNS:
        errs, _ = hold_pipeline(name, shape, levels, 3)
        print(f"design {name} {shape}: " + ", ".join(
            f"{k} max_abs_err {v:.3e}" for k, v in errs.items()))

    for n in (1, 127, 2048, tiling.L1_KERNEL_MAX):
        v = randn((4, n))
        radii = rand((4,)) * v.abs().sum(1)
        radii[0] = v[0].abs().sum() * 2       # one item inside its ball
        for method in ("bisect", "filter"):
            got = l1ball.project_l1_batched(v, radii, method=method)
            torch.cuda.synchronize()
            err = check_close(f"l1ball {method} n={n}", got,
                              l1ball.project_l1_plain(v, radii, method),
                              float(v.abs().max()))
            print(f"l1ball {method} n={n}: max_abs_err {err:.3e}")

    full_cases = {}
    for wl, (shape, levels) in FULL.items():
        errs, inputs = hold_pipeline(f"{wl} full", shape, levels, BUCKET)
        full_cases[wl] = (errs, inputs)
        print(f"{wl} {BUCKET}x{shape}: " + ", ".join(
            f"{k} max_abs_err {v:.3e}" for k, v in errs.items()))
    torch.cuda.empty_cache()

    # ------------------------------------- phase 2: the server at full width
    # synchronous engines (start=False: result() dispatches inline), so each
    # workload's 8 requests form exactly one bucket of 8
    eng_batch = ProjectionEngine(device="cuda", method="codegen_batch",
                                 max_batch=BUCKET, start=False)
    eng_single = ProjectionEngine(device="cuda", method="codegen",
                                  max_batch=BUCKET, start=False)
    for wl, (shape, levels) in FULL.items():
        eng_batch.prewarm(shape, torch.float32, levels)
        eng_single.prewarm(shape, torch.float32, levels)
    eng_batch.wait_warm()
    eng_single.wait_warm()

    # the main path, one counting window per path: the bucket of 8 through
    # codegen_batch, then one request through codegen
    launches = {}
    served = 0
    for wl, (shape, levels) in FULL.items():
        ys = [randn(shape) for _ in range(BUCKET + 1)]
        radii = [float(multilevel.multilevel_norm(y, levels))
                 * (0.05 + 0.45 * float(rand(()))) for y in ys]
        outs = []
        for batch, eng, part in ((BUCKET, eng_batch, slice(0, BUCKET)),
                                 (1, eng_single, slice(BUCKET, BUCKET + 1))):
            _build.reset_launches()
            tickets = [eng.submit(y, levels, r)
                       for y, r in zip(ys[part], radii[part])]
            outs += [eng.result(t, timeout=300) for t in tickets]
            torch.cuda.synchronize()
            launches[wl, batch] = _build.launch_counts()
            print(f"server {wl} {'codegen_batch' if batch > 1 else 'codegen'} "
                  f"x{batch}: launches {launches[wl, batch]}")
            for k, c in launches[wl, batch].items():
                if c == 0:
                    raise SmokeFailure(f"server {wl}: kernel {k} never launched")
        m = shape[-1]
        for i, (y, r, x) in enumerate(zip(ys, radii, outs)):
            want = multilevel.multilevel_project(y, levels, r, method="bisect")
            err = check_close(f"server {wl} request {i}", x, want,
                              float(y.abs().max()))
            nrm = float(multilevel.multilevel_norm(x, levels))
            # one float32 ulp of θ per summed aggregate entry
            slack = r * RTOL + m * 2.0 ** -23 * float(y.abs().max())
            if not nrm <= r + slack:
                raise SmokeFailure(f"server {wl} request {i}: norm {nrm} > "
                                   f"radius {r}")
            served += 1
        print(f"server {wl}: {len(outs)} requests correct and feasible "
              f"(last max_abs_err {err:.3e})")
        del ys, outs, tickets
        torch.cuda.empty_cache()

    # engine latency at full width, bucket 8, after the checks above: the
    # synchronous engine (one bucket of 8 per round) and a threaded one (the
    # dispatcher thread pops whatever has arrived, as a deployed server
    # does), whose answers must equal the synchronous engine's
    eng_threaded = ProjectionEngine(device="cuda", method="codegen_batch",
                                    max_batch=BUCKET)
    latency = {}
    for wl, (shape, levels) in FULL.items():
        ys = [randn(shape) for _ in range(BUCKET)]
        for mode, eng in (("sync", eng_batch), ("threaded", eng_threaded)):
            bucket_s, request_s = [], []
            for _ in range(5):
                t0 = time.perf_counter()
                tickets = [(eng.submit(y, levels, 100.0), time.perf_counter())
                           for y in ys]
                outs, done = [], []
                for t, ts in tickets:
                    outs.append(eng.result(t, timeout=300))
                    torch.cuda.synchronize()
                    done.append(time.perf_counter() - ts)
                bucket_s.append(time.perf_counter() - t0)
                request_s.append(statistics.median(done))
            if mode == "sync":
                latency[wl] = (statistics.median(bucket_s),
                               statistics.median(request_s))
                sync_outs = outs
            else:
                for i, (a, b) in enumerate(zip(outs, sync_outs)):
                    check_close(f"threaded engine {wl} request {i}", a, b,
                                float(ys[i].abs().max()))
            print(f"engine {wl} {mode} bucket {BUCKET}: bucket latency "
                  f"{statistics.median(bucket_s) * 1e3:.3f} ms, per-request "
                  f"latency {statistics.median(request_s) * 1e3:.3f} ms "
                  f"(median of 5, host clock, submit to result)")
        del ys, outs, sync_outs
    for eng in (eng_batch, eng_single, eng_threaded):
        snap = eng.stats_snapshot()
        if snap["failures"] or snap["failed"] or snap["queued"] or snap["inflight"]:
            raise SmokeFailure(f"engine stats show failures: {snap}")
        if (snap["completed"] + snap["failed"] + snap["discarded"]
                + snap["queued"] + snap["inflight"] != snap["submitted"]):
            raise SmokeFailure(f"engine accounting broken: {snap}")
        eng.stop()
    print(f"server: {served} checked requests, 0 failures; plan cache "
          f"{planmod.cache_info()}")

    # ------------------------------------- phase 3: times at full width
    # each kernel at the bucket of 8 and at one item (the codegen path), on
    # the phase-1 inputs, held once more against its plain version
    rows = []
    stack_ms = {}
    for wl, (_, inputs) in full_cases.items():
        yc8, tp, norms, aggs8, vfin8, u8, radii8 = inputs
        for b in (BUCKET, 1):
            yc, vfin_p, u_p, radii = yc8[:b], vfin8[:b], u8[:b], radii8[:b]
            aggs_p = [a[:b] for a in aggs8]
            elems, m = yc.numel(), tp.m
            agg_elems = sum(a.numel() for a in aggs_p)
            scale = float(yc.abs().max())
            out = torch.empty_like(yc)
            cases = {  # kernel, plain, compare, bytes, operations
                "codegen_reduce": (
                    lambda: lowering.codegen_reduce(yc, tp, norms[:-1]),
                    lambda: lowering.reduce_plain(yc, norms[:-1]),
                    lambda k, p: max(check_close(f"{wl} x{b} reduce", a, c,
                                                 float(c.max()))
                                     for a, c in zip([k[1], *k[0]],
                                                     [p[1], *p[0]])),
                    4 * (elems + agg_elems + b * m), 2 * elems + 2 * agg_elems),
                "l1ball": (
                    lambda: l1ball.project_l1_batched(vfin_p, radii),
                    lambda: l1ball.project_l1_plain(vfin_p, radii),
                    lambda k, p: check_close(f"{wl} x{b} l1ball", k, p,
                                             float(vfin_p.max())),
                    4 * (2 * b * m + b), b * m * (3 * 64 + 6)),
                "codegen_apply": (
                    lambda: lowering.codegen_apply(yc, aggs_p, vfin_p, u_p, tp,
                                                   norms[:-1], out=out),
                    lambda: lowering.apply_plain(yc, aggs_p, vfin_p, u_p,
                                                 norms[:-1]),
                    lambda k, p: check_close(f"{wl} x{b} apply", k, p, scale),
                    4 * (2 * elems + agg_elems + 2 * b * m),
                    2 * elems + 2 * agg_elems),
            }
            lib = dict.fromkeys(cases)
            if wl == "bilevel":
                u_b = u_p[:, None, :]
                lib["codegen_reduce"] = event_ms(lambda: torch.amax(yc.abs(), dim=1))
                lib["codegen_apply"] = event_ms(lambda: torch.clamp(yc, -u_b, u_b))
            for name, (kern, plain, compare, nbytes, nops) in cases.items():
                err = compare(kern(), plain())
                torch.cuda.synchronize()
                plain_ms = event_ms(plain)
                ms = event_ms(kern)
                bms, by = bound_ms(nbytes, nops)
                rows.append({
                    "name": name, "workload": f"{wl} {b}x{FULL[wl][0]}",
                    "route": "cuda", "source": f"src/repro_torch/csrc/{name}.cu",
                    "replaces": REPLACES[name, b > 1],
                    "launches": launches[wl, b][name], "max_abs_err": err,
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                    "bound_by": by, "library_ms": lib[name]})
                print(f"time {wl} x{b} {name}: {ms:.4f} ms (bound {bms:.4f} ms "
                      f"by {by}, {bms / ms:.2f} of bound), plain {plain_ms:.4f} "
                      f"ms, library "
                      f"{'n/a' if lib[name] is None else f'{lib[name]:.4f} ms'}, "
                      f"max_abs_err {err:.3e}")
            if b == BUCKET:
                # the engine's other device work per bucket: the stack copy
                items = list(yc.unbind(0))
                stack_ms[wl] = event_ms(lambda: torch.stack(items, out=out))
                print(f"time {wl} x{b} bucket stack: {stack_ms[wl]:.4f} ms")
                del items
            del out
    print(json.dumps({"kernels": rows,
                      "engine_ms": {
                          wl: {"bucket_latency": v[0] * 1e3,
                               "per_request_latency": v[1] * 1e3,
                               "bucket_stack": stack_ms[wl]}
                          for wl, v in latency.items()}}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
