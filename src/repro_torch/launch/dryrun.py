"""Multi-node dry run: walk every (arch × shape × mesh) cell on the ``meta``
device (port of ``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-2b \
        --shape train_4k --mesh single --out experiments/dryrun_torch

The JAX dry run lowers and compiles each cell for 256 or 512 forced host
devices. This one runs one rank's step of each cell (``launch/specs.py``)
on ``meta`` tensors under an ``AbstractMesh`` of the production layout
(``launch/mesh.py``: "single" = 32 × 8 H100s, "multi" = 2 × 32 × 8),
walked by ``roofline/costs.py``: nothing is allocated on any device, and
a real tensor handed to a cell raises. A train cell walks one micro-batch
and counts it ``n_micro`` times (``Costs.repeat``).

Each cell's record (one JSON per cell, ``<out>/<arch>__<shape>__<mesh>.json``,
so ``--resume`` skips the ones done) has the JAX record's keys: ``memory``
(argument, output and temporary bytes per device; ``generated_code_bytes``
None), ``roofline`` (``roofline/analysis.py``, the H100's terms),
``model_flops``, ``params_total``/``params_active`` and ``useful_ratio``;
``lower_s`` is the seconds to build the cell and ``compile_s`` those of
the walk. A serving cell has no collective term (``note`` says why).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import torch

from repro_torch import _tree
from repro_torch.configs import registry
from repro_torch.configs.types import SHAPES
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import make_abstract_mesh
from repro_torch.roofline import analysis as RF
from repro_torch.roofline import costs as C


def check_abstract(args) -> None:
    """Raise unless every tensor among ``args`` is a ``meta`` tensor: the
    dry run never runs a real tensor in place of the card."""
    for path, t in _tree.leaves_with_paths({"args": _as_tree(args)}):
        if isinstance(t, torch.Tensor) and not t.is_meta:
            raise ValueError(f"dry run: {path} is a tensor on {t.device}; a "
                             "cell's arguments are meta tensors (abstract, no "
                             "allocation)")


def _as_tree(x):
    if isinstance(x, (tuple, list)):
        return {str(i): _as_tree(v) for i, v in enumerate(x)}
    if isinstance(x, dict):
        return {k: _as_tree(v) for k, v in x.items()}
    return x


def _tensor_bytes(x) -> int:
    seen, total = set(), 0
    for _, t in _tree.leaves_with_paths({"x": _as_tree(x)}):
        if isinstance(t, torch.Tensor) and id(t) not in seen:
            seen.add(id(t))
            total += t.numel() * t.element_size()
    return total


def walk_cell(cell):
    """``(costs, output_bytes)`` of one rank's step of ``cell``: a train
    cell walks its first micro-batch and counts it ``n_micro`` times; a
    serving cell's single-device step is divided by the chips."""
    check_abstract(cell["args"])
    args = cell["args"]
    n = cell["n_micro"]
    if cell["kind"] == "train" and n > 1:
        state, batch = args
        args = (state, {"tokens": batch["tokens"][:1]})
    mesh = cell["mesh"] if cell["collectives"] else None
    with C.walk(mesh=mesh) as w:
        out = cell["fn"](*args)
    out_bytes = _tensor_bytes(out)
    del out
    costs = w.costs.repeat("micro_batch", n) if cell["kind"] == "train" \
        else w.costs
    if not cell["collectives"]:   # the single-device step, per chip
        chips = cell["mesh"].size
        per = C.Costs()
        per.add(costs, 1.0 / chips)
        per.peak_bytes = costs.peak_bytes // chips
        costs, out_bytes = per, out_bytes // chips
    return costs, out_bytes


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: str = "",
             verbose: bool = True):
    cfg = registry.get_arch(arch)
    shape = SHAPES[shape_name]
    skip = SP.cell_skipped(cfg, shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "time": time.time()}
    if skip:
        rec["status"] = "skipped"
        rec["reason"] = skip
        return rec

    mesh = make_abstract_mesh(mesh_kind)
    chips = mesh.size
    t0 = time.time()
    try:
        cell = SP.build_cell(cfg, shape, mesh)
        t_build = time.time() - t0
        costs, out_bytes = walk_cell(cell)
        t_walk = time.time() - t0 - t_build
        roof = RF.analyze(costs, chips, collectives=cell["collectives"])
        rec.update(
            status="ok",
            lower_s=round(t_build, 1),
            compile_s=round(t_walk, 1),
            chips=chips,
            memory={
                "argument_bytes": int(cell["arg_bytes"]),
                "output_bytes": int(out_bytes),
                "temp_bytes": int(costs.peak_bytes),
                "generated_code_bytes": None,
            },
            roofline=roof.as_dict(),
            kernels={k: dict(v) for k, v in costs.kernels.items()},
        )
        if cell.get("note"):
            rec["note"] = cell["note"]
        tokens = shape.seq_len * shape.global_batch if shape.kind != "decode" \
            else shape.global_batch
        napi = _param_count(cfg)
        rec["model_flops"] = RF.model_flops(
            napi["active"], tokens, "train" if shape.kind == "train" else "serve")
        rec["params_total"] = napi["total"]
        rec["params_active"] = napi["active"]
        rec["useful_ratio"] = (rec["model_flops"] / roof.flops_global
                               if roof.flops_global else None)
        if verbose:
            coll = ("-" if roof.t_collective is None
                    else f"{roof.t_collective * 1e3:.1f}ms")
            print(f"[{arch} × {shape_name} × {mesh_kind}] OK "
                  f"walk={t_walk:.1f}s "
                  f"mem/dev={_fmt_bytes(_per_dev_bytes(rec))} "
                  f"terms: C={roof.t_compute * 1e3:.1f}ms "
                  f"M={roof.t_memory * 1e3:.1f}ms "
                  f"K={coll} -> {roof.bottleneck}", flush=True)
    except Exception as e:  # noqa: BLE001 - report and continue the sweep
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        if verbose:
            print(f"[{arch} × {shape_name} × {mesh_kind}] FAIL {rec['error']} "
                  f"({time.time() - t0:.1f}s)", file=sys.stderr, flush=True)
    return rec


def _param_count(cfg):
    from repro_torch import models
    from repro_torch.models import params as PM

    tpl = models.get(cfg).template(cfg)
    total = PM.count_params(tpl)
    active = total
    if cfg.moe is not None:
        # subtract inactive routed experts
        mo = cfg.moe
        n_moe_layers = cfg.n_layers - mo.first_dense
        per_expert = 3 * cfg.d_model * mo.d_expert
        inactive = n_moe_layers * (mo.n_experts - mo.top_k) * per_expert
        active = total - inactive
    return {"total": int(total), "active": int(active)}


def _per_dev_bytes(rec):
    m = rec.get("memory", {})
    vals = [v for k, v in m.items() if isinstance(v, (int, float))
            and k in ("argument_bytes", "temp_bytes")]
    return sum(vals) if vals else 0


def _fmt_bytes(b):
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(b) < 1024:
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}PB"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all",
                    help="arch id, comma list, or 'all' (assigned archs)")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--resume", action="store_true",
                    help="skip cells whose json already exists")
    args = ap.parse_args(argv)

    archs = registry.ASSIGNED if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    os.makedirs(args.out, exist_ok=True)

    n_ok = n_fail = 0
    t0 = time.time()
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                path = os.path.join(args.out,
                                    f"{arch}__{shape}__{mesh_kind}.json")
                if args.resume and os.path.exists(path):
                    continue
                t = time.time()
                rec = run_cell(arch, shape, mesh_kind, args.out)
                rec["seconds"] = round(time.time() - t, 2)
                print(f"  {arch} × {shape} × {mesh_kind}: {rec['status']} in "
                      f"{rec['seconds']:.2f} s", flush=True)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                if rec["status"] == "error":
                    n_fail += 1
                else:
                    n_ok += 1
    print(f"dry-run sweep done: {n_ok} ok/skip, {n_fail} failed "
          f"({time.time() - t0:.1f} s)")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
