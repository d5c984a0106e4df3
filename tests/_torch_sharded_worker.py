"""One rank of the CPU mesh that ``test_torch_sharded.py`` starts.

    python tests/_torch_sharded_worker.py <rank> <world> <dir>

Joins a gloo world through ``file://<dir>/rendezvous``, reads
``<dir>/cases.json``, and projects its shard of every case through the port's
mesh executor: both bodies (plain and codegen, whose kernels run their plain
versions on the CPU), the projection hook on the granite smoke leaves of
``<dir>/hook_params.pt``, and the planner's sharded backend. Saves its
shards and collective counts to ``<dir>/rank<rank>.pt``. Imports the port
only (never JAX).
"""

import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.registry import smoke_config
from repro_torch.configs.types import ProjectionSpec
from repro_torch.core import plan, sharded
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import lm
from repro_torch.models.params import param_specs
from repro_torch.optim.projection_hook import make_projection_hook
from repro_torch.parallel import sharding


def rand(shape, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.normal(size=shape) * 2).astype(np.float32))


def run_case(mesh, case):
    full = rand(case["shape"], case["seed"])
    y = sharding.shard(full, case["spec"], mesh)
    out = {}
    for backend in ("plain", "codegen"):
        mesh.reset_counts()
        x = sharded.multilevel_project_sharded(
            y, case["levels"], case["radius"], mesh=mesh, spec=case["spec"],
            shape=case["shape"], method=case.get("method", "sort"),
            batch_dims=case["batch_dims"], backend=backend)
        out[backend] = x
        out[f"counts_{backend}"] = mesh.counts()
    return out


def main(rank, world, tmp):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                            rank=rank, world_size=world)
    mesh = make_host_mesh(1, world)
    cfg = json.loads((tmp / "cases.json").read_text())
    res = {"cases": {c["name"]: run_case(mesh, c) for c in cfg["cases"]}}

    # the ineligible orientation refuses codegen on every rank alike
    try:
        sharded.multilevel_project_sharded(
            torch.zeros(4, 16, 16), [("inf", 1), ("inf", 1), ("1", 1)], 1.0,
            mesh=mesh, spec=("model", None, None), backend="codegen")
        res["gate_raises"] = False
    except ValueError:
        res["gate_raises"] = True

    # a 2 x 2 mesh: rows over "data", columns over "model" (line groups)
    mesh22 = make_host_mesh(2, world // 2)
    full = rand((32, 64), 31)
    y22 = sharding.shard(full, ("data", "model"), mesh22)
    res["mesh22"] = {}
    for backend in ("plain", "codegen"):
        mesh22.reset_counts()
        res["mesh22"][backend] = sharded.multilevel_project_sharded(
            y22, [("inf", 1), ("1", 1)], 2.5, mesh=mesh22, spec=("data", "model"),
            shape=(32, 64), backend=backend)
        res["mesh22"][f"counts_{backend}"] = mesh22.counts()

    # the two historical specials: thin wrappers over the schedule body
    y2 = sharding.shard(rand((32, 64), 21), (None, "model"), mesh)
    y3 = sharding.shard(rand((4, 16, 64), 22), (None, None, "model"), mesh)
    res["specials"] = {
        "make_bilevel": sharded.make_sharded_bilevel(mesh, "model")(y2, 2.0, (32, 64)),
        "bilevel_body": sharded.bilevel_project_sharded(y2, 2.0, axis_name="model",
                                                        mesh=mesh),
        "make_trilevel": sharded.make_sharded_trilevel(mesh, "model")(y3, 2.0,
                                                                      (4, 16, 64)),
        "trilevel_body": sharded.trilevel_project_sharded(y3, 2.0, axis_name="model",
                                                          mesh=mesh),
    }
    try:
        sharded.make_sharded_bilevel(mesh, "model")(y2, 2.0, (32, 62))
        res["uneven_special_raises"] = False
    except ValueError:
        res["uneven_special_raises"] = True

    # the sharded projection hook on the granite smoke leaves
    params = torch.load(tmp / "hook_params.pt")
    blocks = lm.template(smoke_config("granite-3-2b"))["blocks"]
    template = {k: {n: blocks[k][n] for n in v} for k, v in params.items()}
    specs = param_specs(template, sharding.param_rules(mesh, fsdp=False),
                        sharding.mesh_shape_dict(mesh))
    local = {k: {n: sharding.shard(w, specs[k][n], mesh) for n, w in v.items()}
             for k, v in params.items()}
    res["hook_specs"] = specs
    for backend in ("plain", "codegen"):
        p = local
        for hs in cfg["hook"]:
            hook = make_projection_hook(ProjectionSpec(**hs), mesh=mesh,
                                        param_specs=specs, backend=backend)
            p = hook(p, 0)
        res[f"hook_{backend}"] = p

    # the planner: method="auto" among the mesh executor's bodies, timed on
    # every rank and decided on rank 0; then the sharded body by name
    shape, levels, spec = cfg["plan"]["shape"], cfg["plan"]["levels"], cfg["plan"]["spec"]
    y = sharding.shard(rand(shape, 12), spec, mesh)
    auto = plan.make_plan(shape, torch.float32, levels, device="cpu",
                          sharding=(mesh, spec))
    forced = plan.make_plan(shape, torch.float32, levels, device="cpu",
                            sharding=(mesh, spec), method="sharded")
    res["plan"] = {"method": auto.method, "candidates": sorted(auto.timings_us),
                   "auto": auto(y, 2.0), "forced": forced(y, 2.0)}
    try:
        plan.make_plan(shape, torch.float32, levels, device="cpu",
                       sharding=(mesh, spec), method="bisect")
        res["plan"]["generic_raises"] = False
    except ValueError:
        res["plan"]["generic_raises"] = True
    torch.save(res, tmp / f"rank{rank}.pt")
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
