"""One rank of the CPU mesh that ``test_torch_train_mesh_moe.py`` starts.

    python tests/_torch_train_mesh_moe_worker.py <rank> <world> <dir>

Joins a gloo world through ``file://<dir>/rendezvous`` and reads
``<dir>/cases.json``. For each case (an MoE smoke config, a dispatch and a
mesh) it cuts the full initial parameters of ``<dir>/init_<arch>.pt`` into
this rank's shards and runs the sharded train step
(``make_train_step(mesh=, param_specs=, n_groups=dp_shards)``) on the
global batches of the data pipeline, recording each step's loss, gradient
norm and ``Mesh.counts()``, step 1's moments, the final shards of the
parameters and AdamW's moments, and every MoE layer's route (``g``,
``tg``, ``cap``, ``top_i``, ``keep``) and balance loss in one sharded
forward of the first micro-batch. Then it projects an expert leaf through
the mesh-native hook, and runs the train launcher (``launch.train.run``)
of each arch on the same world with the case file's arguments. Saves them
to ``<dir>/rank<rank>.pt``. Imports the port only (never JAX).
"""

import dataclasses
import json
import sys
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch import _tree, models
from repro_torch.configs.registry import smoke_config
from repro_torch.configs.types import ProjectionSpec, TrainConfig
from repro_torch.data import DataConfig, DataPipeline
from repro_torch.launch import train as train_cli
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models.params import param_specs
from repro_torch.optim import adamw
from repro_torch.optim.projection_hook import make_projection_hook
from repro_torch.parallel import sharding
from repro_torch.parallel.mesh import Mesh
from repro_torch.training.step import make_train_step

# the train launcher's constraint: the dense, shared and expert w_up/w_gate
PATTERN = r"(w_up|w_gate)"
# the expert leaf the hook projects on its own, and its levels (bi-level)
HOOK_LEAF = "moe_blocks/mlp/w_up"


def case_setup(case):
    """(cfg, tcfg, pipeline) of a case; the test builds its references from
    the same function."""
    cfg = smoke_config(case["arch"])
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, dispatch=case["dispatch"]))
    tcfg = TrainConfig(microbatch=case["micro"], lr=3e-4,
                       total_steps=case["steps"], warmup=1, remat=True,
                       master_dtype="", compute_dtype="float32",
                       projection=ProjectionSpec(pattern=PATTERN,
                                                 radius=case["radius"]))
    pipe = DataPipeline(DataConfig(vocab=cfg.vocab, seq_len=case["seq"] + 1,
                                   global_batch=case["batch"],
                                   microbatch=case["micro"]))
    return cfg, tcfg, pipe


def record_routes(fn):
    """``fn()`` with every ``moe_route`` recorded: its groups, capacity,
    experts and kept slots, in call order."""
    routes, route = [], L.moe_route

    def spy(*a, **k):
        r = route(*a, **k)
        routes.append({key: r[key] for key in ("g", "tg", "cap", "top_i",
                                                "keep")})
        return r

    L.moe_route = spy
    try:
        out = fn()
    finally:
        L.moe_route = route
    return out, routes


def run_case(case, tmp):
    cfg, tcfg, pipe = case_setup(case)
    mesh = Mesh(case["sizes"], ("data", "model"))
    api = models.get(cfg)
    dp = sharding.dp_shards(mesh)
    specs = param_specs(api.template(cfg), sharding.param_rules(mesh),
                        sharding.mesh_shape_dict(mesh))
    params = sharding.shard_tree(torch.load(tmp / f"init_{case['arch']}.pt"),
                                 specs, mesh)
    out = {"specs": specs, "losses": [], "grad_norms": [], "counts": []}
    # one sharded forward of the first micro-batch: routes and balance loss
    mb = pipe.batch(0)[0]
    local = sharding.shard(torch.from_numpy(mb),
                           sharding.tokens_spec(mesh, None, mb.shape[0])[1:],
                           mesh)
    with torch.no_grad():
        (_, aux), out["routes"] = record_routes(lambda: lm.forward(
            params, local[:, :-1], cfg, impl="chunked", n_groups=dp,
            mesh=mesh, param_specs=specs))
    out["aux"] = float(aux)
    state = {"params": params, "opt": adamw.init(params, tcfg)}
    step = make_train_step(cfg, tcfg, api, impl="chunked", n_groups=dp,
                           mesh=mesh, param_specs=specs)
    for i in range(case["steps"]):
        mesh.reset_counts()
        state, m = step(state, {"tokens": torch.from_numpy(pipe.batch(i))})
        out["counts"].append(mesh.counts())
        out["losses"].append(float(m["loss"]))
        out["grad_norms"].append(float(m["grad_norm"]))
        if i == 0:   # step 1's moments hold the gradient itself
            for key in ("m", "v"):
                out[f"{key}1"] = _tree.tree_map(torch.clone, state["opt"][key])
    out["params"] = state["params"]
    out["m"], out["v"] = state["opt"]["m"], state["opt"]["v"]
    # the hook alone on an expert-sharded leaf of another value
    w = torch.load(tmp / "hook_leaf.pt")
    leaf_specs = {"moe_blocks": {"mlp": {"w_up": specs["moe_blocks"]["mlp"]["w_up"]}}}
    hook = make_projection_hook(ProjectionSpec(pattern=PATTERN,
                                               radius=case["hook_radius"]),
                                mesh=mesh, param_specs=leaf_specs)
    shard = sharding.shard(w, leaf_specs["moe_blocks"]["mlp"]["w_up"], mesh)
    out["hook"] = hook({"moe_blocks": {"mlp": {"w_up": shard}}}, 0)[
        "moe_blocks"]["mlp"]["w_up"]
    return out


def main(rank, world, tmp):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                            rank=rank, world_size=world)
    cfg = json.loads((tmp / "cases.json").read_text())
    res = {"cases": {c["name"]: run_case(c, tmp) for c in cfg["cases"]},
           "launch": {}}
    for arch in cfg["archs"]:
        run = train_cli.run(cfg["launch"] + ["--arch", arch])
        res["launch"][arch] = {k: run[k] for k in ("losses", "collectives",
                                                   "sparsity")}
    torch.save(res, tmp / f"rank{rank}.pt")
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
