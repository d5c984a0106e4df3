"""One rank of the CPU mesh that ``test_torch_bridge.py`` starts.

    python tests/_torch_bridge_mesh_worker.py <rank> <world> <dir>

Joins a gloo world through ``file://<dir>/rendezvous`` and reads
``<dir>/cases.json``. For each case it cuts the full initial parameters of
``<dir>/init_<case>.pt`` into this rank's shards and runs the sharded train
step (``make_train_step(mesh=, param_specs=)``) with the case's moment
dtype and ``telemetry_every``, the telemetry bridge on and a fresh
registry. Saves each case's losses, gradient norms, the registry's
snapshot and the AdamW moments gathered whole to ``<dir>/rank<rank>.pt``.
Imports the port only (never JAX).
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
from repro_torch.models.params import param_specs
from repro_torch.obs import bridge, metrics
from repro_torch.optim import adamw
from repro_torch.parallel import collectives, sharding
from repro_torch.parallel.mesh import Mesh
from repro_torch.training.step import make_train_step


def case_setup(case):
    """(cfg, tcfg, pipeline) of a case; the test builds its reference from
    the same function."""
    cfg = dataclasses.replace(smoke_config(case["arch"]), **case["widths"])
    tcfg = TrainConfig(microbatch=case["micro"], lr=1e-3,
                       total_steps=case["steps"], warmup=1, remat=True,
                       master_dtype="", compute_dtype="float32",
                       moment_dtype=case["moments"],
                       projection=ProjectionSpec(pattern=r"(w_up|w_gate)",
                                                 radius=case["radius"]))
    pipe = DataPipeline(DataConfig(vocab=cfg.vocab, seq_len=case["seq"] + 1,
                                   global_batch=case["batch"],
                                   microbatch=case["micro"]))
    return cfg, tcfg, pipe


def run_case(case, tmp):
    cfg, tcfg, pipe = case_setup(case)
    mesh = Mesh(case["sizes"], case["axes"])
    api = models.get(cfg)
    specs = param_specs(api.template(cfg), sharding.param_rules(mesh),
                        sharding.mesh_shape_dict(mesh))
    ospecs = adamw.state_specs(specs, api.template(cfg), tcfg)
    params = sharding.shard_tree(torch.load(tmp / f"init_{case['name']}.pt"),
                                 specs, mesh)
    state = {"params": params,
             "opt": adamw.init(params, tcfg)}
    step = make_train_step(cfg, tcfg, api, impl="flash", mesh=mesh,
                           param_specs=specs,
                           telemetry_every=case["telemetry_every"])
    out = {"losses": [], "grad_norms": []}
    prev = metrics.set_registry(metrics.Registry())
    try:
        with bridge.enabled_scope(True):
            for i in range(case["steps"]):
                state, m = step(state, {"tokens": torch.from_numpy(
                    pipe.batch(i))})
                out["losses"].append(float(m["loss"]))
                out["grad_norms"].append(float(m["grad_norm"]))
            bridge.drain()
        out["snapshot"] = metrics.get_registry().snapshot()
    finally:
        metrics.set_registry(prev)
    out["moments"] = {
        part: _tree.tree_map(lambda x, sp: collectives.gather_full(x, sp, mesh),
                             state["opt"][part], ospecs[part])
        for part in ("m", "v")}
    return out


def main(rank, world, tmp):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                            rank=rank, world_size=world)
    cases = json.loads((tmp / "cases.json").read_text())
    res = {c["name"]: run_case(c, tmp) for c in cases}
    torch.save(res, tmp / f"rank{rank}.pt")
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
