"""One rank of the CPU mesh that ``test_torch_train_mesh.py`` starts.

    python tests/_torch_train_mesh_worker.py <rank> <world> <dir>

Joins a gloo world through ``file://<dir>/rendezvous`` and reads
``<dir>/cases.json``. For each case it builds the case's mesh, cuts the
full initial parameters of ``<dir>/init_<case>.pt`` into this rank's
shards, and runs the sharded train step (``make_train_step(mesh=,
param_specs=)``) on the global batches of the data pipeline, recording
each step's loss, gradient norm and ``Mesh.counts()``. Then, when asked,
the launcher (``launch.train.run`` on a 2x2 mesh with a checkpoint, and
again on a 1x4 mesh that restores it and trains on; the production meshes
of the world) and GSP whole-network
sparsification (``sae_factory._gsp`` on a mesh from the full parameters
of ``<dir>/init_gsp.pt``; with ``"fault"``, again with the psum over
"model" of ``collectives.enter``'s backward skipped, a fault the checks
must catch). Saves its shards and numbers to
``<dir>/rank<rank>.pt``. Imports the port only (never JAX).
"""

import contextlib
import dataclasses
import json
import sys
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch import models
from repro_torch.configs.registry import smoke_config
from repro_torch.configs.types import ProjectionSpec, TrainConfig
from repro_torch.data import DataConfig, DataPipeline
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.params import param_specs
from repro_torch.optim import adamw
from repro_torch.parallel import collectives, sharding
from repro_torch.parallel.mesh import Mesh
from repro_torch.training.sae_factory import _gsp
from repro_torch.training.step import make_train_step


def case_setup(case):
    """(cfg, tcfg, pipeline) of a case; the test builds its reference from
    the same function."""
    cfg = dataclasses.replace(smoke_config(case["arch"]), vocab=case["vocab"],
                              n_kv_heads=case["kv_heads"])
    tcfg = TrainConfig(microbatch=case["micro"], lr=3e-4,
                       total_steps=case["steps"], warmup=1,
                       remat=case["remat"], master_dtype="",
                       compute_dtype="float32",
                       grad_allreduce_dtype=case.get("acc", ""),
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
    full = torch.load(tmp / f"init_{case['name']}.pt")
    params = sharding.shard_tree(full, specs, mesh)
    state = {"params": params, "opt": adamw.init(params, tcfg)}
    step = make_train_step(cfg, tcfg, api, impl="flash", mesh=mesh,
                           param_specs=specs)
    out = {"specs": specs, "losses": [], "grad_norms": [], "counts": []}
    for i in range(case["steps"]):
        mesh.reset_counts()
        state, m = step(state, {"tokens": torch.from_numpy(pipe.batch(i))})
        out["counts"].append(mesh.counts())
        out["losses"].append(float(m["loss"]))
        out["grad_norms"].append(float(m["grad_norm"]))
    out["params"] = state["params"]
    out["m"], out["v"] = state["opt"]["m"], state["opt"]["v"]
    out["step"] = int(state["opt"]["step"])
    return out


def run_launcher(cfg, tmp):
    argv = ["--smoke", "--device", "cpu", "--batch", str(cfg["batch"]),
            "--microbatch", str(cfg["micro"]), "--seq", str(cfg["seq"]),
            "--radius", str(cfg["radius"]), "--ckpt", str(tmp / "ckpt"),
            "--ckpt-every", "2"]
    first = train_cli.run(argv + ["--mesh", "2x2", "--steps", "2"])
    second = train_cli.run(argv + ["--mesh", "1x4", "--steps", "3"])
    return {k: {"losses": r["losses"], "grad_norms": r["grad_norms"],
                "start": r["start"], "sparsity": r["sparsity"],
                "collectives": r["collectives"], "params": r["state"]["params"]}
            for k, r in (("2x2", first), ("1x4", second))}


@contextlib.contextmanager
def skipped_enter_psum():
    """A fault: ``collectives.enter``'s backward returns this rank's own
    gradient, without the psum over "model"."""
    keep = collectives._Enter.backward
    collectives._Enter.backward = staticmethod(lambda ctx, g: (g, None, None))
    try:
        yield
    finally:
        collectives._Enter.backward = keep


def main(rank, world, tmp):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                            rank=rank, world_size=world)
    cfg = json.loads((tmp / "cases.json").read_text())
    res = {"cases": {c["name"]: run_case(c, tmp) for c in cfg.get("cases", [])}}
    if cfg.get("launcher"):
        res["launcher"] = run_launcher(cfg["launcher"], tmp)
        res["production"] = [dict(make_production_mesh(multi_pod=p).shape)
                             for p in (False, True)]
    if cfg.get("gsp"):
        g = cfg["gsp"]
        mesh = Mesh(g["sizes"], g["axes"])
        def gsp():
            return {dt: _gsp(g["arch"], mesh=mesh, steps=g["steps"], device="cpu",
                             params=torch.load(tmp / "init_gsp.pt"),
                             compute_dtype=dt)
                    for dt in g["compute"]}

        res["gsp"] = gsp()
        if g.get("fault"):
            with skipped_enter_psum():
                res["gsp_fault"] = gsp()
    torch.save(res, tmp / f"rank{rank}.pt")
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
