"""The port's sharded train step on 4 gloo CPU ranks against its
single-device unfused step, and the launcher under a mesh.

One module-scoped run starts 4 rank processes
(``_torch_train_mesh_worker.py``, a ``file://`` rendezvous in a temporary
directory). Each case trains ``smoke_config("granite-3-2b")`` (4 layers,
d 64, 4 q heads, ffn 128) in float32 for 2 steps with the bi-level
projection on ``(w_up|w_gate)``, under ``param_rules(mesh)`` (heads, kv
heads, ffn and vocabulary over "model" where they divide, FSDP of 'embed'
over "data"): the meshes (1, 4), (2, 2), (4, 1) and the pod mesh
(2, 1, 2) at vocab 256 (sharded over "model"), (2, 2) at vocab 255
(replicated), the smoke's one kv head (replicated: each rank picks the kv
head its q heads read) and two kv heads on (1, 4) (replicated, two groups)
and on (2, 2) (sharded), remat on and off, and bf16 gradient
accumulation. JAX's own mesh path does not run on this host (ROADMAP § 3),
so the reference is the port's single-device unfused step
(``make_train_step(fused=False)``), which ``test_torch_train_unfused.py``
holds to JAX's.

Tolerances: loss and gradient norm within 1e-5 relative; AdamW's moments
within 1e-5 of the leaf's largest entry; parameters within 1e-5 of the
leaf's largest entry plus 1e-5 relative, except where the first step's
gradient (clipped) is below 1e-5 = 1e3 · AdamW's eps: there the update
g / (|g| + eps) turns on the gradient's last bits, which sums in another
order move, and the bound is AdamW's per-step move, 2 · Σ lr_t. The bf16
accumulation case holds the gradient norm to 2e-3 relative (one bf16
rounding of the psum, 2^-9) and the loss of step 1 to 1e-5. Replicated
leaves (and every rank's copy of a sharded slice) are bit-identical
across ranks, and every rank's collectives per step equal
``training.step.step_collectives``' model.

The launcher (``launch.train.run``) trains 2 steps on a 2 × 2 world with a
checkpoint, then a 1 × 4 run restores it and trains step 3. The
checkpoint holds the full tree, which JAX's ``CheckpointManager`` reads
back equal to the gathered shards; step 3 matches the single-device
launcher restoring the same checkpoint within bf16 tolerance (the launcher
computes in bf16: 1e-3 relative on the loss, 1e-2 on the gradient norm).
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import _tree, models
from repro_torch.configs.registry import smoke_config
from repro_torch.configs.types import ProjectionSpec, TrainConfig
from repro_torch.launch import train as train_cli
from repro_torch.models.params import init_params, param_specs
from repro_torch.optim import adamw
from repro_torch.parallel import sharding
from repro_torch.training.step import make_train_step, step_collectives

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _torch_train_mesh_worker import case_setup  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "_torch_train_mesh_worker.py"
WORLD = 4
DM, PDM = ["data", "model"], ["pod", "data", "model"]
BASE = dict(arch="granite-3-2b", vocab=256, kv_heads=1, steps=2, micro=4,
            batch=8, seq=16, remat=True, radius=1.0)
CASES = [dict(BASE, name=n, sizes=s, axes=a, **kw) for n, s, a, kw in [
    ("mesh_1x4", [1, 4], DM, {}),
    ("mesh_2x2", [2, 2], DM, {}),
    ("mesh_4x1", [4, 1], DM, {}),
    ("pod_2x1x2", [2, 1, 2], PDM, {}),
    ("vocab255_2x2", [2, 2], DM, {"vocab": 255}),
    ("kv2_1x4", [1, 4], DM, {"kv_heads": 2, "remat": False}),
    ("kv2_2x2", [2, 2], DM, {"kv_heads": 2}),
    ("bf16acc_2x2", [2, 2], DM, {"acc": "bfloat16"}),
]]
NAMES = [c["name"] for c in CASES]
LAUNCHER = dict(batch=8, micro=4, seq=16, radius=1.0)


def _reference(case):
    """The single-device unfused step from the same init: per-step loss and
    gradient norm, the first step's moments, the final state."""
    cfg, tcfg, pipe = case_setup(case)
    api = models.get(cfg)
    p = init_params(api.template(cfg), 0, device="cpu")
    full = _tree.tree_map(lambda x: x.clone(), p)
    st = {"params": p, "opt": adamw.init(p, tcfg)}
    fn = make_train_step(cfg, tcfg, api, impl="flash", fused=False)
    out = {"init": full, "losses": [], "grad_norms": [], "lr": []}
    for i in range(case["steps"]):
        st, m = fn(st, {"tokens": torch.from_numpy(pipe.batch(i))})
        out["losses"].append(float(m["loss"]))
        out["grad_norms"].append(float(m["grad_norm"]))
        out["lr"].append(float(m["lr"]))
        if i == 0:
            out["m1"] = _tree.tree_map(lambda x: x.clone(), st["opt"]["m"])
    out["state"] = st
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_mesh")
    (tmp / "cases.json").write_text(json.dumps({"cases": CASES,
                                                "launcher": LAUNCHER}))
    refs = {}
    for c in CASES:
        refs[c["name"]] = _reference(c)
        torch.save(refs[c["name"]]["init"], tmp / f"init_{c['name']}.pt")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(r), str(WORLD),
                               str(tmp)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=240)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    ranks = [torch.load(tmp / f"rank{r}.pt") for r in range(WORLD)]
    return ranks, refs, tmp


def _case(name):
    return next(c for c in CASES if c["name"] == name)


def _sizes(case):
    return dict(zip(case["axes"], case["sizes"]))


def _full(ranks, name, key):
    res = [r["cases"][name] for r in ranks]
    return sharding.unshard_tree([r[key] for r in res], res[0]["specs"],
                                 _sizes(_case(name)))


@pytest.mark.parametrize("name", NAMES)
def test_loss_and_grad_norm_match_single_device(runs, name):
    ranks, refs, _ = runs
    ref = refs[name]
    bf16 = _case(name).get("acc") == "bfloat16"
    for r in ranks:
        got = r["cases"][name]
        np.testing.assert_allclose(got["losses"][0], ref["losses"][0], rtol=1e-5)
        np.testing.assert_allclose(got["losses"], ref["losses"],
                                   rtol=2e-3 if bf16 else 1e-5)
        np.testing.assert_allclose(got["grad_norms"], ref["grad_norms"],
                                   rtol=2e-3 if bf16 else 1e-5)
        assert got["losses"] == ranks[0]["cases"][name]["losses"]
        assert got["grad_norms"] == ranks[0]["cases"][name]["grad_norms"]


@pytest.mark.parametrize("name", [n for n in NAMES if not n.startswith("bf16")])
def test_params_and_moments_match_single_device(runs, name):
    ranks, refs, _ = runs
    ref = refs[name]
    lr_sum = sum(ref["lr"])
    b1 = 0.9
    got_p, got_m, got_v = (_full(ranks, name, k) for k in ("params", "m", "v"))
    want = ref["state"]
    for (path, p), wp, m, wm, v, wv, m1 in zip(
            _tree.leaves_with_paths(got_p), _tree.leaves(want["params"]),
            _tree.leaves(got_m), _tree.leaves(want["opt"]["m"]),
            _tree.leaves(got_v), _tree.leaves(want["opt"]["v"]),
            _tree.leaves(ref["m1"])):
        for what, a, b in (("m", m, wm), ("v", v, wv)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-5 * float(b.abs().max()),
                                       err_msg=f"{name} {path} {what}")
        scale = float(wp.abs().max())
        well = (m1.abs() / (1 - b1)) >= 1e-5
        d = (p - wp).abs()
        bar = 1e-5 * scale + 1e-5 * wp.abs()
        assert bool((d[well] <= bar[well]).all()), (name, path, float(d[well].max()))
        assert float(d.max()) <= 2 * lr_sum, (name, path, float(d.max()))
    assert all(r["cases"][name]["step"] == _case(name)["steps"] for r in ranks)


@pytest.mark.parametrize("name", NAMES)
def test_replicated_copies_are_bit_identical(runs, name):
    """Ranks whose coordinates agree on every axis a leaf is sharded over
    hold the same slice of it: their copies of params and moments must be
    the same bits (a missing backward psum would let them drift)."""
    ranks, _, _ = runs
    case = _case(name)
    sizes = _sizes(case)
    specs = ranks[0]["cases"][name]["specs"]
    coords = [sharding.rank_coords(r, sizes) for r in range(WORLD)]
    for key in ("params", "m", "v"):
        per_rank = [_tree.leaves(r["cases"][name][key]) for r in ranks]
        for i, (path, sp) in enumerate(_tree.leaves_with_paths(specs)):
            axes = sharding.spec_axes(sp)
            for r in range(1, WORLD):
                for q in range(r):
                    if all(coords[r][a] == coords[q][a] for a in axes):
                        assert torch.equal(per_rank[r][i], per_rank[q][i]), \
                            (name, key, path, q, r)


@pytest.mark.parametrize("name", NAMES)
def test_collective_counts_match_the_model(runs, name):
    ranks, _, _ = runs
    case = _case(name)
    cfg, tcfg, pipe = case_setup(case)
    model = step_collectives(cfg, tcfg, ranks[0]["cases"][name]["specs"],
                             _sizes(case), pipe.batch(0).shape)
    want = {op: {"calls": model["calls"][op], "bytes": model["bytes"][op]}
            for op in model["calls"]}
    for r, res in enumerate(ranks):
        for i, counts in enumerate(res["cases"][name]["counts"]):
            assert counts["by_op"] == want, (r, i, counts["by_op"], want)


def test_launcher_checkpoint_is_the_full_tree_and_jax_reads_it(runs):
    from repro.runtime import CheckpointManager as JCheckpointManager

    ranks, _, tmp = runs
    cfg = smoke_config("granite-3-2b")
    tpl = models.get(cfg).template(cfg)
    for mesh, step in (({"data": 2, "model": 2}, 2), ({"data": 1, "model": 4}, 3)):
        key = "2x2" if step == 2 else "1x4"
        specs = param_specs(tpl, sharding.param_rules(mesh), mesh)
        full = sharding.unshard_tree([r["launcher"][key]["params"] for r in ranks],
                                     specs, mesh)
        tree, manifest = JCheckpointManager(str(tmp / "ckpt")).restore(step=step)
        assert manifest["step"] == step
        assert set(tree) == {"params", "opt"}
        assert set(tree["opt"]) == {"step", "m", "v"}
        assert int(np.asarray(tree["opt"]["step"])) == step
        for path, want in _tree.leaves_with_paths(full):
            got = tree["params"]
            for k in path.split("/"):
                got = got[k]
            np.testing.assert_array_equal(np.asarray(got), want.numpy(),
                                          err_msg=f"step {step} {path}")


def test_launcher_restores_onto_another_mesh(runs, tmp_path):
    ranks, _, tmp = runs
    two, four = ranks[0]["launcher"]["2x2"], ranks[0]["launcher"]["1x4"]
    assert two["start"] == 0 and four["start"] == 2
    assert len(two["losses"]) == 2 and len(four["losses"]) == 1
    assert np.isfinite(two["losses"] + four["losses"]).all()
    for r in ranks[1:]:  # only rank 0 prints, but every rank has the numbers
        assert r["launcher"]["1x4"]["losses"] == four["losses"]
    # the single-device launcher from the same checkpoint, step 3
    ck = tmp_path / "ckpt"
    ck.mkdir()
    shutil.copytree(tmp / "ckpt" / "step_00000002", ck / "step_00000002")
    one = train_cli.run(["--smoke", "--device", "cpu", "--batch", "8",
                         "--microbatch", "4", "--seq", "16", "--radius", "1.0",
                         "--ckpt", str(ck), "--ckpt-every", "2", "--steps", "3"])
    assert one["start"] == 2
    np.testing.assert_allclose(four["losses"], one["losses"], rtol=1e-3)
    np.testing.assert_allclose(four["grad_norms"], one["grad_norms"], rtol=1e-2)
    assert four["sparsity"].keys() == one["sparsity"].keys()
    # the launcher's collectives are the step's model (bf16 compute, no remat)
    cfg = smoke_config("granite-3-2b")
    for key, mesh in (("2x2", {"data": 2, "model": 2}),
                      ("1x4", {"data": 1, "model": 4})):
        tcfg = TrainConfig(microbatch=4, remat=False, master_dtype="",
                           projection=ProjectionSpec(pattern=r"(w_up|w_gate)",
                                                     radius=1.0))
        specs = param_specs(models.get(cfg).template(cfg),
                            sharding.param_rules(mesh), mesh)
        model = step_collectives(cfg, tcfg, specs, mesh, (2, 4, 17))
        for r in ranks:
            for counts in r["launcher"][key]["collectives"]:
                assert counts["by_op"] == {
                    op: {"calls": model["calls"][op], "bytes": model["bytes"][op]}
                    for op in model["calls"]}, (key, counts)


def test_production_meshes_lay_out_the_world(runs):
    """Four CPU ranks (no card: a model axis of 1): ("data", "model") =
    (4, 1), and with ``multi_pod`` ("pod", "data", "model") = (2, 2, 1)."""
    for r in runs[0]:
        assert r["production"] == [{"data": 4, "model": 1},
                                   {"pod": 2, "data": 2, "model": 1}]


def test_a_mesh_launch_without_a_world_raises():
    with pytest.raises(ValueError, match="torchrun"):
        train_cli.run(["--smoke", "--device", "cpu", "--mesh", "2x2",
                       "--steps", "1"])


def test_mesh_dims():
    assert train_cli.mesh_dims("2x2") == ((2, 2), ("data", "model"))
    assert train_cli.mesh_dims("2x1x2") == ((2, 1, 2), ("pod", "data", "model"))
    with pytest.raises(ValueError):
        train_cli.mesh_dims("2")
