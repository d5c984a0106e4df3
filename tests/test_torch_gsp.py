"""GSP whole-network sparsification, ``make_sae_train_step(l1=)`` and the
factory CLI's ``--gsp`` / ``--checkpoint`` of the port against the JAX
package, on the CPU.

* ``gsp_whole_network(device="cpu")`` from JAX's init (the smoke
  stablelm-1.6b: 4 layers, d 64, 4 heads, ffn 128, vocab 256; every >=2-D
  leaf projected bi-level at radius 3 by bisection; bf16 compute, as the
  JAX package's) against JAX's unsharded run: the same leaves projected,
  both feasible, the last loss within 1e-4 relative, each leaf's column
  sparsity within 1 point. bf16 compute rounds the activations at other
  places in the two packages; a gradient entry near zero that rounds to
  the other sign moves its parameter by ±lr in AdamW's first steps, and a
  column whose ∞-norm lies that close to its level's threshold goes either
  way. Measured: 1 and 2 of the unembedding's 256 columns (0.39 and 0.78
  points); every other leaf equal.
* The same run on four gloo ranks over a (1, 4) mesh
  (``_torch_train_mesh_worker.py``: the sharded step, leaves with sharded
  trailing axes projected in place) against the port's unsharded run: the
  same leaves, both feasible, the loss within 1e-5 relative (measured
  1.8e-6), column sparsity within 1 point, for the same reason (the
  sharded forward sums its bf16 partial products over ranks); and in
  float32 compute (``compute_dtype="float32"``), where only the order of
  the sums differs: the loss within 1e-5 and every leaf's column sparsity
  equal.
* A fault those bars must catch: the same four-rank run with the psum over
  "model" skipped in the backward of ``collectives.enter`` (each rank keeps
  its own heads' or ffn slice's part of the gradient entering a
  tensor-parallel branch) lies outside them. Measured: the loss 4.27e-5
  (bf16) and 3.62e-5 (float32) relative from the unsharded run, the largest
  per-leaf sparsity gap 5.47 and 6.64 points (against the bf16 bar's 1).
* ``make_sae_train_step(tcfg, l1=0.01)`` against JAX's from the same
  parameters and batches (float32): losses within 1e-5 relative, params
  within 1e-5 of the leaf's largest entry.
* ``launch.sae_factory --checkpoint`` on a checkpoint that JAX's
  ``CheckpointManager`` wrote of a smoke LM training state harvests what
  JAX's ``run_factory(lm_params=...)`` harvests from the same parameters
  (the meta exact, activations within 2e-5: 4 float32 layers, sums in
  another order); ``--gsp`` adds the GSP record to the summary.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.configs import registry as jreg
from repro.configs import types as jtypes
from repro.models import params as jparams, sae as jsae
from repro.runtime import CheckpointManager as JCheckpointManager
from repro.training import sae_factory as JF
from repro.training import step as jstep
from repro_torch import _tree, interop
from repro_torch.configs.types import ProjectionSpec, TrainConfig
from repro_torch.launch import sae_factory as tcli
from repro_torch.optim import adamw as tadamw
from repro_torch.training import sae_factory as TF

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "_torch_train_mesh_worker.py"
WORLD = 4
ARCH = "stablelm-1.6b"


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_init():
    """JAX's GSP init (``gsp_whole_network``'s own config and key)."""
    cfg = jreg.smoke_config(ARCH)
    tcfg = jtypes.TrainConfig(microbatch=2, lr=1e-3, warmup=2, total_steps=2,
                              master_dtype="", remat=False)
    state = jstep.init_state(cfg, tcfg, jmodels.get(cfg), jax.random.PRNGKey(0))
    return _np(state["params"])


@pytest.fixture(scope="module")
def gsp_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gsp")
    init = _jax_init()
    torch.save(interop.from_numpy_tree(init, device="cpu"), tmp / "init_gsp.pt")
    (tmp / "cases.json").write_text(json.dumps({"gsp": {
        "arch": ARCH, "sizes": [1, WORLD], "axes": ["data", "model"],
        "steps": 2, "compute": ["bfloat16", "float32"], "fault": True}}))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(r), str(WORLD),
                               str(tmp)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    want = JF.gsp_whole_network(steps=2)
    one = {dt: TF._gsp(steps=2, device="cpu", compute_dtype=dt,
                       params=interop.from_numpy_tree(init, device="cpu"))
           for dt in ("bfloat16", "float32")}
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
    saved = [torch.load(tmp / f"rank{r}.pt") for r in range(WORLD)]
    return want, one, [s["gsp"] for s in saved], [s["gsp_fault"] for s in saved]


def _sparsity_close(got, want):
    assert got["per_leaf_sparsity"].keys() == want["per_leaf_sparsity"].keys()
    for k, v in want["per_leaf_sparsity"].items():
        assert abs(got["per_leaf_sparsity"][k] - v) <= 1.0, k


def test_gsp_matches_jax_unsharded(gsp_runs):
    want, one, _, _ = gsp_runs
    one = one["bfloat16"]
    assert one["n_projected"] == want["n_projected"] == 11
    assert one["n_devices"] == want["n_devices"] == 1
    assert one["feasible"] and want["feasible"]
    np.testing.assert_allclose(one["loss"], want["loss"], rtol=1e-4)
    _sparsity_close(one, want)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_gsp_on_four_ranks_matches_unsharded(gsp_runs, dtype):
    _, one, four, _ = gsp_runs
    one = one[dtype]
    for g in four:
        assert g == four[0]  # every rank reports the same record
    g = four[0][dtype]
    assert g["n_devices"] == WORLD
    assert g["n_projected"] == one["n_projected"]
    assert g["feasible"] and one["feasible"]
    np.testing.assert_allclose(g["loss"], one["loss"], rtol=1e-5)
    if dtype == "float32":  # sums in another order only: the same columns
        assert g["per_leaf_sparsity"] == one["per_leaf_sparsity"]
    else:
        _sparsity_close(g, one)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_gsp_bars_catch_a_skipped_model_psum(gsp_runs, dtype):
    """The four-rank run with enter's backward psum skipped lies outside
    the bars of ``test_gsp_on_four_ranks_matches_unsharded``."""
    _, one, _, fault = gsp_runs
    one, g = one[dtype], fault[0][dtype]
    loss_rel = abs(g["loss"] - one["loss"]) / abs(one["loss"])
    gap = max(abs(g["per_leaf_sparsity"][k] - v)
              for k, v in one["per_leaf_sparsity"].items())
    print(f"gsp {dtype} with enter's psum skipped: loss {loss_rel:.2e} "
          f"relative, largest per-leaf sparsity gap {gap:.4f} points")
    bar = 1.0 if dtype == "bfloat16" else 0.0
    assert g["n_projected"] == one["n_projected"]
    assert gap > bar or loss_rel > 1e-5


def test_sae_step_with_l1_matches_jax():
    rng = np.random.default_rng(3)
    d_in, d_dict = 16, 32
    jt = jtypes.TrainConfig(microbatch=4, lr=1e-2, weight_decay=0.0, warmup=2,
                            total_steps=4, master_dtype="",
                            compute_dtype="float32", remat=False,
                            projection=jtypes.ProjectionSpec(
                                pattern=r"enc/w", radius=0.5, transpose=True))
    tt = TrainConfig(microbatch=4, lr=1e-2, weight_decay=0.0, warmup=2,
                     total_steps=4, master_dtype="", compute_dtype="float32",
                     remat=False, projection=ProjectionSpec(
                         pattern=r"enc/w", radius=0.5, transpose=True))
    jp = jparams.init_params(jsae.dict_template(d_in, d_dict),
                             jax.random.PRNGKey(0))
    jstate = {"params": jp, "opt": JF.adamw.init(jp, jt)}
    tp = interop.from_numpy_tree(_np(jp), device="cpu")
    tstate = {"params": tp, "opt": tadamw.init(tp, tt)}
    jfn = jax.jit(JF.make_sae_train_step(jt, l1=0.01))
    tfn = TF.make_sae_train_step(tt, l1=0.01)
    for i in range(4):
        x = rng.normal(size=(2, 4, d_in)).astype(np.float32)
        jstate, jm = jfn(jstate, {"tokens": jnp.asarray(x)})
        tstate, tm = tfn(tstate, {"tokens": torch.from_numpy(x)})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    for name, t in _tree.leaves_with_paths(tstate["params"]):
        want = np.asarray(jstate["params"][name.split("/")[0]][name.split("/")[1]])
        np.testing.assert_allclose(t.numpy(), want, rtol=0,
                                   atol=1e-5 * float(np.abs(want).max()), err_msg=name)
    # l1 enters the loss: the same step without it reads another loss
    plain = TF.make_sae_train_step(tt)(
        {"params": interop.from_numpy_tree(_np(jp), device="cpu"),
         "opt": tadamw.init(tp, tt)}, {"tokens": torch.ones(2, 4, d_in)})[1]
    l1 = TF.make_sae_train_step(tt, l1=0.01)(
        {"params": interop.from_numpy_tree(_np(jp), device="cpu"),
         "opt": tadamw.init(tp, tt)}, {"tokens": torch.ones(2, 4, d_in)})[1]
    assert float(l1["loss"]) > float(plain["loss"])


def test_cli_harvests_from_a_jax_checkpoint(tmp_path, capsys):
    cfg = jreg.smoke_config(ARCH)
    lm = jparams.init_params(jmodels.get(cfg).template(cfg), jax.random.PRNGKey(7))
    tcfg = jtypes.TrainConfig(master_dtype="")
    ck = tmp_path / "ckpt"
    mgr = JCheckpointManager(str(ck))
    mgr.save(5, {"params": lm, "opt": JF.adamw.init(lm, tcfg)})
    mgr.wait()
    out = tmp_path / "port"
    rc = tcli.main(["--device", "cpu", "--out", str(out), "--checkpoint", str(ck),
                    "--layers", "1", "--harvest-steps", "2", "--train-steps", "3",
                    "--seeds", "0", "--expansion", "2", "--gsp"])
    assert rc == 0
    printed = capsys.readouterr().out
    assert f"harvesting from checkpoint step 5 at {ck}" in printed
    assert "gsp: n_projected=11 feasible=True" in printed
    summary = json.loads((out / "summary.json").read_text())
    assert summary["gsp"]["n_projected"] == 11
    jd = tmp_path / "jax"
    jf = JF.SAEFactoryConfig(layers=(1,), harvest_steps=2, train_steps=3,
                             expansion=2)
    jsum = JF.run_factory(jf, jd, seeds=(0,), lm_params=lm)
    assert summary["meta"] == json.loads(json.dumps(jsum["meta"]))
    names = sorted(p.name for p in jd.glob("*.npy"))
    assert names and sorted(p.name for p in out.glob("*.npy")) == names
    for name in names:
        np.testing.assert_allclose(np.load(out / name), np.load(jd / name),
                                   atol=2e-5, rtol=0, err_msg=name)


def test_cli_reports_a_missing_checkpoint(tmp_path, capsys):
    rc = tcli.main(["--device", "cpu", "--out", str(tmp_path / "o"),
                    "--checkpoint", str(tmp_path / "empty")])
    assert rc == 1
    assert "no checkpoint found" in capsys.readouterr().err


def test_cli_reports_a_missing_checkpoint_on_every_rank(tmp_path):
    """Under torchrun with ``--gsp``, every rank looks for the checkpoint:
    each exits 1 on its own, none waits in GSP's collectives for the others.
    Two processes with torchrun's environment stand in for torchrun, whose
    agent would end the waiting rank itself."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.sae_factory", "--device",
         "cpu", "--out", str(tmp_path / "o"), "--gsp", "--checkpoint",
         str(tmp_path / "empty")],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 TORCHELASTIC_RUN_ID="t", RANK=str(r), LOCAL_RANK=str(r),
                 WORLD_SIZE="2", LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                 MASTER_PORT=str(port)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        errs = [p.communicate(timeout=120)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [1, 1], errs
    assert "no checkpoint found" in errs[0] and "no checkpoint found" not in errs[1]
    assert "Traceback" not in errs[1], errs[1][-4000:]
