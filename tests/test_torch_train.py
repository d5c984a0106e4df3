"""Parity of the port's LM training (``repro_torch.training.step``, the
``runtime`` package and ``launch.train``) with the JAX package's, on the CPU.

* ``xent`` and ``make_loss_fn`` against JAX's on the same logits, targets,
  parameters and tokens;
* three steps of ``make_train_step`` on ``smoke_config("granite-3-2b")``
  (4 layers, 4 query heads over 1 kv head: GQA group 4) with the bi-level
  projection on ``(w_up|w_gate)`` and the launcher's settings (no master
  copy, warmup ``min(20, steps // 5 + 1)``, remat on), from parameters the
  JAX package initialised and carried across with
  ``interop.from_numpy_tree``. The port runs ``impl="flash"`` (the
  kernels' plain versions on the CPU, through the autograd Function and
  ``torch.utils.checkpoint``), JAX ``impl="naive"``;
* checkpoints in the JAX package's layout, both ways, and the port's own
  save / restore / keep-K / atomicity;
* the launcher's CLI on the CPU, and the copied resilience helpers against
  JAX's on the same simulated timings.

Tolerances: float32 compute within 1e-5 (losses and gradient norms
relative, parameters 1e-5 of the leaf's largest entry plus 1e-5 relative:
sums in another order). bf16 compute rounds every matmul input and
activation to bf16 in both packages, at other places: losses within 1e-2
relative, gradient norms within 5e-2 relative, and parameters within
2 · Σ lr_t over the steps so far plus 1e-5 of the leaf's largest entry.
AdamW normalises each update to about lr_t, so a gradient entry that
rounds to the other sign in one package moves its parameter by +lr_t there
and -lr_t in the other (the projection is non-expansive and adds nothing).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.configs import registry as jreg
from repro.configs import types as jtypes
from repro.data import DataConfig as JDataConfig
from repro.data import DataPipeline as JDataPipeline
from repro.runtime import CheckpointManager as JCheckpointManager
from repro.runtime import resilience as jres
from repro.training import step as jstep
from repro_torch import _tree, interop
from repro_torch import models as tmodels
from repro_torch.configs import registry as treg
from repro_torch.configs import types as ttypes
from repro_torch.data import DataConfig, DataPipeline
from repro_torch.launch import train as train_cli
from repro_torch.runtime import CheckpointManager
from repro_torch.runtime import resilience as tres
from repro_torch.training import step as tstep

ARCH = "granite-3-2b"
STEPS = 3
RADIUS = 1.0
BATCH, MICRO, SEQ = 4, 2, 24


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tcfgs(compute_dtype):
    """The launcher's TrainConfig in both packages (launch/train.py:80-86)."""
    kw = dict(microbatch=MICRO, lr=3e-4, total_steps=STEPS,
              warmup=min(20, STEPS // 5 + 1), remat=True, master_dtype="",
              compute_dtype=compute_dtype, checkpoint_every=2)
    jt = jtypes.TrainConfig(**kw, projection=jtypes.ProjectionSpec(
        pattern=r"(w_up|w_gate)", radius=RADIUS))
    tt = ttypes.TrainConfig(**kw, projection=ttypes.ProjectionSpec(
        pattern=r"(w_up|w_gate)", radius=RADIUS))
    return jt, tt


def _tokens(cfg, step=0):
    jb = JDataPipeline(JDataConfig(vocab=cfg.vocab, seq_len=SEQ + 1,
                                   global_batch=BATCH, microbatch=MICRO)).batch(step)
    tb = DataPipeline(DataConfig(vocab=cfg.vocab, seq_len=SEQ + 1,
                                 global_batch=BATCH, microbatch=MICRO)).batch(step)
    np.testing.assert_array_equal(jb, tb)
    return tb


# ------------------------------------------------------------------ losses
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xent_matches_jax(dtype):
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(3, 7, 50)) * 4).astype(np.float32)
    targets = rng.integers(0, 50, (3, 7)).astype(np.int32)
    want = float(jstep.xent(jnp.asarray(logits).astype(getattr(jnp, dtype)),
                            jnp.asarray(targets)))
    got = tstep.xent(torch.from_numpy(logits).to(getattr(torch, dtype)),
                     torch.from_numpy(targets))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


@pytest.mark.parametrize("impl", ["naive", "chunked", "flash"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_fn_matches_jax(impl, dtype):
    """The port's LM loss against JAX's on the same params and tokens (JAX
    runs its "naive" attention where the port runs "flash": both are the
    same function, and JAX's flash path needs the TPU). bf16 compute within
    1e-2 relative (activations rounded at other places)."""
    cfg = jreg.smoke_config(ARCH)
    jp = jmodels.params.init_params(jmodels.get(cfg).template(cfg),
                                    jax.random.PRNGKey(1))
    toks = _tokens(cfg)[0]
    jloss = jstep.make_loss_fn(cfg, jmodels.get(cfg),
                               impl="naive" if impl == "flash" else impl,
                               n_groups=1, remat=True,
                               compute_dtype=getattr(jnp, dtype))
    want = float(jloss(jp, jnp.asarray(toks)))
    tcfg = treg.smoke_config(ARCH)
    tloss = tstep.make_loss_fn(tcfg, tmodels.get(tcfg), impl=impl, remat=True,
                               compute_dtype=getattr(torch, dtype))
    tp = interop.from_numpy_tree(_np(jp), device="cpu")
    got = float(tloss(tp, torch.from_numpy(toks)))
    np.testing.assert_allclose(got, want, rtol=1e-6 if dtype == "float32" else 1e-2)


# ------------------------------------------------------------------- steps
def _run_both(dtype):
    cfg = jreg.smoke_config(ARCH)
    assert cfg.n_layers == 4 and cfg.n_heads // cfg.n_kv_heads == 4
    japi = jmodels.get(cfg)
    jt, tt = _tcfgs(dtype)
    jstate = jstep.init_state(cfg, jt, japi, jax.random.PRNGKey(tt.seed))
    tcfg = treg.smoke_config(ARCH)
    tstate = {"params": interop.from_numpy_tree(_np(jstate["params"]),
                                                device="cpu")}
    from repro_torch.optim import adamw as tadamw
    tstate["opt"] = tadamw.init(tstate["params"], tt)
    jfn = jax.jit(jstep.make_train_step(cfg, jt, japi, impl="naive"))
    tfn = tstep.make_train_step(tcfg, tt, tmodels.get(tcfg), impl="flash")
    out = []
    for step in range(STEPS):
        toks = _tokens(cfg, step)
        jstate, jm = jfn(jstate, {"tokens": jnp.asarray(toks)})
        tstate, tm = tfn(tstate, {"tokens": torch.from_numpy(toks)})
        out.append((_np(jstate["params"]), {k: float(v) for k, v in jm.items()},
                    _tree.tree_map(lambda t: t.clone(), tstate["params"]),
                    {k: float(v) for k, v in tm.items()}))
    return out


def _leaf_close(got, want, atol_abs, what):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * scale + atol_abs, err_msg=what)


def test_three_steps_match_jax_float32():
    steps = _run_both("float32")
    for i, (jp, jm, tp, tm) in enumerate(steps):
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5,
                                       err_msg=f"step {i + 1} {k}")
        for name, t in _tree.leaves_with_paths(tp):
            want = _tree_get(jp, name)
            _leaf_close(t.numpy(), want, 0.0, f"step {i + 1} {name}")
    # the constraint is active: some columns of the projected stacks are 0
    last = steps[-1][2]["blocks"]["mlp"]
    for leaf in ("w_up", "w_gate"):
        cols = last[leaf].abs().amax(dim=1)             # (L, f)
        assert 0 < int((cols == 0).sum()) < cols.numel()


def test_three_steps_match_jax_bfloat16():
    steps = _run_both("bfloat16")
    for i, (jp, jm, tp, tm) in enumerate(steps):
        np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=1e-2,
                                   err_msg=f"step {i + 1} loss")
        np.testing.assert_allclose(tm["grad_norm"], jm["grad_norm"], rtol=5e-2,
                                   err_msg=f"step {i + 1} grad_norm")
        lr_sum = sum(s[1]["lr"] for s in steps[:i + 1])
        for name, t in _tree.leaves_with_paths(tp):
            _leaf_close(t.numpy(), _tree_get(jp, name), 2 * lr_sum,
                        f"step {i + 1} {name}")


def _tree_get(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return np.asarray(tree)


def test_make_train_step_keeps_loss_fn_override():
    """``loss_fn=`` still replaces the LM loss (the SAE factory's use)."""
    tt = _tcfgs("float32")[1]
    params = {"w": torch.ones(3, 4)}
    from repro_torch.optim import adamw as tadamw
    state = {"params": params, "opt": tadamw.init(params, tt)}
    fn = tstep.make_train_step(None, tt, loss_fn=lambda p, x: (p["w"] * x).sum())
    state, m = fn(state, {"tokens": torch.ones(2, 1, 3, 4)})
    assert float(m["loss"]) == 12.0


def test_init_state_is_the_template_and_adamw():
    cfg = treg.smoke_config(ARCH)
    _, tt = _tcfgs("float32")
    st = tstep.init_state(cfg, tt, tmodels.get(cfg), 0, device="cpu")
    assert set(st) == {"params", "opt"} and set(st["opt"]) == {"step", "m", "v"}
    assert st["params"]["blocks"]["mlp"]["w_up"].shape == (4, 64, 128)
    assert st["params"]["embed"].dtype == torch.float32
    assert int(st["opt"]["step"]) == 0


# ------------------------------------------------------------- checkpoints
def test_jax_written_training_checkpoint_restores_into_the_port(tmp_path):
    cfg = jreg.smoke_config(ARCH)
    jt, _ = _tcfgs("float32")
    jstate = jstep.init_state(cfg, jt, jmodels.get(cfg), jax.random.PRNGKey(3))
    jstate["params"]["extra_bf16"] = jnp.linspace(-2, 2, 12,
                                                  dtype=jnp.bfloat16).reshape(3, 4)
    JCheckpointManager(str(tmp_path), keep=3).save(7, jstate)
    state, manifest = CheckpointManager(tmp_path).restore(device="cpu")
    assert manifest["step"] == 7
    flat_j = dict(jax.tree_util.tree_flatten_with_path(jstate)[0])
    want = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in flat_j.items()}
    got = dict(_tree.leaves_with_paths(state))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        t = got[name]
        assert tuple(t.shape) == w.shape, name
        if name.endswith("extra_bf16"):
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(t.float().numpy(), w.astype(np.float32))
        else:
            assert str(t.numpy().dtype) == str(w.dtype), name
            np.testing.assert_array_equal(t.numpy(), w, err_msg=name)


def test_port_checkpoint_layout_is_the_jax_packages(tmp_path):
    state = {"params": {"a": torch.arange(6.0).reshape(2, 3),
                        "b": torch.tensor([1.5, -2.0], dtype=torch.bfloat16)},
             "opt": {"step": torch.tensor(5, dtype=torch.int32)}}
    CheckpointManager(tmp_path).save(5, state, extra={"note": "x"})
    d = tmp_path / "step_00000005"
    man = json.loads((d / "manifest.json").read_text())
    assert man["step"] == 5 and man["note"] == "x"
    assert man["keys"] == ["opt/step", "params/a", "params/b"]
    assert man["dtypes"] == {"opt/step": "int32", "params/a": "float32",
                             "params/b": "bfloat16"}
    assert man["shapes"]["params/a"] == [2, 3]
    z = np.load(d / "arrays.npz")
    assert sorted(z.files) == ["opt╱step", "params╱a", "params╱b"]
    np.testing.assert_array_equal(z["params╱a"], state["params"]["a"].numpy())
    assert z["params╱b"].dtype == np.dtype("V2")      # what numpy makes of JAX's bf16
    # the JAX package's manager reads the port's checkpoints (it cannot
    # read bf16 records back, its own or the port's, so this one has none)
    del state["params"]["b"]
    CheckpointManager(tmp_path).save(6, state)
    jmgr = JCheckpointManager(str(tmp_path))
    assert jmgr.all_steps() == [5, 6]
    jstate, jman = jmgr.restore()
    assert jman["step"] == 6
    np.testing.assert_array_equal(np.asarray(jstate["params"]["a"]),
                                  state["params"]["a"].numpy())
    assert int(jstate["opt"]["step"]) == 5


def test_save_restore_keep_and_atomicity(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    states = {}
    for step in (1, 2, 3, 4):
        states[step] = {"w": torch.full((3,), float(step)),
                        "step": torch.tensor(step, dtype=torch.int32)}
        (mgr.save_async if step % 2 else mgr.save)(step, states[step])
    mgr.wait()
    assert mgr.all_steps() == [3, 4]                     # keep-K
    (tmp_path / "step_00000009.tmp").mkdir()             # a crashed save
    assert mgr.latest_step() == 4
    got, man = mgr.restore(device="cpu")
    assert man["step"] == 4
    torch.testing.assert_close(got["w"], states[4]["w"], rtol=0, atol=0)
    torch.testing.assert_close(got["step"], states[4]["step"], rtol=0, atol=0)
    got3, _ = mgr.restore(3, device="cpu")
    torch.testing.assert_close(got3["w"], states[3]["w"], rtol=0, atol=0)
    # an async save holds the values of the moment it was called
    live = {"w": torch.zeros(2)}
    mgr.save_async(10, live)
    live["w"].add_(7.0)
    mgr.wait()
    torch.testing.assert_close(mgr.restore(10, device="cpu")[0]["w"],
                               torch.zeros(2), rtol=0, atol=0)
    assert CheckpointManager(tmp_path / "empty").restore(device="cpu") == (None, None)


# ---------------------------------------------------------------- launcher
def test_launcher_cpu_smoke_prints_the_jax_lines(tmp_path, capsys):
    ck = tmp_path / "ck"
    rc = train_cli.main(["--device", "cpu", "--smoke", "--steps", "3",
                         "--radius", "1.0", "--ckpt", str(ck)])
    assert rc == 0
    lines = capsys.readouterr().out.splitlines()
    step_lines = [ln for ln in lines if ln.startswith("step ")]
    assert len(step_lines) == 1 and step_lines[0].startswith("step     3 loss ")
    assert " gnorm " in step_lines[0]
    sp = [ln for ln in lines if ln.startswith("column sparsity ")]
    assert [ln.split(":")[0] for ln in sp] == [
        "column sparsity blocks/mlp/w_gate", "column sparsity blocks/mlp/w_up"]
    assert all(ln.endswith("%") for ln in sp)
    assert CheckpointManager(ck).all_steps() == [3]
    # restart from the checkpoint: the run resumes at step 3
    out = train_cli.run(["--device", "cpu", "--smoke", "--steps", "4",
                         "--radius", "1.0", "--ckpt", str(ck)])
    assert out["start"] == 3 and len(out["losses"]) == 1
    assert "[elastic restart] resuming from step 3" in capsys.readouterr().out


def test_launcher_run_is_the_step_function(tmp_path):
    """``run`` trains exactly ``make_train_step(impl="flash")`` on the
    pipeline's batches from the seed-0 init: its losses equal a hand loop."""
    out = train_cli.run(["--device", "cpu", "--smoke", "--steps", "2",
                         "--radius", "1.0", "--batch", "4", "--microbatch", "2",
                         "--seq", "16"])
    cfg = treg.smoke_config(ARCH)
    tt = ttypes.TrainConfig(microbatch=2, total_steps=2, warmup=1, remat=False,
                            master_dtype="", projection=ttypes.ProjectionSpec(
                                pattern=r"(w_up|w_gate)", radius=1.0))
    api = tmodels.get(cfg)
    state = tstep.init_state(cfg, tt, api, 0, device="cpu")
    fn = tstep.make_train_step(cfg, tt, api, impl="flash")
    pipe = DataPipeline(DataConfig(vocab=cfg.vocab, seq_len=17, global_batch=4,
                                   microbatch=2))
    for step, want in enumerate(out["losses"]):
        state, m = fn(state, {"tokens": torch.from_numpy(pipe.batch(step))})
        assert float(m["loss"]) == want
    for (name, a), b in zip(_tree.leaves_with_paths(out["state"]["params"]),
                            _tree.leaves(state["params"])):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)


@pytest.mark.parametrize("flags,match", [
    (["--mesh", "2x2"], "one device"),
    (["--telemetry-every", "-5"], "telemetry"),
    (["--telemetry-every", "-1", "--telemetry-marks"], "telemetry"),
])
def test_launcher_rejects_unported_options(flags, match):
    with pytest.raises(ValueError, match=match):
        train_cli.main(["--device", "cpu", "--smoke", "--steps", "1", *flags])


# -------------------------------------------------------------- resilience
def test_straggler_monitor_matches_jax():
    rng = np.random.default_rng(0)
    jm, tm = jres.StragglerMonitor(4, min_samples=3), tres.StragglerMonitor(4, min_samples=3)
    for step in range(12):
        times = {h: float(1.0 + 0.05 * rng.random()) for h in range(4)}
        if step >= 4:
            times[2] *= 2.0 if step < 8 else 4.0
        assert dataclasses.asdict(tm.record(times)) == dataclasses.asdict(
            jm.record(times))
    rep = tm.record({h: 1.0 if h != 2 else 5.0 for h in range(4)})
    assert rep.stragglers == [2] and rep.action in ("warn", "evict")


def test_heartbeat_and_restarts(tmp_path):
    hb = tres.HeartbeatFile(str(tmp_path / "hb"), timeout=10.0)
    hb.beat(0)
    hb.beat(1)
    os.utime(tmp_path / "hb" / "host_1", (0, 0))
    assert hb.dead_hosts(3) == [1, 2]

    mgr = CheckpointManager(tmp_path / "ck")
    calls = []

    def train_fn(resume):
        calls.append(resume)
        if len(calls) < 3:
            mgr.save(len(calls) * 10, {"w": torch.zeros(1)})
            raise RuntimeError("host lost")
        return 30

    assert tres.run_with_restarts(train_fn, mgr, max_restarts=3) == 30
    assert calls == [None, 10, 20]
    with pytest.raises(RuntimeError, match="host lost"):
        tres.run_with_restarts(lambda r: (_ for _ in ()).throw(
            RuntimeError("host lost")), mgr, max_restarts=1)


def test_launcher_writes_the_last_step_once(tmp_path, monkeypatch):
    """With ``--ckpt-every`` dividing ``--steps`` the loop's async save holds
    the last step; the final save does not write the same state again."""
    writes = []
    orig = CheckpointManager._write
    monkeypatch.setattr(CheckpointManager, "_write",
                        lambda self, step, host, extra: (writes.append(step),
                                                         orig(self, step, host, extra)))
    out = train_cli.run(["--device", "cpu", "--smoke", "--steps", "3",
                         "--ckpt-every", "3", "--ckpt", str(tmp_path)])
    assert writes == [3]
    state, _ = CheckpointManager(tmp_path).restore(device="cpu")
    for (name, a), b in zip(_tree.leaves_with_paths(state),
                            _tree.leaves(out["state"])):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
    writes.clear()
    train_cli.run(["--device", "cpu", "--smoke", "--steps", "4",
                   "--ckpt-every", "2", "--ckpt", str(tmp_path / "b")])
    assert writes == [2, 4]
