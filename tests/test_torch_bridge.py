"""The port's in-step telemetry bridge (``repro_torch.obs.bridge``) against
the JAX package's ``jax_bridge``, on the CPU.

* JAX's ``TestBridge`` cases (``tests/test_obs.py:196-279``) on the port's
  bridge, and ``profile.host_span``;
* the gate off: a step built with ``telemetry_every=3`` issues the same
  aten operations, in the same order, as one built with 0 (recorded with a
  ``TorchDispatchMode``);
* the registry after three steps of ``make_train_step(telemetry_every=1,
  telemetry_marks=True)`` (smoke granite-3-2b, the bi-level projection on
  ``(w_up|w_gate)``) against JAX's under ``jax_bridge.enabled_scope()``:
  gauges within 1e-5 relative (float32 sums in another order), the mark
  histograms one observation per step;
* the queue of values in flight on a card: ``drain()`` with nothing
  pending returns at once, and folds pending entries in order once their
  events complete (stand-in events here; the card's are held by
  ``chip_smoke.py`` phase 10 (d)).
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import models as jmodels
from repro.configs import registry as jreg
from repro.configs import types as jtypes
from repro.data import DataConfig as JDataConfig
from repro.data import DataPipeline as JDataPipeline
from repro.obs import jax_bridge
from repro.obs import metrics as jmetrics
from repro.training import step as jstep
from repro_torch import interop
from repro_torch import models as tmodels
from repro_torch.configs import registry as treg
from repro_torch.configs import types as ttypes
from repro_torch.launch import train as train_cli
from repro_torch.obs import bridge, metrics, profile
from repro_torch.optim import adamw as tadamw
from repro_torch.training import step as tstep

ARCH = "granite-3-2b"
BATCH, MICRO, SEQ, STEPS = 4, 2, 16, 3


@pytest.fixture()
def reg():
    """A fresh registry installed as the process-global one."""
    fresh = metrics.Registry()
    prev = metrics.set_registry(fresh)
    yield fresh
    metrics.set_registry(prev)


@pytest.fixture()
def jreg_fresh():
    fresh = jmetrics.Registry()
    prev = jmetrics.set_registry(fresh)
    yield fresh
    jmetrics.set_registry(prev)


# ---------------------------------------------------------- JAX's TestBridge
def test_gate_scope_restores():
    before = bridge.enabled()
    with bridge.enabled_scope(True):
        assert bridge.enabled()
        with bridge.enabled_scope(False):
            assert not bridge.enabled()
        assert bridge.enabled()
    assert bridge.enabled() == before


def test_gate_off_touches_nothing(reg):
    """With the gate off, report and mark return before their arguments are
    looked at: no operation, nothing in the registry."""
    x = torch.arange(4.0)
    with bridge.enabled_scope(False), _Ops() as ops:
        y = x * 2.0
        bridge.report("bridge_gauge", y.sum())
        bridge.mark("span_start")
        bridge.mark("span_end")
    assert [o for o in ops.names if "sum" in o] == ["aten.sum.default"]
    assert "bridge_gauge" not in reg.snapshot()
    assert "span_seconds" not in reg.snapshot()


def test_report_kinds_land_in_registry(reg):
    with bridge.enabled_scope(True):
        for _ in range(2):
            x = torch.arange(3.0)
            bridge.report("b_gauge", x.max())
            bridge.report("b_count", torch.tensor(2.0), kind="counter")
            bridge.report("b_hist", x.min(), kind="hist", labels={"leaf": "w"})
    bridge.drain()
    assert reg.gauge("b_gauge").value == 2.0
    assert reg.counter("b_count").value == 4.0        # inc'd per call
    h = reg.histogram("b_hist", labels=("leaf",)).labels(leaf="w")
    assert h.count == 2 and h.sum == 0.0


def test_report_bad_kind():
    with bridge.enabled_scope(True):
        with pytest.raises(ValueError, match="unknown bridge kind"):
            bridge.report("x", 1.0, kind="summary")


def test_mark_pairs_into_histogram(reg):
    with bridge.enabled_scope(True):
        for _ in range(3):
            bridge.mark("span_start")
            torch.eye(8) @ torch.eye(8)
            bridge.mark("span_end", device="cpu")
    h = reg.histogram("span_seconds")
    assert h.count == 3
    assert h.sum >= 0.0


def test_mark_name_validated():
    with bridge.enabled_scope(True):
        with pytest.raises(ValueError, match="_start or _end"):
            bridge.mark("span")


def test_unmatched_end_dropped(reg):
    bridge._mark_record("orphan_end", None)
    assert "orphan_seconds" not in reg.snapshot()


def test_host_span_is_a_profiler_range():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profile.host_span("dispatch/pick"):
            torch.ones(2) + 1
    assert "dispatch/pick" in {e.key for e in prof.key_averages()}


# ------------------------------------------------------ values on the card
class _Event:
    """A stand-in CUDA event: completes after ``after`` seconds."""

    def __init__(self, after, log):
        self.due, self.log = time.perf_counter() + after, log

    def query(self):
        return time.perf_counter() >= self.due

    def synchronize(self):
        self.log.append("wait")
        while not self.query():
            time.sleep(0.001)


def test_drain_with_nothing_pending_returns_at_once():
    assert not bridge._pending
    t0 = time.perf_counter()
    bridge.drain()
    assert time.perf_counter() - t0 < 0.05


def test_pending_values_fold_in_order(reg):
    """Entries in flight fold once their events complete: a later report
    folds the completed head and leaves the rest, drain() waits for all."""
    log = []
    with bridge.enabled_scope(True):
        bridge._pending.append(("value", _Event(0.0, log), torch.tensor(1.0),
                                "q_gauge", "gauge", None))
        bridge._pending.append(("value", _Event(60.0, log), torch.tensor(2.0),
                                "q_gauge", "gauge", None))
        bridge.report("other", 5.0)
        assert reg.gauge("q_gauge").value == 1.0 and len(bridge._pending) == 1
        bridge._pending[0][1].due = time.perf_counter() + 0.01
        bridge.drain()
    assert reg.gauge("q_gauge").value == 2.0 and not bridge._pending
    assert log == ["wait"]


# ------------------------------------------------------ the train step's
class _Ops(TorchDispatchMode):
    """Records every aten operation dispatched inside it."""

    def __enter__(self):
        self.names = []
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


def _tcfgs():
    kw = dict(microbatch=MICRO, lr=3e-4, total_steps=STEPS, warmup=2,
              remat=True, master_dtype="", compute_dtype="float32")
    jt = jtypes.TrainConfig(**kw, projection=jtypes.ProjectionSpec(
        pattern=r"(w_up|w_gate)", radius=1.0))
    tt = ttypes.TrainConfig(**kw, projection=ttypes.ProjectionSpec(
        pattern=r"(w_up|w_gate)", radius=1.0))
    return jt, tt


def _tokens(cfg, step):
    return JDataPipeline(JDataConfig(vocab=cfg.vocab, seq_len=SEQ + 1,
                                     global_batch=BATCH,
                                     microbatch=MICRO)).batch(step)


def _port_state(jstate, tt):
    params = interop.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jstate["params"]), device="cpu")
    return {"params": params, "opt": tadamw.init(params, tt)}


@pytest.mark.parametrize("fused", [True, False])
def test_gate_off_step_issues_the_same_ops(fused):
    """``telemetry_every=3`` (and marks) with the bridge off against
    ``telemetry_every=0``: the same aten sequence on every one of 3 steps."""
    cfg = jreg.smoke_config(ARCH)
    jt, tt = _tcfgs()
    jstate = jstep.init_state(cfg, jt, jmodels.get(cfg), jax.random.PRNGKey(0))
    tcfg = treg.smoke_config(ARCH)
    api = tmodels.get(tcfg)
    seqs = []
    for every, marks in ((0, False), (3, True)):
        fn = tstep.make_train_step(tcfg, tt, api, impl="naive", fused=fused,
                                   telemetry_every=every,
                                   telemetry_marks=marks)
        state = _port_state(jstate, tt)
        names = []
        with bridge.enabled_scope(False):
            for s in range(STEPS):
                with _Ops() as ops:
                    state, _ = fn(state, {"tokens": torch.from_numpy(
                        _tokens(cfg, s))})
                names.append(ops.names)
        seqs.append(names)
    assert all(len(n) > 100 for n in seqs[0])
    assert seqs[0] == seqs[1]


def test_registry_values_match_jax(reg, jreg_fresh):
    """Three instrumented steps in both packages: the same gauges (loss,
    gradient norm, per projected leaf zero fraction and feasibility gap)
    within 1e-5 relative, and one epilogue mark per step."""
    cfg = jreg.smoke_config(ARCH)
    jt, tt = _tcfgs()
    japi = jmodels.get(cfg)
    jstate = jstep.init_state(cfg, jt, japi, jax.random.PRNGKey(0))
    tstate = _port_state(jstate, tt)
    tcfg = treg.smoke_config(ARCH)
    tfn = tstep.make_train_step(tcfg, tt, tmodels.get(tcfg), impl="naive",
                                telemetry_every=1, telemetry_marks=True)
    with jax_bridge.enabled_scope(True):
        jfn = jax.jit(jstep.make_train_step(cfg, jt, japi, impl="naive",
                                            telemetry_every=1,
                                            telemetry_marks=True))
        for s in range(STEPS):
            jstate, _ = jfn(jstate, {"tokens": jnp.asarray(_tokens(cfg, s))})
        jax.block_until_ready(jstate)
        jax.effects_barrier()
    with bridge.enabled_scope(True):
        for s in range(STEPS):
            tstate, _ = tfn(tstate, {"tokens": torch.from_numpy(
                _tokens(cfg, s))})
        bridge.drain()
    want, got = jreg_fresh.snapshot(), reg.snapshot()
    gauges = ("train_loss", "train_grad_norm", "train_param_zero_frac",
              "train_feasibility_gap")
    leaves = {"blocks/mlp/w_gate", "blocks/mlp/w_up"}
    for name in gauges:
        w, g = want[name], got[name]
        assert g["kind"] == w["kind"] == "gauge"
        wv = {tuple(sorted(s["labels"].items())): s["value"]
              for s in w["values"]}
        gv = {tuple(sorted(s["labels"].items())): s["value"]
              for s in g["values"]}
        assert gv.keys() == wv.keys()
        if name.startswith("train_param") or name.startswith("train_feas"):
            assert {dict(k)["leaf"] for k in gv} == leaves
        for k in wv:
            np.testing.assert_allclose(gv[k], wv[k], rtol=1e-5, atol=1e-7,
                                       err_msg=f"{name} {k}")
    # feasible after projection: the gap is at most float32 rounding above 0
    for s in got["train_feasibility_gap"]["values"]:
        assert s["value"] <= 1e-5
    h = reg.histogram("train_epilogue_seconds")
    assert h.count == STEPS == jreg_fresh.histogram(
        "train_epilogue_seconds").count


def test_cadence_counts_on_the_host(reg):
    """``telemetry_every=2`` over 3 steps emits at step 2 only; the state's
    step is read once (when the gate first lets a step emit)."""
    cfg = jreg.smoke_config(ARCH)
    jt, tt = _tcfgs()
    jstate = jstep.init_state(cfg, jt, jmodels.get(cfg), jax.random.PRNGKey(0))
    tstate = _port_state(jstate, tt)
    tcfg = treg.smoke_config(ARCH)
    fn = tstep.make_train_step(tcfg, tt, tmodels.get(tcfg), impl="naive",
                               telemetry_every=2)
    losses = []
    with bridge.enabled_scope(True):
        for s in range(STEPS):
            tstate, m = fn(tstate, {"tokens": torch.from_numpy(_tokens(cfg, s))})
            losses.append(float(m["loss"]))
    h = reg.snapshot()["train_loss"]["values"]
    assert len(h) == 1 and h[0]["value"] == pytest.approx(losses[1], rel=1e-7)


def test_launcher_telemetry_flags(reg, tmp_path):
    """The train launcher's flags run the instrumented step (and restore
    the gate after the run); the metrics snapshot holds the gauges."""
    before = bridge.enabled()
    out = tmp_path / "m.jsonl"
    train_cli.run(["--device", "cpu", "--smoke", "--steps", "2", "--batch",
                   "4", "--microbatch", "2", "--seq", "8", "--radius", "1.0",
                   "--telemetry-every", "1", "--telemetry-marks",
                   "--metrics-out", str(out)])
    assert bridge.enabled() == before
    snap = reg.snapshot()
    for name in ("train_loss", "train_grad_norm", "train_param_zero_frac",
                 "train_feasibility_gap", "train_epilogue_seconds"):
        assert name in snap, name
    assert reg.histogram("train_epilogue_seconds").count == 2
    assert "train_loss" in out.read_text()


# ------------------------------------------------------------- under a mesh
MESH_CASE = dict(name="telemetry_2x2", arch=ARCH, widths={}, moments="float32",
                 telemetry_every=1, steps=2, micro=4, batch=8, seq=16,
                 radius=1.0, sizes=[2, 2], axes=["data", "model"])


def _mesh_reference(case, worker):
    """The single-device unfused step from the same init, instrumented:
    (init, losses, grad norms, registry snapshot, final moments)."""
    from repro_torch import _tree as T
    from repro_torch.models.params import init_params

    cfg, tcfg, pipe = worker.case_setup(case)
    api = tmodels.get(cfg)
    p = init_params(api.template(cfg), 0, device="cpu")
    init = T.tree_map(lambda x: x.clone(), p)
    st = {"params": p, "opt": tadamw.init(p, tcfg)}
    fn = tstep.make_train_step(cfg, tcfg, api, impl="flash", fused=False,
                               telemetry_every=case["telemetry_every"])
    losses, gnorms = [], []
    prev = metrics.set_registry(metrics.Registry())
    try:
        with bridge.enabled_scope(True):
            for i in range(case["steps"]):
                st, m = fn(st, {"tokens": torch.from_numpy(pipe.batch(i))})
                losses.append(float(m["loss"]))
                gnorms.append(float(m["grad_norm"]))
        snap = metrics.get_registry().snapshot()
    finally:
        metrics.set_registry(prev)
    return init, losses, gnorms, snap, st["opt"]


def run_mesh_cases(cases, tmp, world=4):
    """Start ``world`` gloo ranks of ``_torch_bridge_mesh_worker.py`` on
    ``cases`` and return the single-device references and every rank's
    results."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    here = Path(__file__).resolve().parent
    sys.path.insert(0, str(here))
    import _torch_bridge_mesh_worker as worker

    refs = {}
    for c in cases:
        refs[c["name"]] = _mesh_reference(c, worker)
        torch.save(refs[c["name"]][0], tmp / f"init_{c['name']}.pt")
    (tmp / "cases.json").write_text(json.dumps(cases))
    env = dict(os.environ, PYTHONPATH=str(here.parent / "src"))
    procs = [subprocess.Popen([sys.executable, str(here / "_torch_bridge_mesh_worker.py"),
                               str(r), str(world), str(tmp)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(world)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return refs, [torch.load(tmp / f"rank{r}.pt") for r in range(world)]


def test_mesh_step_telemetry_matches_one_device(tmp_path):
    """The sharded step's registry (4 gloo ranks, (2, 2) mesh): every rank
    reports the global loss, gradient norm and each projected leaf's
    statistics of the whole leaf, within 1e-5 relative of the
    single-device step (float32 sums in another order)."""
    refs, ranks = run_mesh_cases([MESH_CASE], tmp_path)
    _, losses, gnorms, want, _ = refs[MESH_CASE["name"]]
    for res in ranks:
        got = res[MESH_CASE["name"]]
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
        np.testing.assert_allclose(got["grad_norms"], gnorms, rtol=1e-5)
        snap = got["snapshot"]
        for name in ("train_loss", "train_grad_norm", "train_param_zero_frac",
                     "train_feasibility_gap"):
            wv = {tuple(v["labels"].items()): v["value"]
                  for v in want[name]["values"]}
            gv = {tuple(v["labels"].items()): v["value"]
                  for v in snap[name]["values"]}
            assert gv.keys() == wv.keys() and wv
            for k in wv:
                np.testing.assert_allclose(gv[k], wv[k], rtol=1e-5, atol=1e-6,
                                           err_msg=f"{name} {k}")
