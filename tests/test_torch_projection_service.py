"""The port's flush()-driven ``ProjectionService`` on the CPU against the JAX
package's (every case of ``tests/test_serving.py::TestProjectionService``),
and the ``ProjectionEngine.stats`` repair.

Each case submits the same numpy-seeded requests to both services and holds
the port's results to JAX's within atol = 1e-6 · max|Y| (float32 θ-solves
that sum in another order), its counters to JAX's exactly. JAX's
``trace_count`` (one trace for group sizes 3 and 4) becomes the bucket the
port's batch plan is called with: 4 both times.

A batch-native backend (``codegen_batch``) is available only on the card in
the port and only on a TPU or in interpret mode in JAX; on the CPU both
services refuse it at ``submit``. On the card the port's service runs its
groups, singletons included, as stacked buckets (``chip_smoke.py`` phase 10
(c)); here a stand-in batch-native backend on the CPU shows the routing.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import plan as jplan
from repro.serving import ProjectionService as JService
from repro_torch.core import ball as tball
from repro_torch.core import multilevel as tmultilevel
from repro_torch.core import plan as tplan
from repro_torch.serving import ProjectionEngine, ProjectionService

BILEVEL = [("inf", 1), ("1", 1)]
L1 = [("1", 1)]


def _services(method="sort"):
    jplan.clear_cache()
    tplan.clear_cache()
    return JService(method=method), ProjectionService(method=method,
                                                      device="cpu")


def _close(got, want, y):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=1e-6 * float(np.abs(np.asarray(y)).max()))


def _submit(svcs, y, levels, radius, **kw):
    j, t = svcs
    return (j.submit(jnp.asarray(y), levels, radius, **kw),
            t.submit(torch.from_numpy(y), levels, radius, **kw))


def _result(svcs, tickets):
    return svcs[0].result(tickets[0]), svcs[1].result(tickets[1])


def _flush(svcs):
    for s in svcs:
        s.flush()


def test_heterogeneous_requests_grouped_by_plan_key():
    svcs = _services()
    rng = np.random.default_rng(0)
    mats = [rng.normal(size=(6, 10)).astype(np.float32) for _ in range(3)]
    vec = rng.normal(size=(40,)).astype(np.float32)
    radii = (0.5, 1.0, 2.0)
    tickets = [_submit(svcs, m, BILEVEL, r) for m, r in zip(mats, radii)]
    tv = _submit(svcs, vec, L1, 1.0)
    assert svcs[1].pending() == svcs[0].pending() == 4
    _flush(svcs)
    # 3 same-key matrices batched into ONE dispatch + 1 singleton
    assert svcs[1].stats == svcs[0].stats
    assert svcs[1].stats["executed_batches"] == 2
    assert svcs[1].stats["batched_requests"] == 3
    assert svcs[1].pending() == 0
    for t, m, r in zip(tickets, mats, radii):
        want, got = _result(svcs, t)
        _close(got, want, m)
        _close(got, tmultilevel.multilevel_project(torch.from_numpy(m),
                                                   BILEVEL, r, method="sort"), m)
    want, got = _result(svcs, tv)
    _close(got, want, vec)
    _close(got, tball.project_l1(torch.from_numpy(vec), 1.0), vec)


def test_results_keyed_by_ticket_not_order():
    svcs = _services()
    a = np.random.default_rng(1).normal(size=(8,)).astype(np.float32)
    b = np.random.default_rng(2).normal(size=(8,)).astype(np.float32)
    ta = _submit(svcs, a, L1, 1.0)
    tb = _submit(svcs, b, L1, 1.0)
    _flush(svcs)
    want, got = _result(svcs, tb)
    _close(got, want, b)
    want, got = _result(svcs, ta)
    _close(got, want, a)


def test_project_convenience_and_auto():
    svcs = _services(method="auto")
    y = np.random.default_rng(3).normal(size=(5, 9)).astype(np.float32)
    want = svcs[0].project(jnp.asarray(y), BILEVEL, 1.5)
    got = svcs[1].project(torch.from_numpy(y), BILEVEL, 1.5)
    _close(got, want, y)


def test_unflushed_ticket_raises():
    svcs = _services()
    tickets = _submit(svcs, np.ones((4,), np.float32), L1, 1.0)
    for svc, t in zip(svcs, tickets):
        with pytest.raises(KeyError):
            svc.result(t)  # submitted but never flushed


def test_bad_request_rejected_at_submit_not_flush():
    svcs = _services()
    good = np.random.default_rng(4).normal(size=(4,)).astype(np.float32)
    t = _submit(svcs, good, L1, 1.0)
    for svc, arr in zip(svcs, (jnp.asarray, torch.from_numpy)):
        with pytest.raises(ValueError):  # 2 levels cover 2 axes, tensor has 3
            svc.submit(arr(np.ones((4, 6, 2), np.float32)), BILEVEL, 1.0)
        with pytest.raises(ValueError):  # unknown backend name
            svc.submit(arr(good), L1, 1.0, method="nope")
        with pytest.raises(ValueError):  # non-scalar radius
            svc.submit(arr(good), L1, arr(np.ones((3,), np.float32)))
        assert svc.pending() == 1
    _flush(svcs)
    assert svcs[1].pending() == 0
    want, got = _result(svcs, t)
    _close(got, want, good)


def test_group_sizes_bucket_to_one_batch_shape(monkeypatch):
    """Group sizes 3 and 4 share the power-of-two bucket: both reach the
    batch plan as a stack of 4 (JAX: one trace of its batch executable)."""
    svcs = _services()
    seen = []
    call = tplan.ProjectionPlan.__call__

    def spy(self, y, radius=1.0, out=None):
        if self.key.radius_kind == "batch":
            seen.append((tuple(y.shape), tuple(torch.as_tensor(radius).shape)))
        return call(self, y, radius, out)

    monkeypatch.setattr(tplan.ProjectionPlan, "__call__", spy)
    rng = np.random.default_rng(6)
    for size in (3, 4):
        tickets = [_submit(svcs, rng.normal(size=(16,)).astype(np.float32),
                           L1, 1.0) for _ in range(size)]
        _flush(svcs)
        for t in tickets:
            want, got = _result(svcs, t)
            _close(got, want, want)
    assert seen == [((4, 16), (4,)), ((4, 16), (4,))]
    p = jplan.make_plan((16,), jnp.float32, L1, radius_kind="batch",
                        method="sort")
    assert p.trace_count == 1
    assert svcs[1].stats == svcs[0].stats


def test_method_aliases_share_a_batch():
    # michelot is an alias of filter: both requests fold to one group
    svcs = _services(method="filter")
    rng = np.random.default_rng(5)
    a = rng.normal(size=(3, 7)).astype(np.float32)
    b = rng.normal(size=(3, 7)).astype(np.float32)
    ta = _submit(svcs, a, BILEVEL, 1.0)
    tb = _submit(svcs, b, BILEVEL, 1.0, method="michelot")
    _flush(svcs)
    assert svcs[1].stats == svcs[0].stats
    assert svcs[1].stats["executed_batches"] == 1
    assert svcs[1].stats["batched_requests"] == 2
    for t, y in ((ta, a), (tb, b)):
        want, got = _result(svcs, t)
        _close(got, want, y)


def test_discard_and_single_read():
    svcs = _services()
    y = np.random.default_rng(8).normal(size=(8,)).astype(np.float32)
    tickets = _submit(svcs, y, L1, 1.0)
    _flush(svcs)
    for svc, t in zip(svcs, tickets):
        svc.discard(t)
        svc.discard(t)                     # no-op once absent
        with pytest.raises(KeyError):
            svc.result(t)
    tickets = _submit(svcs, y, L1, 1.0)
    _flush(svcs)
    _result(svcs, tickets)
    for svc, t in zip(svcs, tickets):
        with pytest.raises(KeyError):      # single read
            svc.result(t)


def test_failed_group_stays_queued_and_retryable(monkeypatch):
    """A group whose plan raises is re-queued with its tickets; a later
    flush serves them."""
    svc = _services()[1]
    y = np.random.default_rng(9).normal(size=(6, 10)).astype(np.float32)
    tickets = [svc.submit(torch.from_numpy(y), BILEVEL, r) for r in (0.5, 1.0)]
    real = tplan.make_plan

    def broken(*a, **k):
        raise RuntimeError("plan build failed")

    monkeypatch.setattr(tplan, "make_plan", broken)
    with pytest.raises(RuntimeError, match="plan build failed"):
        svc.flush()
    assert svc.pending() == 2 and svc.stats["executed_batches"] == 0
    monkeypatch.setattr(tplan, "make_plan", real)
    svc.flush()
    for t, r in zip(tickets, (0.5, 1.0)):
        _close(svc.result(t), tmultilevel.multilevel_project(
            torch.from_numpy(y), BILEVEL, r, method="sort"), y)


def test_batch_native_backend_refused_on_cpu_by_both():
    """``codegen_batch`` is unavailable to both services on the CPU: both
    refuse it at submit, nothing is queued."""
    svcs = _services()
    y = np.random.default_rng(10).normal(size=(6, 10)).astype(np.float32)
    for svc, arr in zip(svcs, (jnp.asarray, torch.from_numpy)):
        with pytest.raises(ValueError, match="codegen_batch"):
            svc.submit(arr(y), BILEVEL, 0.7, method="codegen_batch")
        assert svc.pending() == 0


@pytest.fixture()
def stand_in_batch_native():
    """A batch-native backend on the CPU for one test: the plain schedule
    per item behind the stacked-bucket interface, counting its calls."""
    calls = []

    def build(key):
        def fn(ys, radii, out=None):
            calls.append(tuple(ys.shape))
            x = torch.stack([tmultilevel.multilevel_project(
                y, list(key.levels), r, method="sort")
                for y, r in zip(ys, radii)])
            return x if out is None else out.copy_(x)
        return fn

    tplan.register_plan_backend(tplan.PlanBackend(
        name="stand_in_batch", available=lambda key: key.device == "cpu",
        build=build, batch_native=True))
    tplan.clear_cache()
    try:
        yield calls
    finally:
        tplan._SPECIALIZED.pop("stand_in_batch", None)
        tplan.clear_cache()


def test_batch_native_singleton_runs_the_batch_plan(stand_in_batch_native):
    svc = ProjectionService(method="stand_in_batch", device="cpu")
    y = np.random.default_rng(11).normal(size=(6, 10)).astype(np.float32)
    got = svc.project(torch.from_numpy(y), BILEVEL, 0.7)
    assert stand_in_batch_native == [(1, 6, 10)]      # a bucket of one
    assert svc.stats["executed_batches"] == 1
    assert svc.stats["batched_requests"] == 0
    jsvc = JService(method="sort")
    _close(got, jsvc.project(jnp.asarray(y), BILEVEL, 0.7), y)
    # a group of three: one call with the bucket of four
    ts = [svc.submit(torch.from_numpy(y * s), BILEVEL, 0.7) for s in (1, 2, 3)]
    svc.flush()
    assert stand_in_batch_native[-1] == (4, 6, 10)
    for t, s in zip(ts, (1, 2, 3)):
        _close(svc.result(t), jsvc.project(jnp.asarray(y * s), BILEVEL, 0.7),
               y * s)


def test_batch_native_is_known_before_any_plan():
    """A fresh process's first ``submit`` sees the kernel backends: the
    service asks ``is_batch_native`` before any plan is built."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    src = Path(__file__).resolve().parent.parent / "src"
    code = ("from repro_torch.core import plan\n"
            "print(plan.is_batch_native('codegen_batch'), "
            "plan.is_batch_native('codegen'))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(src)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True", "False"]


def test_service_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        ProjectionService()


# ------------------------------------------------------ the engine's stats
def test_engine_stats_dict_and_callable():
    """``eng.stats`` is the counters dict and ``eng.stats()`` the snapshot
    (JAX's ``EngineStats``; ``tests/test_serving.py:381-389``)."""
    tplan.clear_cache()
    eng = ProjectionEngine(device="cpu", method="sort", start=False)
    eng.result(eng.submit(torch.ones(8), L1))
    assert eng.stats["dispatches"] == 1
    assert eng.stats["submitted"] == 1
    assert isinstance(eng.stats, dict)
    snap = eng.stats()
    assert snap["dispatches"] == 1 and snap["queued"] == 0
    assert snap == eng.stats_snapshot()
    eng.stop()
