"""The port's ``ProjectionEngine`` on the CPU against the JAX package.

The requests are the SAE factory's projections at a small size: the
transposed dictionary-SAE encoder (bi-level ℓ1,∞) and the transposed
head-structured encoder (tri-level ℓ1,∞,∞). The encoders are made with
numpy in the JAX package's parameter layout, moved to the port with
``interop.from_numpy_tree``, and the same weights go to both packages.
Answers must equal JAX ``multilevel_project(..., method="bisect")`` within
atol = 1e-5 * max|y|, rtol = 1e-5 (64-step float32 bisection and another
summation order move θ by a few ulps).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import multilevel as jmultilevel
from repro.models import sae as jsae
from repro_torch import interop
from repro_torch.core import multilevel as tmultilevel
from repro_torch.serving.engine import (DeadlineExceededError,
                                        ProjectionEngine, QueueFullError,
                                        ServingError, UnknownTicketError)

BILEVEL = [("inf", 1), ("1", 1)]
TRILEVEL = [("inf", 1), ("inf", 1), ("1", 1)]
D_IN, D_DICT, HEADS = 16, 64, 4


def _encoders(seed=0):
    """numpy parameter trees of the two dictionary SAEs (flat and
    head-structured), shaped by the JAX package's own templates."""
    rng = np.random.default_rng(seed)
    trees = []
    for heads in (1, HEADS):
        tmpl = jsae.dict_template(D_IN, D_DICT, heads=heads)
        trees.append({part: {name: rng.normal(size=pdef.shape).astype(np.float32)
                             for name, pdef in leaves.items()}
                      for part, leaves in tmpl.items()})
    return trees


def _close(got, want, y):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * float(np.abs(y).max()))


def _invariant(snap):
    assert (snap["completed"] + snap["failed"] + snap["discarded"]
            + snap["queued"] + snap["inflight"]) == snap["submitted"]


def test_interop_keeps_layouts_and_values():
    flat, heads = _encoders()
    for tree in (flat, heads):
        t = interop.from_numpy_tree(tree, device="cpu")
        for part in tree:
            for name, arr in tree[part].items():
                assert tuple(t[part][name].shape) == arr.shape
                assert t[part][name].dtype == torch.float32
                np.testing.assert_array_equal(t[part][name].numpy(), arr)
    nested = interop.params_from_jax({"a": [np.ones(2), (np.zeros(3),)]},
                                     device="cpu")
    assert isinstance(nested["a"], list) and isinstance(nested["a"][1], tuple)


@pytest.mark.parametrize("start", [False, True])
def test_engine_answers_mixed_sae_requests_like_jax(start):
    flat, heads = _encoders()
    tflat = interop.from_numpy_tree(flat, device="cpu")
    theads = interop.from_numpy_tree(heads, device="cpu")
    # the projection hook's transposed views: (d_dict, d_in) and
    # (d_dict / heads, heads, d_in)
    bi = [tflat["enc"]["w"].T.contiguous() * s for s in (1.0, 0.5, 2.0)]
    tri = [theads["enc"]["w"].permute(2, 1, 0).contiguous() * s
           for s in (1.0, 3.0)]
    reqs = [(y, BILEVEL, r) for y, r in zip(bi, (0.5, 4.0, 1e6))]
    reqs += [(y, TRILEVEL, r) for y, r in zip(tri, (2.0, 0.0))]
    eng = ProjectionEngine(device="cpu", method="bisect", max_batch=4,
                           start=start)
    try:
        tickets = [eng.submit(y, lv, r) for y, lv, r in reqs]
        outs = [eng.result(t, timeout=60) for t in tickets]
    finally:
        eng.stop()
    for (y, lv, r), x in zip(reqs, outs):
        yn = y.numpy()
        want = jmultilevel.multilevel_project(jnp.asarray(yn), lv, r,
                                              method="bisect")
        _close(x, want, yn)
        assert float(tmultilevel.multilevel_norm(x, lv)) <= \
            r * (1 + 1e-5) + 1e-5 * float(np.abs(yn).max())
    snap = eng.stats_snapshot()
    _invariant(snap)
    assert snap["completed"] == len(reqs) and snap["failures"] == 0
    if not start:  # deterministic grouping: one bucket per key
        assert snap["dispatches"] == 2 and snap["max_group"] == 3
        assert snap["batched_requests"] == 5
    assert snap["latency"] and snap["plan_cache"]["plans"] >= 2


def test_engine_singleton_and_padded_bucket_agree():
    y = torch.from_numpy(np.random.default_rng(1).normal(
        size=(12, 20)).astype(np.float32))
    eng = ProjectionEngine(device="cpu", method="filter", start=False)
    one = eng.project(y, BILEVEL, 3.0)                  # scalar plan
    ts = [eng.submit(y, BILEVEL, 3.0) for _ in range(3)]  # bucket of 4
    outs = [eng.result(t) for t in ts]
    eng.stop()
    for x in outs:
        torch.testing.assert_close(x, one, rtol=1e-5, atol=1e-5)
    # the engine never writes into the caller's tensor
    assert not torch.equal(one, y)


def test_queue_full_then_drain_completes():
    y = torch.ones(6, 8)
    eng = ProjectionEngine(device="cpu", method="sort", max_pending=2,
                           start=False)
    t1 = eng.submit(y, BILEVEL, 1.0)
    t2 = eng.submit(y, BILEVEL, 2.0)
    with pytest.raises(QueueFullError):
        eng.submit(y, BILEVEL, 3.0)
    snap = eng.stats_snapshot()
    assert snap["rejected"] == 1 and snap["submitted"] == 2
    _invariant(snap)
    eng.drain()
    assert eng.result(t1).shape == (6, 8) and eng.result(t2).shape == (6, 8)
    t3 = eng.submit(y, BILEVEL, 3.0)    # room again after the drain
    assert eng.poll(t3) is False
    eng.stop()
    assert eng.poll(t3) is True
    _invariant(eng.stats_snapshot())


def test_deadline_expires_without_compute_and_accounting_holds():
    y = torch.ones(6, 8)
    eng = ProjectionEngine(device="cpu", method="sort", start=False)
    late = eng.submit(y, BILEVEL, 1.0, deadline=-1.0)
    ok = eng.submit(y, TRILEVEL[:1] + [("1", 1)], 1.0, deadline=60.0)
    eng.drain()
    with pytest.raises(DeadlineExceededError):
        eng.result(late)
    assert eng.result(ok).shape == (6, 8)
    snap = eng.stats_snapshot()
    assert snap["expired"] == 1 and snap["failed"] == 1
    _invariant(snap)
    eng.stop()


def test_ticket_lifecycle_errors():
    y = torch.ones(4, 5)
    eng = ProjectionEngine(device="cpu", method="sort", start=False)
    other = ProjectionEngine(device="cpu", method="sort", start=False)
    t = eng.submit(y, BILEVEL, 1.0)
    d = eng.submit(y, BILEVEL, 2.0)
    eng.discard(d)
    with pytest.raises(UnknownTicketError):
        other.result(t)
    eng.result(t)
    with pytest.raises(UnknownTicketError):
        eng.result(t)                    # single read
    with pytest.raises(UnknownTicketError):
        eng.result(d)                    # discarded
    with pytest.raises(ValueError):
        eng.submit(y, [("inf", 1)], 1.0)          # design does not cover y
    with pytest.raises(ValueError):
        eng.submit(y, BILEVEL, [1.0, 2.0])        # one radius per request
    with pytest.raises(ValueError):
        eng.submit(y, BILEVEL, 1.0, method="codegen_batch")  # CUDA-only backend
    snap = eng.stats_snapshot()
    assert snap["discarded"] == 1
    _invariant(snap)
    eng.stop()
    other.stop()
    with pytest.raises(ServingError):
        eng.submit(y, BILEVEL, 1.0)


def test_concurrent_submitters_keep_accounting_exact():
    """16 threads (more than the cores) submit through one threaded engine
    with a short interpreter switch interval: every answer is right and the
    accounting invariant holds exactly."""
    import sys
    from concurrent.futures import ThreadPoolExecutor

    eng = ProjectionEngine(device="cpu", method="sort", max_batch=8)

    def worker(k):
        rng = np.random.default_rng(k)
        reqs = []
        for i in range(8):
            y = torch.from_numpy(rng.normal(size=(5, 7)).astype(np.float32))
            reqs.append((eng.submit(y, BILEVEL, 0.5 + i), y, 0.5 + i))
        return [(eng.result(t, timeout=60), y, r) for t, y, r in reqs]

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ThreadPoolExecutor(16) as pool:
            results = [f.result(timeout=120)
                       for f in [pool.submit(worker, k) for k in range(16)]]
    finally:
        sys.setswitchinterval(old)
        eng.stop()
    for batch in results:
        for x, y, r in batch:
            want = tmultilevel.multilevel_project(y, BILEVEL, r, method="sort")
            torch.testing.assert_close(x, want, rtol=1e-5, atol=1e-5)
    snap = eng.stats_snapshot()
    _invariant(snap)
    assert snap["completed"] == 16 * 8 and snap["failed"] == 0
