"""The reduce of the generated pipeline (``csrc/codegen_reduce.cu``, geometry
``kernels/codegen/tiling.py:reduce_split``), modelled on the CPU.

Grid ``(ctas_x, splits, batch)`` of ``REDUCE_THREADS`` threads; thread ``t``
of CTA ``(x, z, b)`` owns pack ``x · packs + t % packs`` (``vec`` adjacent
columns), slice lane ``s = (t // packs) % lanes`` and row lane ``r = t //
(packs · lanes)`` of ``R``; it walks rows ``z · rows + r, +R, …`` of its
chunk and, under one lead axis, slices ``s, s + lanes, …`` of each row (the
other lead ranks fold every lead element of the row in the thread). The
tests hold that this covers every element of (B, g1[, g2], n, m) exactly
once, for every design the tiler accepts and at the four full-width shapes
the server sends (a bi-level (8192, 2048) and a tri-level (256, 32, 2048)
request, one item or a bucket of 8), that those shapes take one launch of
one wave of CTAs (one per SM), and that the kernel's fold order — thread
serial, the slice lanes' and then the row lanes' warp butterflies, the warps
in order, the row chunks in order — replayed in PyTorch ops equals
``reduce_plain`` within the tolerance of ``tests/test_torch_codegen.py``,
with the raw accumulator too. The kernel itself is held against
``reduce_plain`` on the card by ``chip_smoke.py``.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.core import schedule as tschedule
from repro_torch.kernels.codegen import lowering as tlowering
from repro_torch.kernels.codegen import tiling as ttiling
from test_torch_apply_split import ALL_DESIGNS, one_thread

BILEVEL = [("inf", 1), ("1", 1)]
TRILEVEL = [("inf", 1), ("inf", 1), ("1", 1)]
# the server's two requests (chip_smoke.py FULL), one item and a bucket of 8
FULL = [((8192, 2048), BILEVEL, 1), ((8192, 2048), BILEVEL, 8),
        ((256, 32, 2048), TRILEVEL, 1), ((256, 32, 2048), TRILEVEL, 8)]
# the reduce's other geometries (chip_smoke.py DESIGNS): rows cut into
# chunks (few, long columns), slice lanes under one lead axis at vec 1 and 4
REDUCE_DESIGNS = [
    ("l1inf_tall", (4096, 32), BILEVEL),
    ("trilevel_tall", (3, 2000, 20), TRILEVEL),
    ("trilevel_deep", (64, 5, 61), TRILEVEL),
    ("trilevel_deep_l2", (48, 3, 64), [("2", 1), ("inf", 1), ("1", 1)]),
]
DESIGNS = ALL_DESIGNS + REDUCE_DESIGNS
WARP = 32


def _plan(shape, levels):
    sched = tschedule.compile_schedule(shape, levels)
    tp = ttiling.plan_tiles(sched, torch.float32)
    return tp, [q for q, _ in sched.levels]


def _vecs(m):
    return (1, 4) if m % 4 == 0 else (1,)


def _lanes(rs):
    """Per thread of a CTA: (pack in the CTA, slice lane, row lane), and R."""
    t = torch.arange(ttiling.REDUCE_THREADS)
    per_row = rs.packs * rs.lanes
    return t % rs.packs, (t // rs.packs) % rs.lanes, t // per_row, \
        ttiling.REDUCE_THREADS // per_row


def _cover(lead, n, m, rs):
    """How many times one item's launch touches each element of (g, n, m),
    g the product of the lead axes (slices in memory order)."""
    with one_thread():
        return _cover_counts(lead, n, m, rs)


def _cover_counts(lead, n, m, rs):
    g = math.prod(lead)
    p, s, r, R = _lanes(rs)
    kmax = math.ceil(rs.rows / R)
    touched = []
    if len(lead) == 1:
        k2 = torch.arange(math.ceil(g / rs.lanes))
        slices = s[:, None] + rs.lanes * k2[None, :]              # (T, K2)
    else:
        slices = torch.arange(g).expand(len(p), g)                # every slice
    e = torch.arange(rs.vec)
    for x in range(rs.ctas_x):
        col = (x * rs.packs + p)[:, None] * rs.vec + e[None, :]   # (T, vec)
        ok_col = (x * rs.packs + p) * rs.vec < m
        for z in range(rs.splits):
            hi = min(n, (z + 1) * rs.rows)
            rows = z * rs.rows + r[:, None] + R * torch.arange(kmax)[None, :]
            ok = (ok_col[:, None, None, None] & (rows < hi)[:, :, None, None]
                  & (slices < g)[:, None, :, None])
            idx = (slices[:, None, :, None] * n + rows[:, :, None, None]) * m \
                + col[:, None, None, :]
            idx, ok = torch.broadcast_tensors(idx, ok)
            touched.append(idx[ok])
    # one count over every CTA's elements (a bincount per CTA would sweep the
    # whole item each time)
    return torch.bincount(torch.cat(touched), minlength=g * n * m)


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("name,shape,levels", DESIGNS)
def test_every_element_is_covered_once(name, shape, levels, batch):
    tp, norms = _plan(shape, levels)
    if tp is None:
        pytest.fail(f"{name}: the tiler rejects {levels} on {shape}")
    if len(norms) == 1:
        return  # the flat solve: no reduce pass
    for vec in _vecs(tp.m):
        rs = ttiling.reduce_split(tp.lead, tp.n, tp.m, batch, vec)
        counts = _cover(tp.lead, tp.n, tp.m, rs)
        assert int(counts.min()) == 1 and int(counts.max()) == 1, (name, vec)
        # the rows cut into chunks: each row in one chunk
        assert (rs.splits - 1) * rs.rows < tp.n <= rs.splits * rs.rows


@pytest.mark.parametrize("shape,levels,batch", FULL)
def test_full_requests_take_one_launch_of_one_wave(shape, levels, batch):
    """Every element once (one item's columns; grid z is the item), one CTA
    per SM at most and at least 0.9 of that, whole column strips (one
    chunk, so vfin comes out of the one launch), 16-byte loads of at least
    REDUCE_SEGMENT bytes of each row per warp load."""
    tp, _ = _plan(shape, levels)
    rs = ttiling.reduce_split(tp.lead, tp.n, tp.m, batch, 4)
    ctas = rs.ctas_x * rs.splits * batch
    assert 0.9 * ttiling.REDUCE_CTAS <= ctas <= ttiling.REDUCE_CTAS
    assert rs.splits == 1 and rs.vec == 4
    assert rs.packs * rs.vec * 4 >= ttiling.REDUCE_SEGMENT
    if tp.lead:  # ≥ REDUCE_LEAD_LOADS slices a lane, within one warp
        assert rs.packs * rs.lanes <= WARP
        assert tp.lead[0] // rs.lanes >= ttiling.REDUCE_LEAD_LOADS
    counts = _cover(tp.lead, tp.n, tp.m, rs)
    assert int(counts.min()) == 1 and int(counts.max()) == 1


@pytest.mark.parametrize("lead,n,m,batch", [
    ((), 8192, 2048, 1), ((256,), 32, 2048, 8), ((), 5, 7, 1), ((3, 4), 5, 32, 2),
    ((), 100000, 8, 1), ((64,), 1, 4, 1), ((2,), 3000, 13, 2)])
def test_reduce_split_shape_rules(lead, n, m, batch):
    for vec in _vecs(m):
        rs = ttiling.reduce_split(lead, n, m, batch, vec)
        count = m // vec
        assert rs.packs & (rs.packs - 1) == 0 and rs.packs <= ttiling.REDUCE_THREADS
        assert rs.ctas_x == math.ceil(count / rs.packs)
        assert rs.lanes == 1 or (len(lead) == 1 and rs.packs * rs.lanes <= WARP)
        assert 1 <= rs.splits and rs.ctas_x * batch * rs.splits <= max(
            ttiling.REDUCE_CTAS, rs.ctas_x * batch)
        if rs.splits > 1:  # only where the strips leave most SMs idle
            assert 2 * rs.ctas_x * batch < ttiling.REDUCE_CTAS


def test_reduce_split_rejects_a_vec_that_does_not_divide_m():
    with pytest.raises(ValueError, match="does not divide"):
        ttiling.reduce_split((), 4, 33, 1, 4)


# ------------------------------------------------------------ the fold order
def _combine(q, a, b):
    return torch.maximum(a, b) if q == "inf" else a + b


def _fold(q, acc, x):
    return torch.maximum(acc, x) if q == "inf" else acc + (x * x if q == "2" else x)


def _finalize(q, acc):
    return torch.sqrt(acc) if q == "2" else acc


def _butterfly(q, vals):
    """A xor butterfly over the lanes' values (a power-of-two count), as
    ``__shfl_xor_sync`` runs it; lane 0's result."""
    o = 1
    while o < len(vals):
        vals = [_combine(q, vals[x], vals[x ^ o]) for x in range(len(vals))]
        o *= 2
    return vals[0]


def _serial(q, xs):
    acc = torch.zeros_like(xs[0])
    for x in xs:
        acc = _fold(q, acc, x)
    return acc


def model_reduce(yc, norms, rs, raw=False):
    """``([v_1, …], vfin)`` in the kernel's fold order, per column."""
    a = yc.abs()
    lead, n = a.ndim - 3, a.shape[-2]
    qlast = norms[-1]
    aggs = []
    if lead == 0:
        cur = a                                            # (B, n, m)
    elif lead == 1:
        S = rs.lanes
        lanes = [_serial(norms[0], list(a[:, s::S].unbind(1)))
                 if s < a.shape[1] else torch.zeros_like(a[:, 0])
                 for s in range(S)]
        cur = _finalize(norms[0], _butterfly(norms[0], lanes))
        aggs = [cur]
    else:
        v1 = _finalize(norms[0], _serial(norms[0], list(a.unbind(1))))
        cur = _finalize(norms[1], _serial(norms[1], list(v1.unbind(1))))
        aggs = [v1, cur]
    if raw and qlast == "2":
        fold = lambda acc, x: acc + x * x                  # noqa: E731
    else:
        fold = lambda acc, x: _fold(qlast, acc, x)         # noqa: E731
    _, _, _, R = _lanes(rs)
    per_warp = max(1, WARP // (rs.packs * rs.lanes))       # row lanes a warp holds
    chunks = []
    for z in range(rs.splits):
        rows = range(z * rs.rows, min(n, (z + 1) * rs.rows))
        lane_acc = []
        for r in range(R):
            acc = torch.zeros_like(cur[:, 0])
            for i in rows[r::R]:
                acc = fold(acc, cur[:, i])
            lane_acc.append(acc)
        groups = [_butterfly(qlast, lane_acc[g:g + per_warp])
                  for g in range(0, R, per_warp)]
        part = groups[0]
        for grp in groups[1:]:
            part = _combine(qlast, part, grp)
        chunks.append(part)
    if rs.splits == 1:
        acc = chunks[0]
    else:  # reduce_finalize: 8 thread rows take every 8th chunk, then in order
        rows8 = []
        for ty in range(8):
            acc = torch.zeros_like(chunks[0])
            for c in chunks[ty::8]:
                acc = _combine(qlast, acc, c)
            rows8.append(acc)
        acc = rows8[0]
        for c in rows8[1:]:
            acc = _combine(qlast, acc, c)
    return aggs, acc if raw else _finalize(qlast, acc)


def _close(got, want):
    scale = float(want[want.isfinite()].abs().max())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * scale,
                               equal_nan=True)


@pytest.mark.parametrize("raw", [False, True])
@pytest.mark.parametrize("name,shape,levels", [
    d for d in DESIGNS if len(d[2]) > 1])
def test_fold_order_equals_reduce_plain(name, shape, levels, raw):
    tp, norms = _plan(shape, levels)
    red = norms[:-1]
    rng = np.random.default_rng(len(name) + 7 * raw)
    batch = 2
    yc = torch.from_numpy((rng.normal(size=(batch,) + tp.canon_shape) * 2)
                          .astype(np.float32))
    yc[0].view(-1)[[3, 17, yc[0].numel() - 2]] = torch.tensor(
        [float("nan"), float("inf"), -float("inf")])
    want_aggs, want = tlowering.reduce_plain(yc, red, raw)
    for vec in _vecs(tp.m):
        rs = ttiling.reduce_split(tp.lead, tp.n, tp.m, batch, vec)
        aggs, got = model_reduce(yc, red, rs, raw)
        assert len(aggs) == len(want_aggs)
        for a, w in zip(aggs, want_aggs):
            _close(a, w)
        _close(got, want)


@pytest.mark.parametrize("shape,levels,batch", [
    ((8192, 2048), BILEVEL, 1), ((256, 32, 2048), TRILEVEL, 8),
    ((4096, 32), BILEVEL, 3), ((64, 5, 61), TRILEVEL, 2),
    ((3, 4, 5, 32), [("inf", 1), ("2", 1), ("1", 1), ("1", 1)], 2)])
def test_wrapper_hands_the_kernel_its_split(monkeypatch, shape, levels, batch):
    """``codegen_reduce`` on a tensor that reaches the launch: one buffer
    whose views (aggregates, vfin, and the chunks' partial rows where the
    rows split) start 128-byte aligned, and ``reduce_split``'s geometry."""
    from test_torch_no_fallback import _reach_the_launch, _stand_in

    _reach_the_launch(monkeypatch)
    _, calls = _stand_in(monkeypatch, tlowering.REDUCE, 0)
    tp, norms = _plan(shape, levels)
    yc = torch.empty((batch,) + tp.canon_shape, device="meta")
    aggs, vfin = tlowering.codegen_reduce(yc, tp, norms[:-1])
    vec = 4 if tp.m % 4 == 0 else 1
    rs = ttiling.reduce_split(tp.lead, tp.n, tp.m, batch, vec)
    args = calls[-1]
    assert args[5:19] == (batch, len(tp.lead), *tlowering._lead_args(tp),
                          tp.n, tp.m, *tlowering._codes(norms[:-1]), rs.vec,
                          rs.packs, rs.lanes, rs.rows, rs.splits)
    assert args[19] == 0   # raw
    assert vfin.shape == (batch, tp.m) and vfin.is_contiguous()
    assert [a.shape for a in aggs] == [
        (batch,) + tuple(tp.lead[t:]) + (tp.n, tp.m)
        for t in range(1, len(tp.lead) + 1)]
    views, total, _ = tlowering._reduce_launch(tp, tuple(norms[:-1]), batch, vec)
    assert all(off % tlowering._ALIGN == 0 for off, _ in views)
    assert len(views) == len(tp.lead) + 1 + (rs.splits > 1)
    assert views[-1][0] + math.prod(views[-1][1]) <= total
    assert tlowering.REDUCE.launches == 1
