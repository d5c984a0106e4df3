"""The lead-split apply of the generated pipeline (``csrc/codegen_apply.cu``:
``split_apply_kernel``, geometry ``kernels/codegen/tiling.py:lead_split``),
modelled on the CPU.

The kernel runs where every lead level of a design's apply is ℓ∞ or ℓ2 and
level L-1 is not ℓ1 (``lowering.split_lead``). Its geometry: grid
``(ctas_x, batch, splits)``; thread ``t`` of CTA ``(x, b, z)`` owns position
``p = x · SPLIT_THREADS + t < n · (m / vec)`` — row ``p // (m / vec)`` and
the ``vec`` columns from ``(p % (m / vec)) · vec`` — of item ``b``, in lead
slices ``[z · chunk, min(g1 · g2, (z + 1) · chunk))``. The tests hold that
this covers every element of (B, g1[, g2], n, m) exactly once, for every
design the tiler accepts and at the tri-level request's full width, that the
tri-level request reaches ``TARGET_CTAS``, and that the kernel's arithmetic
(w(i, j) shrunk once from the last lead aggregate, a LEAD-2 slice's radius
shrunk from v1, the ℓ2 rescale by the saved aggregate), replayed slice by
slice in PyTorch ops, equals ``apply_plain`` exactly, NaN and ±inf included.
The kernel itself is held against ``apply_plain`` on the card by
``chip_smoke.py``.
"""

import contextlib
import math

import numpy as np
import pytest
import torch

from repro_torch.core import schedule as tschedule
from repro_torch.kernels.codegen import lowering as tlowering
from repro_torch.kernels.codegen import tiling as ttiling
from test_codegen import DESIGNS, EXTRA_DESIGNS

TRILEVEL = [("inf", 1), ("inf", 1), ("1", 1)]
FULL_TRI = (256, 32, 2048)   # the server's tri-level request (chip_smoke.py FULL)

# beyond the JAX designs: the lead-split kernel's LEAD-2 instantiation (no
# ℓ1 lead level at depth 4) and ragged m (vec 1)
SPLIT_DESIGNS = [
    ("rank4_linf", (3, 4, 5, 32), [("inf", 1), ("2", 1), ("inf", 1), ("1", 1)]),
    ("rank4_l2lead", (2, 3, 7, 33), [("2", 1), ("inf", 1), ("2", 1), ("1", 1)]),
    ("trilevel_ragged", (4, 16, 61), TRILEVEL),
    ("trilevel_l2", (5, 9, 44), [("2", 1), ("inf", 1), ("1", 1)]),
]
ALL_DESIGNS = DESIGNS + EXTRA_DESIGNS + SPLIT_DESIGNS


def _plan(shape, levels):
    sched = tschedule.compile_schedule(shape, levels)
    tp = ttiling.plan_tiles(sched, torch.float32)
    return tp, [q for q, _ in sched.levels]


def _lead(tp):
    lead = tuple(tp.lead) + (1,) * (2 - len(tp.lead))
    return lead[0], lead[1]


def _positions(n, m, ls):
    """(rows, cols) of every (thread, column) of one CTA column x row, in
    launch order, as the kernel indexes them."""
    mv = m // ls.vec
    p = torch.arange(ls.ctas_x * ttiling.SPLIT_THREADS)
    p = p[p < n * mv]
    rows = (p // mv).repeat_interleave(ls.vec)
    cols = ((p % mv) * ls.vec)[:, None] + torch.arange(ls.vec)
    return rows, cols.reshape(-1)


def _chunks(slices, ls):
    return [torch.arange(z * ls.chunk, min(slices, (z + 1) * ls.chunk))
            for z in range(ls.splits)]


@contextlib.contextmanager
def one_thread():
    """Index arithmetic on one thread: beside the test runner's other
    workers, torch's thread pool only contends for the cores (the reduce's
    cover of the tri-level cases took 16–22 s at 8 threads in 6 processes
    at once on 8 cores, 0.25 s at one)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _count_cover(batch, slices, n, m, ls):
    """How many times the launch touches each element of (B, slices, n, m)."""
    with one_thread():
        return _count_cover_counts(batch, slices, n, m, ls)


def _count_cover_counts(batch, slices, n, m, ls):
    rows, cols = _positions(n, m, ls)
    pos = rows * m + cols
    assert torch.unique(pos).numel() == pos.numel()   # one thread per element
    counts = torch.zeros(batch * slices * n * m, dtype=torch.uint8)
    for b in range(batch):
        for s in _chunks(slices, ls):
            idx = ((b * slices + s)[:, None] * (n * m) + pos[None, :]).reshape(-1)
            counts[idx] += 1
    return counts


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("name,shape,levels", ALL_DESIGNS)
def test_every_element_is_covered_once(name, shape, levels, batch):
    tp, norms = _plan(shape, levels)
    if tp is None:
        pytest.fail(f"{name}: the tiler rejects {levels} on {shape}")
    if len(norms) == 1:
        return  # the flat solve: no apply pass
    g1, g2 = _lead(tp)
    n, m = tp.n, tp.m
    if not tlowering.split_lead(tp, norms[:-1]):
        # the row split of apply_kernel: chunks of rows cover n once
        rows, splits = (n, 1) if tp.n_resident else ttiling.row_split(n, m, batch)
        assert (splits - 1) * rows < n <= splits * rows
        return
    for vec in (1, 4) if m % 4 == 0 else (1,):
        ls = ttiling.lead_split(n, m, g1 * g2, batch, vec)
        counts = _count_cover(batch, g1 * g2, n, m, ls)
        assert int(counts.min()) == 1 and int(counts.max()) == 1, (name, vec)


@pytest.mark.parametrize("batch", [1, 8])
def test_full_tri_request_is_covered_once_and_fills_the_card(batch):
    tp, norms = _plan(FULL_TRI, TRILEVEL)
    assert tlowering.split_lead(tp, norms[:-1])
    g1, g2 = _lead(tp)
    assert (g1, g2, tp.n, tp.m) == (256, 1, 32, 2048)
    ls = ttiling.lead_split(tp.n, tp.m, g1 * g2, batch, 4)
    assert ls.ctas_x * batch * ls.splits >= ttiling.TARGET_CTAS
    # the row split the kernel replaced gave 256 CTAs to the single request
    rows, splits = ttiling.row_split(tp.n, tp.m, 1)
    assert math.ceil(tp.m / ttiling.BLOCK_M) * splits == 256
    counts = _count_cover(batch, g1 * g2, tp.n, tp.m, ls)
    assert int(counts.min()) == 1 and int(counts.max()) == 1


@pytest.mark.parametrize("n,m,slices,batch", [(32, 2048, 256, 1), (32, 2048, 256, 8),
                                              (5, 33, 12, 1), (1, 4, 1, 1),
                                              (2048, 64, 40, 1)])
def test_lead_split_chunks_partition_the_slices(n, m, slices, batch):
    for vec in (1, 4) if m % 4 == 0 else (1,):
        ls = ttiling.lead_split(n, m, slices, batch, vec)
        got = torch.cat(_chunks(slices, ls))
        assert torch.equal(got, torch.arange(slices))
        assert all(c.numel() > 0 for c in _chunks(slices, ls))
        want = math.ceil(ttiling.TARGET_CTAS / (ls.ctas_x * batch))
        assert ls.splits >= min(want, slices)


def test_lead_split_rejects_a_vec_that_does_not_divide_m():
    with pytest.raises(ValueError, match="does not divide"):
        ttiling.lead_split(4, 33, 3, 1, 4)


def _shrink(q, x, w, agg):
    """One element's shrink as ``csrc/codegen_apply.cu:shrink`` does it, in
    the plain version's ops."""
    if q == "inf":
        return torch.minimum(torch.maximum(x, -w), w)
    return x * torch.where(agg > w, w / torch.clamp(agg, min=1e-30),
                           torch.ones_like(agg))


def model_split_apply(yc, aggs, vfin, u, norms, ls):
    """X as split_apply_kernel writes it: per CTA column z and item b, the
    chunk's slices one at a time, each element from w(i, j) of its
    position."""
    batch, n, m = yc.shape[0], yc.shape[-2], yc.shape[-1]
    lead = len(aggs)
    g1 = yc.shape[1]
    g2 = yc.shape[2] if lead == 2 else 1
    ys = yc.reshape(batch, g1 * g2, n * m)
    rows, cols = _positions(n, m, ls)
    pos = rows * m + cols
    out = torch.full_like(ys, float("nan"))
    qlast, q1 = norms[-1], norms[0]
    xa = aggs[-1].reshape(batch, n * m)[:, pos]
    for b in range(batch):
        w = _shrink(qlast, xa[b], u[b, cols], vfin[b, cols])
        for chunk in _chunks(g1 * g2, ls):
            for s in chunk.tolist():
                x = ys[b, s, pos]
                if lead == 1:
                    r = _shrink(q1, x, w, xa[b])
                else:
                    x1 = aggs[0].reshape(batch, g2, n * m)[b, s % g2, pos]
                    r = _shrink(q1, x, _shrink(norms[1], x1, w, xa[b]), x1)
                out[b, s, pos] = r
    return out.reshape(yc.shape)


@pytest.mark.parametrize("name,shape,levels",
                         [d for d in ALL_DESIGNS if d[0] in (
                             "l1infinf_last", "rank4_l2pair", "rank4_linf",
                             "rank4_l2lead", "trilevel_ragged", "trilevel_l2")])
def test_split_arithmetic_equals_apply_plain(name, shape, levels):
    tp, norms = _plan(shape, levels)
    red = norms[:-1]
    assert tlowering.split_lead(tp, red)
    rng = np.random.default_rng(len(name))
    batch = 2
    yc = torch.from_numpy((rng.normal(size=(batch,) + tp.canon_shape) * 2)
                          .astype(np.float32))
    yc[0].view(-1)[[3, 17, 40]] = torch.tensor([float("nan"), float("inf"),
                                                -float("inf")])
    aggs, vfin = tlowering.reduce_plain(yc, red)
    outer = vfin.sum(1) if norms[-1] == "1" else vfin.amax(1)
    radii = torch.from_numpy(rng.uniform(0.05, 0.9, size=batch)
                             .astype(np.float32)) * outer
    u = tlowering._solve_outer_batched(vfin, norms[-1], radii, "bisect")
    want = tlowering.apply_plain(yc, aggs, vfin, u, red)
    g1, g2 = _lead(tp)
    for vec in (1, 4) if tp.m % 4 == 0 else (1,):
        ls = ttiling.lead_split(tp.n, tp.m, g1 * g2, batch, vec)
        got = model_split_apply(yc, aggs, vfin, u, red, ls)
        assert torch.equal(got.isnan(), want.isnan())
        fin = ~want.isnan()
        assert torch.equal(got[fin], want[fin]), (name, vec)


@pytest.mark.parametrize("levels,shape,split", [
    (TRILEVEL, FULL_TRI, True),
    ([("inf", 1), ("1", 1)], (8192, 2048), False),
    ([("1", 1), ("1", 1), ("1", 1)], (3, 10, 20), False),
    (TRILEVEL, (4, 16, 61), True),
])
def test_wrapper_hands_the_kernel_its_split(monkeypatch, levels, shape, split):
    """``codegen_apply`` on a tensor that reaches the launch: the lead-split
    designs pass ``lead_split``'s chunk, splits and vec (4 for aligned
    pointers and m % 4 == 0), the others a row split and chunk 0."""
    from test_torch_no_fallback import _reach_the_launch, _stand_in

    _reach_the_launch(monkeypatch)
    _, calls = _stand_in(monkeypatch, tlowering.APPLY, 0)
    tp, norms = _plan(shape, levels)
    red = norms[:-1]
    batch = 2
    yc = torch.empty((batch,) + tp.canon_shape, device="meta")
    aggs = [torch.empty((batch,) + tuple(tp.lead[t:]) + (tp.n, tp.m), device="meta")
            for t in range(1, len(tp.lead) + 1)]
    row = torch.empty(batch, tp.m, device="meta")
    tlowering.codegen_apply(yc, aggs, row, row, tp, red)
    args = calls[-1]
    rows, splits, chunk, vec = args[-5:-1]
    assert tlowering.split_lead(tp, red) == split
    if split:
        g1, g2 = _lead(tp)
        ls = ttiling.lead_split(tp.n, tp.m, g1 * g2, batch, 4 if tp.m % 4 == 0 else 1)
        assert (splits, chunk, vec) == (ls.splits, ls.chunk, ls.vec) and chunk > 0
    else:
        assert chunk == 0 and vec == 0 and rows > 0
    assert tlowering.APPLY.launches == 1
