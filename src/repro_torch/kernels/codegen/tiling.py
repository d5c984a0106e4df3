"""Tile planning for the generated projection kernels on Hopper (port of
``repro/kernels/codegen/tiling.py``, re-derived for the card).

The kernels (``csrc/codegen_reduce.cu``, ``csrc/codegen_apply.cu``) index the
*canonical* view of a compiled schedule, ``(g_1, …, g_{L-1}, m)``: ``m`` is the
solve axis, ``n = g_{L-1}`` the row axis of the last reduce, and
``lead = (g_1, …, g_{L-2})`` the axes folded before it. A CTA covers
``BLOCK_M`` consecutive columns — one warp, so every row access is a
coalesced 128-byte line — with ``BLOCK_ROWS`` thread rows walking rows, and
each thread folds the lead axes of its (row, column) in registers. Lead axes
therefore cost no shared memory and no VMEM-style budget; what limits a
design here is:

* the lead rank: the kernels are instantiated for 0, 1 or 2 lead axes, so
  designs of depth L <= 4;
* an ℓ1 apply at level L-1, whose group is a whole column of n rows: one CTA
  keeps ``n × BLOCK_M`` floats of it in shared memory for the 64 bisection
  sweeps (the ``n_resident`` pin), so ``n <= SMEM_BUDGET_BYTES / (4·BLOCK_M)``;
* an ℓ1 outer solve: ``csrc/l1ball.cu`` keeps one item's m-vector in the
  shared memory of one CTA (``m <= L1_ONE_CTA_MAX``) or of a thread block
  cluster, so ``m <= L1_KERNEL_MAX`` = 524,288, JAX's single-block limit;
* the type: float32 only.

``plan_tiles`` returns ``None`` for every design outside those limits: the
``codegen`` planner backends are then unavailable for it. Designs the JAX
tiler accepts and this one rejects: depth > 4, non-float32 types, an ℓ1 apply
over more than 1600 rows, an ℓ1 solve over more than 524,288 values (see
ROADMAP.md).

Pallas walked the row axis sequentially; Hopper has no sequential grid axis.
The reduce (:func:`reduce_split`) gives each CTA whole column strips —
``packs`` packs of ``vec`` adjacent columns, one 16-byte load each — and all
their rows, about one CTA per SM, so one launch writes the finalized
aggregate; only where the strips alone leave most SMs idle does it cut the
rows too. The apply's row-walking kernels use
:func:`row_split`, which cuts the row axis across CTAs until the launch
fills the card.
Where every lead level of the apply is ℓ∞ or ℓ2 (and level L-1 is not ℓ1),
each element of a lead group shrinks alone once its radius is known, so
:func:`lead_split` cuts the lead slices instead: a thread owns ``vec``
adjacent columns of one row, a CTA ``SPLIT_THREADS`` such positions and a
chunk of the slices.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.schedule import Schedule

BLOCK_M = 32                     # columns per CTA: one warp of 4-byte loads
BLOCK_ROWS = 8                   # thread rows per CTA: 256 threads
SMEM_BUDGET_BYTES = 200 * 1024   # dynamic shared memory one CTA may claim
                                 # (Hopper allows 227 KB; slack for static)
L1_ONE_CTA_MAX = SMEM_BUDGET_BYTES // 4  # l1ball.cu: a float32 vector in one CTA
L1_KERNEL_MAX = 512 * 1024       # l1ball.cu's cluster path: JAX's L1_KERNEL_MAX
MAX_LEAD_RANK = 2                # kernels instantiated for 0, 1, 2 lead axes
SM_COUNT = 132                   # H100 SXM
TARGET_CTAS = 8 * SM_COUNT       # 8 CTAs of 256 threads fill an SM's 2048
SPLIT_THREADS = 256              # positions per CTA of the lead-split apply
SPLIT_CHUNK_MAX = 8              # lead slices per CTA: two batches of the
                                 # kernel's 4 loads in flight per thread (on
                                 # an H100, 1 µs less for the tri request
                                 # than 4; PERF.md § 6)
REDUCE_THREADS = 512             # threads per CTA of the reduce
REDUCE_CTAS = SM_COUNT           # reduce CTAs: one of 512 threads per SM
                                 # (on an H100, 0.2–4 µs less than two per
                                 # SM at the four main shapes; PERF.md § 6)
REDUCE_SEGMENT = 64              # bytes of each row a warp load covers at
                                 # least (4 µs less than 32 for one item)
REDUCE_LEAD_LOADS = 4            # lead slices a slice lane folds at least


class TilePlan(NamedTuple):
    """Launch geometry of one compiled schedule (batch axes excluded).

    ``canon_shape`` is the collapsed ``(g_1, …, g_{L-1}, m)`` view; ``lead``
    its folded prefix; ``n``/``m`` the row and column extents; ``n_resident``
    that an ℓ1 apply at level L-1 keeps whole columns in one CTA;
    ``smem_bytes`` the dynamic shared memory the apply kernel claims.

    The last four fields fix the geometry the wrappers otherwise derive
    per call from the batch (0: the heuristic's choice): the reduce's
    ``packs`` (:func:`reduce_split`) and row ``splits``; the row-walking
    apply's ``rows`` per split (:func:`row_split`; also the partial
    apply's); the lead-split apply's ``chunk`` of lead slices
    (:func:`lead_split`). :func:`plan_tiles` leaves them at 0;
    :func:`candidate_tile_plans` sets them for the measured search.
    """

    canon_shape: Tuple[int, ...]
    lead: Tuple[int, ...]
    n: int
    m: int
    n_resident: bool
    smem_bytes: int
    packs: int = 0
    splits: int = 0
    rows: int = 0
    chunk: int = 0


def plan_tiles(sched: Schedule, dtype: torch.dtype) -> Optional[TilePlan]:
    """The launch geometry for ``sched``, or ``None`` when the kernels do not
    take the design (see the module docstring for the limits)."""
    if sched.batch_dims:
        raise ValueError(
            "plan_tiles takes a batch-free schedule; the batch is the "
            "kernels' leading launch axis")
    if dtype != torch.float32:
        return None
    dims = sched.canonical_shape
    m = dims[-1]
    if sched.solve.norm == "1" and m > L1_KERNEL_MAX:
        return None
    if len(sched.levels) == 1:
        # the whole design is the outer solve; only ℓ1 has a kernel
        if sched.solve.norm != "1":
            return None
        return TilePlan(dims, (), 1, m, True, m * 4)
    lead, n = dims[:-2], dims[-2]
    if len(lead) > MAX_LEAD_RANK:
        return None
    n_resident = sched.levels[-2][0] == "1"
    smem = n * BLOCK_M * 4 if n_resident else 0
    if smem > SMEM_BUDGET_BYTES:
        return None
    return TilePlan(dims, lead, n, m, n_resident, smem)


def row_split(n: int, m: int, batch: int) -> Tuple[int, int]:
    """``(rows_per_split, splits)``: cut n rows into chunks of a multiple of
    ``BLOCK_ROWS`` rows, as many as it takes for
    ``ceil(m / BLOCK_M) · batch · splits`` CTAs to reach ``TARGET_CTAS`` (or
    one chunk per ``BLOCK_ROWS`` rows)."""
    col_ctas = math.ceil(m / BLOCK_M) * batch
    want = max(1, min(math.ceil(TARGET_CTAS / col_ctas),
                      math.ceil(n / BLOCK_ROWS)))
    splits = want
    while True:
        rows = math.ceil(math.ceil(n / splits) / BLOCK_ROWS) * BLOCK_ROWS
        if math.ceil(n / rows) >= want or rows == BLOCK_ROWS:
            return rows, math.ceil(n / rows)
        splits += 1


class LeadSplit(NamedTuple):
    """Launch geometry of the lead-split apply (``csrc/codegen_apply.cu``:
    ``split_apply_kernel``) for a batch of items: grid ``(ctas_x, batch,
    splits)``; CTA ``(x, b, z)`` thread ``t`` owns position ``p = x ·
    SPLIT_THREADS + t < n · (m / vec)``, i.e. row ``p // (m / vec)`` and
    columns ``(p % (m / vec)) · vec + [0, vec)``, of item ``b`` in the lead
    slices ``[z · chunk, min(slices, (z + 1) · chunk))``."""

    vec: int
    ctas_x: int
    chunk: int
    splits: int


@functools.lru_cache(maxsize=256)
def lead_split(n: int, m: int, slices: int, batch: int, vec: int) -> LeadSplit:
    """Cut ``slices`` lead slices (g_1 · g_2) into chunks so that the launch
    reaches ``TARGET_CTAS`` CTAs where the slices allow it (``chunk =
    slices // want`` gives at least ``want`` chunks, the last possibly
    short), and of at most ``SPLIT_CHUNK_MAX`` slices: short CTAs in
    several waves rather than long ones whose last wave runs part-full. ``vec`` is
    4 (16-byte loads; the caller checks ``m % 4 == 0`` and the pointers'
    alignment) or 1."""
    if vec not in (1, 4) or m % vec:
        raise ValueError(f"lead_split: vec {vec} does not divide m = {m}")
    ctas_x = math.ceil(n * (m // vec) / SPLIT_THREADS)
    want = max(1, min(math.ceil(TARGET_CTAS / (ctas_x * batch)), slices))
    chunk = max(1, min(slices // want, SPLIT_CHUNK_MAX))
    return LeadSplit(vec, ctas_x, chunk, math.ceil(slices / chunk))


class ReduceSplit(NamedTuple):
    """Launch geometry of the reduce (``csrc/codegen_reduce.cu``) for a
    batch of items: grid ``(ctas_x, splits, batch)`` of ``REDUCE_THREADS``
    threads. Thread ``t`` of CTA ``(x, z, b)`` owns pack ``x · packs + t %
    packs`` (columns ``[pack · vec, (pack + 1) · vec)``), slice lane ``(t //
    packs) % lanes`` and row lane ``t // (packs · lanes)`` of ``R =
    REDUCE_THREADS / (packs · lanes)``; it walks rows ``z · rows + r, +R, …``
    below ``min(n, (z + 1) · rows)``, and under one lead axis the slices
    ``s, s + lanes, …`` of each. ``splits == 1``: the CTA writes vfin."""

    vec: int
    packs: int
    lanes: int
    ctas_x: int
    rows: int
    splits: int


@functools.lru_cache(maxsize=256)
def reduce_split(lead: Tuple[int, ...], n: int, m: int, batch: int,
                 vec: int, packs: int = 0, splits: int = 0) -> ReduceSplit:
    """The reduce's geometry for ``batch`` items of lead axes ``lead``, ``n``
    rows and ``m`` columns. ``packs`` starts at ``REDUCE_SEGMENT`` bytes of
    each row and doubles until the ``batch · ctas_x`` CTAs number at most
    ``REDUCE_CTAS``, one per SM, so the grid is one wave of CTAs that each
    own whole column strips. Under one lead axis, ``lanes`` slice lanes
    (within a warp: ``packs · lanes <= 32``) fold at least
    ``REDUCE_LEAD_LOADS`` slices each. Only when the strips leave more than
    half the SMs idle (few, long columns) are the rows cut into ``splits``
    chunks, up to ``REDUCE_CTAS`` CTAs. ``vec`` is 4 (16-byte loads; the
    caller checks ``m % 4 == 0`` and the pointers' alignment) or 1.
    ``packs``/``splits`` > 0 replace those choices (a tile plan's: a power
    of two that divides ``REDUCE_THREADS``; any count of row chunks)."""
    if vec not in (1, 4) or m % vec:
        raise ValueError(f"reduce_split: vec {vec} does not divide m = {m}")
    count = m // vec
    if packs:
        if packs & (packs - 1) or REDUCE_THREADS % packs:
            raise ValueError(f"reduce_split: {packs} packs do not divide "
                             f"{REDUCE_THREADS} threads in a power of two")
    else:
        packs = min(REDUCE_SEGMENT // (4 * vec), 1 << (count - 1).bit_length())
        while packs < REDUCE_THREADS and packs < count \
                and math.ceil(count / packs) * batch > REDUCE_CTAS:
            packs *= 2
    lanes = 1
    if len(lead) == 1:
        while 2 * lanes * packs <= 32 and 2 * lanes * REDUCE_LEAD_LOADS <= lead[0]:
            lanes *= 2
    ctas_x = math.ceil(count / packs)
    row_lanes = REDUCE_THREADS // (packs * lanes)
    if not splits:
        splits = 1
        if 2 * ctas_x * batch < REDUCE_CTAS:
            splits = max(1, min(REDUCE_CTAS // (ctas_x * batch),
                                math.ceil(n / row_lanes)))
    rows = math.ceil(n / min(splits, n))
    return ReduceSplit(vec, packs, lanes, ctas_x, rows, math.ceil(n / rows))


def reduce_geometry(tp: TilePlan, batch: int, vec: int) -> ReduceSplit:
    """The reduce's geometry under ``tp`` (its ``packs``/``splits`` where
    set, the heuristic's otherwise)."""
    return reduce_split(tp.lead, tp.n, tp.m, batch, vec, tp.packs, tp.splits)


def apply_rows(tp: TilePlan, batch: int) -> Tuple[int, int]:
    """``(rows_per_split, splits)`` of the row-walking apply (and of the
    partial apply) under ``tp``: whole columns when ``n_resident``, else
    ``tp.rows`` rows a chunk where set, :func:`row_split`'s otherwise."""
    if tp.n_resident:
        return tp.n, 1
    rows = tp.rows or row_split(tp.n, tp.m, batch)[0]
    return rows, math.ceil(tp.n / rows)


def lead_geometry(tp: TilePlan, slices: int, batch: int, vec: int) -> LeadSplit:
    """The lead-split apply's geometry under ``tp`` (its ``chunk`` where
    set, :func:`lead_split`'s otherwise)."""
    ls = lead_split(tp.n, tp.m, slices, batch, vec)
    if not tp.chunk:
        return ls
    chunk = min(tp.chunk, slices)
    return LeadSplit(ls.vec, ls.ctas_x, chunk, math.ceil(slices / chunk))


def candidate_tile_plans(sched: Schedule, dtype: torch.dtype,
                         batch: int = 1) -> Tuple[TilePlan, ...]:
    """The measured search's grid for one batch-free schedule run on
    ``batch`` items: the default plan first, then its neighbours — half and
    double the reduce's packs, its row splits, and the apply's rows a split
    (or, for the lead-split apply, its chunk of lead slices) — each only
    where the kernels' contracts take it (packs a power of two dividing
    ``REDUCE_THREADS``, a chunk within the slices, rows a multiple of
    ``BLOCK_ROWS``; an ``n_resident`` apply keeps whole columns, so it has
    no row neighbours) and where it changes the launch. At most 7 plans;
    ``()`` when the design cannot be generated, the default alone for a
    design that is its outer solve."""
    default = plan_tiles(sched, dtype)
    if default is None:
        return ()
    if len(sched.levels) == 1:
        return (default,)
    tp, n, m = default, default.n, default.m
    vec = 4 if m % 4 == 0 else 1
    rs = reduce_geometry(tp, batch, vec)
    plans = [tp]

    def add(**kw):
        cand = tp._replace(**kw)
        if cand not in plans:
            plans.append(cand)

    count = m // vec
    for p in (rs.packs // 2, rs.packs * 2):
        if 1 <= p <= min(REDUCE_THREADS, 1 << (count - 1).bit_length()) \
                and p != rs.packs:
            alt = reduce_split(tp.lead, n, m, batch, vec, p)
            if alt != rs:
                add(packs=p)
    for z in (rs.splits // 2, rs.splits * 2):
        if 1 <= z <= n and z != rs.splits:
            alt = reduce_split(tp.lead, n, m, batch, vec, 0, z)
            if alt.splits != rs.splits:
                add(splits=z)
    norms = [q for q, _ in sched.levels][:-1]
    if tp.lead and "1" not in norms:          # lowering.split_lead
        slices = math.prod(tp.lead)
        ls = lead_split(n, m, slices, batch, vec)
        for c in (ls.chunk // 2, ls.chunk * 2):
            if 1 <= c <= slices and c != ls.chunk:
                add(chunk=c)
    elif not tp.n_resident:
        rows, _ = row_split(n, m, batch)
        top = math.ceil(n / BLOCK_ROWS) * BLOCK_ROWS
        for r in (rows // 2, rows * 2):
            r = max(BLOCK_ROWS, min(top, r // BLOCK_ROWS * BLOCK_ROWS))
            if r != rows:
                add(rows=r)
    return tuple(plans)
