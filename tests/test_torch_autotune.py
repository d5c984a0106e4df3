"""The measured tile search of the generated pipeline
(``repro_torch/kernels/codegen``: ``candidate_tile_plans``,
``autotune_tiles``, ``clear_tile_cache``, ``build_tuned``), on the CPU.

The kernels do not run here, so each candidate's launch geometry is
replayed in Python as ``test_torch_reduce_split.py`` and
``test_torch_apply_split.py`` replay the heuristic's: every element is
covered once by the reduce (its packs, slice lanes and row chunks) and by
the apply (its row chunks, or its chunks of lead slices), and the reduce's
fold order replayed under each candidate equals ``reduce_plain`` (within
1e-5 relative, the fold order's), the lead-split apply's arithmetic
``apply_plain`` exactly. Each candidate keeps the kernels' contracts (packs
a power of two dividing the reduce's threads, rows a multiple of the
block's thread rows, an ℓ1 apply's whole columns), and the wrappers hand a
candidate's geometry to the launch. On the CPU ``autotune_tiles`` returns
the heuristic plan without timing anything, and caches it per (shape,
levels, dtype, device). A measured search keeps the heuristic unless a
neighbour beats it by more than the spread between rounds, and under a
mesh takes rank 0's verdict.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.core import schedule as tschedule
from repro_torch.kernels import codegen
from repro_torch.kernels.codegen import lowering as tlowering
from repro_torch.kernels.codegen import tiling as ttiling
from test_torch_apply_split import _count_cover, _lead, model_split_apply
from test_torch_reduce_split import _close, _cover, model_reduce

BILEVEL = [("inf", 1), ("1", 1)]
TRILEVEL = [("inf", 1), ("inf", 1), ("1", 1)]
# LEAD 0 (rows split or not), LEAD 1 (slice lanes; lead split; ℓ1 over the
# rows: n_resident), LEAD 2, ragged m (vec 1)
DESIGNS = [
    ("bilevel", (512, 96), BILEVEL),
    ("bilevel_tall", (4096, 32), BILEVEL),
    ("bilevel_l2", (64, 200), [("2", 1), ("1", 1)]),
    ("trilevel", (16, 32, 128), TRILEVEL),
    ("trilevel_deep", (64, 5, 61), TRILEVEL),
    ("l1_rows", (6, 40, 24), [("inf", 1), ("1", 1), ("1", 1)]),
    ("rank4", (3, 4, 5, 32), [("inf", 1), ("2", 1), ("inf", 1), ("1", 1)]),
]


def _sched(shape, levels):
    sched = tschedule.compile_schedule(shape, levels)
    return sched, [q for q, _ in sched.levels][:-1]


@pytest.fixture(autouse=True)
def _fresh_cache():
    codegen.clear_tile_cache()
    yield
    codegen.clear_tile_cache()


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("name,shape,levels", DESIGNS)
def test_candidates_keep_the_contracts_and_cover_every_element_once(
        name, shape, levels, batch):
    sched, red = _sched(shape, levels)
    cands = ttiling.candidate_tile_plans(sched, torch.float32, batch)
    default = ttiling.plan_tiles(sched, torch.float32)
    assert cands[0] == default and 2 <= len(cands) <= 8
    assert len(set(cands)) == len(cands)
    for tp in cands:
        assert tp[:6] == default[:6]
        assert not tp.packs or (ttiling.REDUCE_THREADS % tp.packs == 0
                                and tp.packs & (tp.packs - 1) == 0)
        assert not tp.rows or (tp.rows % ttiling.BLOCK_ROWS == 0
                               and not tp.n_resident)
        for vec in (1, 4) if tp.m % 4 == 0 else (1,):
            rs = ttiling.reduce_geometry(tp, batch, vec)
            assert rs.packs * rs.lanes <= 32 or rs.lanes == 1
            counts = _cover(tp.lead, tp.n, tp.m, rs)
            assert int(counts.min()) == 1 and int(counts.max()) == 1, (tp, vec)
            assert (rs.splits - 1) * rs.rows < tp.n <= rs.splits * rs.rows
            if tlowering.split_lead(tp, red):
                g1, g2 = _lead(tp)
                ls = ttiling.lead_geometry(tp, g1 * g2, batch, vec)
                c = _count_cover(batch, g1 * g2, tp.n, tp.m, ls)
                assert int(c.min()) == 1 and int(c.max()) == 1, (tp, vec)
        rows, splits = ttiling.apply_rows(tp, batch)
        assert (splits - 1) * rows < tp.n <= splits * rows
        if tp.n_resident:
            assert (rows, splits) == (tp.n, 1)


@pytest.mark.parametrize("name,shape,levels", DESIGNS)
def test_candidate_replays_equal_the_plain_versions(name, shape, levels):
    sched, red = _sched(shape, levels)
    batch = 2
    rng = np.random.default_rng(len(name))
    cands = ttiling.candidate_tile_plans(sched, torch.float32, batch)
    tp0 = cands[0]
    yc = torch.from_numpy((rng.normal(size=(batch,) + tp0.canon_shape) * 2)
                          .astype(np.float32))
    yc[0].view(-1)[[3, 17, 40]] = torch.tensor([float("nan"), float("inf"),
                                                -float("inf")])
    want_aggs, want = tlowering.reduce_plain(yc, red)
    aggs, vfin = want_aggs, want
    u = tlowering._solve_outer_batched(
        vfin, "1", 0.3 * vfin.nan_to_num(posinf=0).sum(1), "bisect")
    want_x = tlowering.apply_plain(yc, aggs, vfin, u, red)
    for tp in cands:
        vec = 4 if tp.m % 4 == 0 else 1
        got_aggs, got = model_reduce(yc, red, ttiling.reduce_geometry(tp, batch, vec))
        for a, w in zip(got_aggs, want_aggs):
            _close(a, w)
        _close(got, want)
        if tlowering.split_lead(tp, red):
            g1, g2 = _lead(tp)
            ls = ttiling.lead_geometry(tp, g1 * g2, batch, vec)
            x = model_split_apply(yc, aggs, vfin, u, red, ls)
            assert torch.equal(x.isnan(), want_x.isnan())
            fin = ~want_x.isnan()
            assert torch.equal(x[fin], want_x[fin]), tp


def test_the_searched_geometry_reaches_the_launch(monkeypatch):
    from test_torch_no_fallback import _reach_the_launch, _stand_in

    _reach_the_launch(monkeypatch)
    _, reduce_calls = _stand_in(monkeypatch, tlowering.REDUCE, 0)
    _, apply_calls = _stand_in(monkeypatch, tlowering.APPLY, 0)
    for shape, levels in (((4096, 32), BILEVEL), ((16, 32, 128), TRILEVEL)):
        sched, red = _sched(shape, levels)
        for tp in ttiling.candidate_tile_plans(sched, torch.float32, 2):
            yc = torch.empty((2,) + tp.canon_shape, device="meta")
            aggs, vfin = tlowering.codegen_reduce(yc, tp, red)
            rs = ttiling.reduce_geometry(tp, 2, 4)
            assert reduce_calls[-1][15:19] == (rs.packs, rs.lanes, rs.rows, rs.splits)
            tlowering.codegen_apply(yc, aggs, vfin, vfin, tp, red)
            rows, splits, chunk, vec = apply_calls[-1][-5:-1]
            if tlowering.split_lead(tp, red):
                ls = ttiling.lead_geometry(tp, math.prod(tp.lead), 2, 4)
                assert (splits, chunk) == (ls.splits, ls.chunk)
            else:
                assert (rows, splits) == ttiling.apply_rows(tp, 2)


def test_autotune_on_the_cpu_returns_the_default_untimed(monkeypatch):
    from repro_torch.kernels import _build

    def no_timing(*a, **k):
        raise AssertionError("the search timed candidates on the CPU")

    monkeypatch.setattr(codegen, "_time_candidates", no_timing)
    _build.reset_launches()
    sched, _ = _sched((512, 96), BILEVEL)
    default = ttiling.plan_tiles(sched, torch.float32)
    got = codegen.autotune_tiles((512, 96), BILEVEL, torch.float32, device="cpu")
    assert got == default
    assert codegen.autotune_tiles((512, 96), BILEVEL, torch.float32,
                                  device="cpu", measure=False) == default
    assert codegen.tile_search_log() == {}
    assert sum(_build.launch_counts().values()) == 0
    fn = codegen.build_tuned((512, 96), BILEVEL, torch.float32, device="cpu")
    y = torch.randn(512, 96, generator=torch.Generator().manual_seed(0))
    assert torch.equal(fn(y, 3.0), codegen.build((512, 96), BILEVEL,
                                                 torch.float32, device="cpu")(y, 3.0))
    with pytest.raises(RuntimeError, match="CUDA"):
        codegen.autotune_tiles((512, 96), BILEVEL, torch.float32)


def test_tile_cache_keys():
    a = codegen.autotune_tiles((512, 96), BILEVEL, torch.float32, device="cpu")
    keys = set(codegen._TUNED_TILES)
    assert keys == {((512, 96), (("inf", 1), ("1", 1)), "float32", "cpu")}
    # a batch axis, another shape, another design: their own entries
    codegen.autotune_tiles((3, 512, 96), BILEVEL, torch.float32, device="cpu")
    codegen.autotune_tiles((512, 64), BILEVEL, "float32", device="cpu")
    codegen.autotune_tiles((16, 32, 128), TRILEVEL, torch.float32, device="cpu")
    assert len(codegen._TUNED_TILES) == 4
    assert codegen.autotune_tiles((512, 96), [("inf", 1), (1, 1)], torch.float32,
                                  device="cpu") is a
    assert codegen.autotune_tiles((8, 16), BILEVEL, torch.bfloat16,
                                  device="cpu") is None   # the tiler's f32 only
    codegen.clear_tile_cache()
    assert codegen._TUNED_TILES == {}


def test_measured_search_on_the_cpu_times_every_candidate():
    """``measure=True`` times the plain versions by the host clock: every
    candidate gets a best round and a spread, the verdict is a candidate,
    and the search's calls count as no kernel launch on the CPU."""
    from repro_torch.kernels import _build

    _build.reset_launches()
    sched, _ = _sched((16, 32, 128), TRILEVEL)
    cands = ttiling.candidate_tile_plans(sched, torch.float32, 1)
    got = codegen.autotune_tiles((16, 32, 128), TRILEVEL, torch.float32,
                                 device="cpu", measure=True)
    log = codegen.tile_search_log()[((16, 32, 128), tuple(map(tuple, TRILEVEL)),
                                     "float32", "cpu")]
    assert log["plans"] == cands and got == cands[log["winner"]]
    assert len(log["ms"]) == len(log["spread"]) == len(cands)
    assert all(t > 0 and s >= 0 for t, s in zip(log["ms"], log["spread"]))
    assert log["ms"][log["fastest"]] == min(log["ms"])
    assert log["winner"] in (0, log["fastest"])
    assert sum(_build.launch_counts().values()) == 0


# (best ms, spread ms) of a heuristic and three neighbours -> the verdict
VERDICTS = [
    ([5.0, 1.0, 3.0, 2.0], [0.1] * 4, 1),     # a clear win
    ([5.0, 4.95, 6.0, 7.0], [0.1] * 4, 0),    # within the spread: heuristic
    ([5.0, 4.5, 6.0, 7.0], [0.1, 0.6, 0.1, 0.1], 0),  # the winner's own spread
    ([1.0, 2.0, 3.0, 4.0], [0.0] * 4, 0),     # the heuristic is fastest
]


@pytest.mark.parametrize("best,spread,want", VERDICTS)
def test_a_neighbour_replaces_the_heuristic_only_beyond_the_spread(
        monkeypatch, best, spread, want):
    monkeypatch.setattr(codegen, "_time_candidates",
                        lambda fns, y, r, out, cuda: (best[:len(fns)],
                                                      spread[:len(fns)]))
    sched, _ = _sched((16, 32, 128), TRILEVEL)
    cands = ttiling.candidate_tile_plans(sched, torch.float32, 1)
    assert len(cands) >= len(best)
    got = codegen.autotune_tiles((16, 32, 128), TRILEVEL, torch.float32,
                                 device="cpu", measure=True)
    log = next(iter(codegen.tile_search_log().values()))
    assert log["winner"] == want and got == cands[want]
    assert log["fastest"] == min(range(len(best)), key=best.__getitem__)


def test_a_tile_plan_of_another_schedule_is_refused():
    s1, _ = _sched((512, 96), BILEVEL)
    s2, _ = _sched((512, 64), BILEVEL)
    tp = ttiling.candidate_tile_plans(s2, torch.float32)[1]
    with pytest.raises(ValueError, match="not a plan of"):
        tlowering.generate(s1, torch.float32, device="cpu", tile_plan=tp)


class _Ranks:
    """A mesh layout whose rank 0 answers ``pick`` with ``answer``."""

    shape = {"data": 1, "model": 4}
    axis_names = ("data", "model")

    def __init__(self, answer=None):
        self.answer, self.asked = answer, 0

    def broadcast_choice(self, choices, pick):
        self.asked += 1
        mine = pick()
        assert mine in choices
        return mine if self.answer is None else self.answer


def test_sharded_body_takes_the_heuristic_off_the_card(monkeypatch):
    """Off the card a sharded body's plan is the heuristic, searched for
    nothing and agreed with no rank; a measured search under a mesh takes
    rank 0's verdict, cached apart from the unshared one and dropped by
    ``clear_tile_cache``."""
    from repro_torch.core import schedule
    from repro_torch.kernels.codegen import distributed

    def no_search(*a, **k):
        raise AssertionError("a CPU body ran the tile search")

    levels = [("inf", 1), ("1", 1)]
    sched = schedule.compile_schedule((2, 64, 96), levels, 1)
    with monkeypatch.context() as m:
        m.setattr(codegen, "autotune_tiles", no_search)
        distributed.make_codegen_schedule_body(
            sched, (None, None, "model"), _Ranks(), torch.float32, device="cpu")
    ranks = _Ranks()
    default = ttiling.plan_tiles(schedule.compile_schedule((64, 24), levels),
                                 torch.float32)
    assert codegen.autotune_tiles((2, 64, 24), levels, torch.float32,
                                  device="cpu", mesh=ranks) == default
    assert ranks.asked == 0 and codegen.tile_search_log() == {}
    codegen.clear_tile_cache()
    monkeypatch.setattr(codegen, "_time_candidates",
                        lambda fns, y, r, out, cuda: ([1.0] * len(fns),
                                                      [0.0] * len(fns)))
    cands = ttiling.candidate_tile_plans(
        schedule.compile_schedule((64, 24), levels), torch.float32, 2)
    ranks = _Ranks(answer="1")
    for _ in range(2):
        got = codegen.autotune_tiles((2, 64, 24), levels, torch.float32,
                                     device="cpu", measure=True, mesh=ranks)
        assert got == cands[1] and ranks.asked == 1
    assert codegen.autotune_tiles((2, 64, 24), levels, torch.float32,
                                  device="cpu", measure=True) == cands[0]
    assert len(codegen._TUNED_TILES) == 2
    codegen.clear_tile_cache()
    assert codegen._TUNED_TILES == {}
    codegen.autotune_tiles((2, 64, 24), levels, torch.float32, device="cpu",
                           measure=True, mesh=ranks)
    assert ranks.asked == 2
