"""The clip stream of the golden ``clip`` and ``trilevel_apply`` kernels
(``csrc/golden.cuh:stream_clip``, geometry ``kernels/bilevel_l1inf.py:
stream_shape``), modelled on the CPU.

The kernel runs one CTA of ``STREAM_THREADS`` threads per unit: a tile of
``STREAM_TILE`` packs of the (n, m) plane (``vec`` elements a pack) and one
of ``groups`` groups of planes; CTA b takes tile b % tiles and planes b //
tiles, + groups, … Thread t takes packs t and t + STREAM_THREADS of the
tile. A pack's first column is one division and then a step of
``STREAM_THREADS · vec mod m``; inside a pack the column wraps at m (a pack
may straddle a row end); the ragged last pack (plane % vec elements) runs
element by element in the last tile. The tests replay that index
arithmetic in numpy and hold that it covers every element of (c, n, m)
exactly once and gives every element its own column, at
``chip_smoke.py``'s shapes (phase 1's GOLDEN_SHAPES and STREAM_SHAPES,
phase 3 and 6's W1–W4, which hold the server's two requests) and at ragged
widths, one-row planes and c = 1, in float32 and bf16, aligned or not;
that the main path's groups leave four waves of CTAs; and that X computed
through the replayed columns equals the JAX package's Pallas kernels in
interpret mode exactly, NaN and ±inf included (clips and minima do not
round). The kernels themselves are held against their plain versions on the
card by ``chip_smoke.py``.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bilevel_l1inf import clip_pallas
from repro.kernels.trilevel_l1infinf import trilevel_apply_pallas
from repro_torch.kernels import bilevel_l1inf as tbi
from repro_torch.kernels import trilevel_l1infinf as ttri

PACKS = tbi.STREAM_TILE // tbi.STREAM_THREADS   # packs per thread
# (c, n, m): chip_smoke.py's W1 / W3 (bi-level, c = 1) and W2 / W4; W1 and
# W2 are the server's two requests
MAIN = [(1, 8192, 2048), (256, 32, 2048), (1, 1000, 10000), (32, 1000, 2000)]
# chip_smoke.py's GOLDEN_SHAPES and STREAM_SHAPES, bi-level ones as c = 1
PHASE1 = ([(1,) + s for s in [(8, 128), (256, 512), (300, 700), (1024, 257),
                              (7, 1000), (1, 128), (250, 333), (1024, 512),
                              (37, 1001), (3, 2001), (5, 7), (1, 9), (64, 257)]]
          + [(2, 8, 128), (3, 17, 130), (8, 250, 64), (1, 64, 257),
             (4, 300, 700), (3, 9, 1001), (3, 8, 1001), (2, 16, 257),
             (1, 5, 7), (4, 3, 2001), (2, 1, 9)])
# ragged widths (m % 4 ≠ 0 and the main path's m = 1000, 2000), one-row
# planes, c = 1, planes smaller than a pack and planes of many rounds
RAGGED = [(c, n, m) for m in (7, 257, 1000, 1001, 2000, 2001)
          for c, n in ((1, 1), (1, 37), (3, 1), (5, 24), (2, 300))]
ITEMSIZES = [4, 2]   # float32, bf16


def _geometry(c, n, m, itemsize, aligned):
    vec, groups = tbi.stream_shape(c, n, m, itemsize, aligned)
    packs = -(-(n * m) // vec)
    return vec, groups, packs, -(-packs // tbi.STREAM_TILE)


def _columns(j, vec, m):
    """``column_radius``'s columns of packs starting at columns j: one
    16-byte load, or the column stepped element by element, wrapping at m."""
    k = np.arange(vec)
    cols = np.empty((len(j), vec), np.int64)
    fast = (vec > 1) & (j % vec == 0) & (j + vec <= m)
    cols[fast] = j[fast, None] + k
    jj = j[~fast].copy()
    for kk in range(vec):
        cols[~fast, kk] = jj
        jj += 1
        jj[jj == m] = 0
    return cols


def replay(c, n, m, itemsize, aligned):
    """The kernel's visits: per plane element the number of tiles that
    clip it, per (tile, plane) the number of CTAs that reach it, and the
    number of packs that straddle a row end; every element's column as the
    kernel finds it (-1 where none does)."""
    vec, groups, packs, tiles = _geometry(c, n, m, itemsize, aligned)
    plane = n * m
    whole = plane // vec
    jstep = tbi.STREAM_THREADS * vec % m
    t = np.arange(tbi.STREAM_THREADS)
    k = np.arange(vec)
    count = np.zeros(plane, np.uint8)
    cols = np.full(plane, -1, np.int64)
    straddle = 0
    for tile in range(tiles):
        q = tile * tbi.STREAM_TILE + t
        q1 = min(whole, (tile + 1) * tbi.STREAM_TILE)
        j = q * vec % m                  # one division per thread
        for u in range(PACKS):
            qu = q + u * tbi.STREAM_THREADS
            live = qu < q1
            f = qu[live, None] * vec + k
            cols[f] = _columns(j, vec, m)[live]
            straddle += int((np.diff(f % m, axis=1) < 0).any(1).sum())
            count[f.ravel()] += 1
            j = j + jstep
            j[j >= m] -= m
        if whole < packs and tile == tiles - 1:   # the ragged last pack
            e = whole * vec + t
            e = e[e < plane]
            count[e] += 1
            cols[e] = e % m
    reached = np.zeros((tiles, c), np.int64)
    for b in range(tiles * groups):
        for pl in range(b // tiles, c, groups):
            reached[b % tiles, pl] += 1
    return count, reached, straddle, cols, (vec, groups, tiles)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("itemsize", ITEMSIZES)
@pytest.mark.parametrize("shape", MAIN + PHASE1 + RAGGED,
                         ids=lambda s: "x".join(map(str, s)))
def test_stream_covers_every_element_once(shape, itemsize, aligned):
    """Every (plane, element) is clipped exactly once: the tiles cover each
    plane element once, the CTAs reach each (tile, plane) once, and every
    element takes its own column, those of packs that straddle a row end
    too."""
    c, n, m = shape
    count, reached, straddle, cols, (vec, groups, tiles) = replay(
        c, n, m, itemsize, aligned)
    assert (count == 1).all() and (reached == 1).all()
    assert np.array_equal(cols, np.arange(n * m) % m)
    if vec > 1 and m % vec:
        assert straddle > 0 or n == 1
    if vec == 1:
        assert straddle == 0


@pytest.mark.parametrize("itemsize", ITEMSIZES)
@pytest.mark.parametrize("shape", MAIN + PHASE1 + RAGGED,
                         ids=lambda s: "x".join(map(str, s)))
def test_stream_shape_leaves_four_waves(shape, itemsize):
    """Each group takes as many planes as leave four waves of
    ``STREAM_CTAS`` CTAs (one plane a group when even that leaves fewer);
    16-byte packs whenever the pointers (and, for c > 1, the planes) are
    aligned."""
    c, n, m = shape
    for aligned in (True, False):
        vec, groups, packs, tiles = _geometry(c, n, m, itemsize, aligned)
        assert tbi.stream_shape.__wrapped__(c, n, m, itemsize, aligned) == \
            (vec, groups)
        per = math.ceil(c / groups)                  # planes of a group
        assert 1 <= groups <= c and math.ceil(c / per) == groups
        assert per == 1 or tiles * groups >= 4 * tbi.STREAM_CTAS
        wide = aligned and (c == 1 or n * m * itemsize % 16 == 0)
        assert vec == (16 // itemsize if wide else 1)


def test_main_path_shapes():
    """W1 / W3 (clip): 8192 / 4883 CTAs of one 8 KB tile. W2: 32 tiles of
    its 64 Ki-element plane by 128 groups of 2 planes, 4096 CTAs (v2, 256
    KB, read 128 times, from L2). W4: 977 tiles by 4 groups of 8 planes,
    3908 CTAs (its 8 MB v2 read 4 times)."""
    assert tbi.stream_shape(1, 8192, 2048, 4, True) == (4, 1)
    assert tbi.stream_shape(1, 1000, 10000, 4, True) == (4, 1)
    assert tbi.stream_shape(256, 32, 2048, 4, True) == (4, 128)
    assert tbi.stream_shape(32, 1000, 2000, 4, True) == (4, 4)
    assert [_geometry(*s, 4, True)[3] for s in MAIN] == [8192, 32, 4883, 977]


def _inputs(shape, jdt, seed):
    """Y, u1 and v2 = max_c |Y| with a NaN, +inf and -inf in each."""
    rng = np.random.default_rng(seed)
    c, n, m = shape
    y = (rng.normal(size=shape) * 3.0).astype(np.float32)
    u = np.abs(rng.normal(size=m)).astype(np.float32)
    y.reshape(-1)[[0, y.size // 2, y.size - 1]] = [np.nan, np.inf, -np.inf]
    u[[0, m // 2, m - 1]] = [np.nan, np.inf, -np.inf]
    y = np.array(jnp.asarray(y, jdt).astype(jnp.float32))   # in Y's type
    v2 = np.abs(y).max(0)
    v2.reshape(-1)[[1, v2.size // 3, v2.size - 2]] = [np.nan, np.inf, -np.inf]
    return y, u, v2


@pytest.mark.parametrize("jdt,tdt", [(jnp.float32, torch.float32),
                                     (jnp.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("shape", [(1, 37, 1001), (1, 5, 7), (1, 3, 2001),
                                   (3, 8, 1001), (2, 16, 257), (4, 3, 2001)],
                         ids=lambda s: "x".join(map(str, s)))
def test_replayed_stream_matches_pallas_exactly(shape, jdt, tdt):
    """X through the replayed columns (clip: u[j]; apply: min(v2, u1[j])
    in Y's type), clipped as the kernel clips, equals the JAX package's
    ``clip_pallas`` / ``trilevel_apply_pallas`` in interpret mode, NaN and
    ±inf in Y, u and v2 included; and the port's wrapper on the CPU gives
    the same."""
    c, n, m = shape
    itemsize = 4 if tdt == torch.float32 else 2
    y, u, v2 = _inputs(shape, jdt, sum(shape))
    ty = torch.from_numpy(y).to(tdt)
    tu = torch.from_numpy(u).to(tdt)
    tv2 = torch.from_numpy(v2).to(tdt)
    cols = torch.from_numpy(replay(c, n, m, itemsize, True)[3])
    assert (cols >= 0).all()
    if c == 1:
        r = tu[cols]
        want = np.asarray(clip_pallas(jnp.asarray(y[0], jdt), jnp.asarray(u),
                                      interpret=True), np.float32)[None]
        port = tbi.clip(ty[0], torch.from_numpy(u))[None]
    else:
        r = torch.minimum(tv2.reshape(-1), tu[cols])
        want = np.asarray(trilevel_apply_pallas(
            jnp.asarray(y, jdt), jnp.asarray(v2, jdt), jnp.asarray(u),
            interpret=True), np.float32)
        port = ttri.trilevel_apply(ty, tv2, torch.from_numpy(u))
    r = r.reshape(1, -1)
    got = torch.minimum(torch.maximum(ty.reshape(c, -1), -r), r).reshape(shape)
    np.testing.assert_array_equal(got.float().numpy(), want)
    np.testing.assert_array_equal(port.float().numpy(), want)
