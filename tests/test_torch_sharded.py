"""The port's mesh executor on 4 gloo CPU ranks against the JAX package.

One module-scoped run starts 4 rank processes (``_torch_sharded_worker.py``,
``FileStore`` rendezvous in a temporary directory) and sends every case
through them: the design matrix of ``tests/test_sharded_codegen.py``
(``DESIGNS + [PARTIAL_APPLY]``), three cases that are uneven on 4 ranks
(one leaves a rank nothing but padding), the three ``batch_dims`` cases and
the two-batch-dim case, each through the plain body and the codegen body
(the generated kernels' plain versions on the CPU); a 2 × 2 mesh with
two sharded axes; the bi- and tri-level specials; the projection hook on granite-3-2b's smoke leaves; and the
planner's sharded backend.

JAX's own mesh path does not run on this host (ROADMAP § 3), so the
reference is JAX's unsharded ``multilevel_project(..., method="sort")`` at
atol 1e-5 (the 64-step distributed bisection's residual), and the two
bodies are held to each other at 1e-6 (one collective plan, the same
arithmetic). Verdicts (``shardable``, ``local_shape``) and the
collective-bytes model are held to JAX's, and every rank's measured
collective calls and bytes to that model.
"""

import json
import os
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core import multilevel_project  # noqa: E402
from repro.core.schedule import sharded_collective_bytes as jax_bytes  # noqa: E402
from repro.kernels.codegen import distributed as jax_dist  # noqa: E402
from repro_torch.core.schedule import sharded_collective_bytes  # noqa: E402
from repro_torch.kernels.codegen import distributed  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "_torch_sharded_worker.py"
WORLD = 4
BILEVEL = [("inf", 1), ("1", 1)]
TRILEVEL = [("inf", 1), ("inf", 1), ("1", 1)]

# tests/test_sharded_codegen.py's matrix (its mesh has 8 devices, this one 4)
DESIGNS = [
    ("l1inf_cols",     (32, 64), BILEVEL, (None, "model")),
    ("l1inf_rows",     (32, 64), BILEVEL, ("model", None)),
    ("l1infinf_last",  (4, 16, 64), TRILEVEL, (None, None, "model")),
    ("l1infinf_mid",   (4, 16, 64), TRILEVEL, (None, "model", None)),
    ("l12_rows",       (32, 48), [("2", 1), ("1", 1)], ("model", None)),
    ("l11_rows",       (32, 48), [("1", 1), ("1", 1)], ("model", None)),
    ("flat_l1",        (16, 24), [("1", 2)], ("model", None)),
    ("l1inf_uneven",   (32, 60), BILEVEL, (None, "model")),
    ("l11_uneven",     (30, 48), [("1", 1), ("1", 1)], ("model", None)),
]
PARTIAL_APPLY = ("l1l1inf_partial", (4, 16, 64),
                 [("inf", 1), ("1", 1), ("1", 1)], (None, "model", None))
# uneven on 4 ranks (the matrix's uneven shapes divide by 4)
UNEVEN4 = [
    ("l1inf_uneven4",  (32, 62), BILEVEL, (None, "model")),
    ("partial_uneven4", (4, 14, 64), [("inf", 1), ("1", 1), ("1", 1)],
     (None, "model", None)),
    ("l11_ragged",     (5, 48), [("1", 1), ("1", 1)], ("model", None)),
]
MATRIX = DESIGNS + [PARTIAL_APPLY] + UNEVEN4
BATCH = [  # (name, shape, spec, batch_dims), bi-level at radius 1.5
    ("batch_solve_ax", (3, 16, 64), (None, None, "model"), 1),
    ("batch_fin_uneven", (3, 16, 60), (None, "model", None), 1),
    ("batch_sharded_batch", (8, 16, 40), ("model", None, None), 1),
    ("two_batch_dims", (2, 3, 16, 64), (None, None, None, "model"), 2),
]
HOOK = [  # granite's head-structured wq design and the bi-level w_up one
    dict(pattern=r"wq", levels=(("inf", 1), ("1", 1), ("1", 1)),
         transpose=True, method="bisect", radius=20.0),
    dict(pattern=r"w_up", levels=(("inf", 1), ("1", 1)), radius=20.0),
]
PLAN = dict(shape=(32, 64), levels=BILEVEL, spec=(None, "model"))


class StandIn:
    """A mesh's layout without ranks: what the verdicts read."""

    shape = {"data": 1, "model": WORLD}
    axis_names = ("data", "model")


def _rand(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * 2).astype(np.float32)


def _cases():
    out = [dict(name=n, shape=s, levels=lv, spec=sp, batch_dims=0, radius=2.5,
                seed=zlib.crc32(n.encode())) for n, s, lv, sp in MATRIX]
    out += [dict(name=n, shape=s, levels=BILEVEL, spec=sp, batch_dims=bd,
                 radius=1.5, seed=zlib.crc32(n.encode())) for n, s, sp, bd in BATCH]
    out.append(dict(out[0], name="l1inf_cols_auto", method="auto"))
    return out


def _hook_params():
    """granite smoke's wq and w_up (numpy), from its template's shapes."""
    from repro_torch.configs.registry import smoke_config
    from repro_torch.models import lm

    t = lm.template(smoke_config("granite-3-2b"))["blocks"]
    return {"attn": {"wq": _rand(t["attn"]["wq"].shape, 1)},
            "mlp": {"w_up": _rand(t["mlp"]["w_up"].shape, 2)}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    (tmp / "cases.json").write_text(json.dumps(
        {"cases": _cases(), "hook": HOOK, "plan": PLAN}))
    params = _hook_params()
    torch.save({k: {n: torch.from_numpy(w) for n, w in v.items()}
                for k, v in params.items()}, tmp / "hook_params.pt")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(r), str(WORLD),
                               str(tmp)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
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
    return [torch.load(tmp / f"rank{r}.pt") for r in range(WORLD)], params


def _gather(shards, spec, shape):
    return sharding.unshard(shards, spec, StandIn, shape).numpy()


def _both(ranks, case):
    return {b: _gather([r["cases"][case["name"]][b] for r in ranks], case["spec"],
                       case["shape"]) for b in ("plain", "codegen")}


@pytest.mark.parametrize("name,shape,levels,spec", MATRIX,
                         ids=[c[0] for c in MATRIX])
def test_matches_unsharded(runs, name, shape, levels, spec):
    ranks, _ = runs
    case = next(c for c in _cases() if c["name"] == name)
    y = _rand(shape, case["seed"])
    want = np.asarray(multilevel_project(jnp.asarray(y), levels, 2.5,
                                         method="sort"))
    got = _both(ranks, case)
    np.testing.assert_allclose(got["plain"], want, atol=1e-5)
    np.testing.assert_allclose(got["codegen"], want, atol=1e-5)
    np.testing.assert_allclose(got["codegen"], got["plain"], atol=1e-6)


@pytest.mark.parametrize("name,shape,spec,bd", BATCH, ids=[c[0] for c in BATCH])
def test_batch_dims(runs, name, shape, spec, bd):
    ranks, _ = runs
    case = next(c for c in _cases() if c["name"] == name)
    y = jnp.asarray(_rand(shape, case["seed"]))
    fn = lambda w: multilevel_project(w, BILEVEL, 1.5)  # noqa: E731
    for _ in range(bd):
        fn = jax.vmap(fn)
    want = np.asarray(fn(y))
    got = _both(ranks, case)
    np.testing.assert_allclose(got["codegen"], want, atol=1e-5)
    np.testing.assert_allclose(got["codegen"], got["plain"], atol=1e-6)


def test_auto_method_agrees_across_ranks(runs):
    # method="auto": rank 0 times the solvers and broadcasts its verdict;
    # the result is the fixed-method one within the solvers' agreement
    ranks, _ = runs
    cases = {c["name"]: c for c in _cases()}
    auto = _both(ranks, cases["l1inf_cols_auto"])
    fixed = _both(ranks, cases["l1inf_cols"])
    np.testing.assert_allclose(auto["codegen"], fixed["codegen"], atol=1e-5)


@pytest.mark.parametrize("case", _cases(), ids=[c["name"] for c in _cases()])
def test_collective_counts_match_the_model(runs, case):
    ranks, _ = runs
    padded = sharding.local_shape(case["shape"], case["spec"], StandIn)
    padded = tuple(d * (WORLD if n else 1) for d, n in zip(padded, case["spec"]))
    model = sharded_collective_bytes(padded, case["levels"], case["spec"],
                                     StandIn.shape, batch_dims=case["batch_dims"])
    for r, res in enumerate(ranks):
        for b in ("plain", "codegen"):
            got = res["cases"][case["name"]][f"counts_{b}"]
            assert (got["calls"], got["bytes"]) == (
                model["schedule_calls"], model["schedule_bytes"]), (r, b, got, model)


@pytest.mark.parametrize("name,shape,levels,spec", DESIGNS + [PARTIAL_APPLY],
                         ids=[c[0] for c in DESIGNS + [PARTIAL_APPLY]])
def test_bytes_model_matches_jax(name, shape, levels, spec):
    mine = sharded_collective_bytes(shape, levels, spec, StandIn.shape)
    ref = jax_bytes(shape, levels, spec, StandIn.shape)
    assert [(s["step"], s["bytes"]) for s in mine["per_step"]] == \
        [(s["step"], s["bytes"]) for s in ref["per_step"]]
    for k in ("schedule_bytes", "gather_bytes", "ratio"):
        assert mine[k] == ref[k]


VERDICTS = [(s, lv, sp, 0) for _, s, lv, sp in MATRIX] \
    + [(s, BILEVEL, sp, bd) for _, s, sp, bd in BATCH] \
    + [((4, 16, 64), TRILEVEL, ("model", None, None), 0),
       ((40, 64, 32, 2048), [("inf", 1), ("1", 1), ("1", 1)],
        (None, None, "model", None), 1),
       ((40, 2048, 8192), BILEVEL, (None, None, "model"), 1)]


@pytest.mark.parametrize("shape,levels,spec,bd", VERDICTS)
def test_shardable_and_local_shape_match_jax(shape, levels, spec, bd):
    assert distributed.local_shape(shape, spec, StandIn) == \
        jax_dist.local_shape(shape, spec, StandIn)
    assert distributed.shardable(shape, levels, spec, StandIn, torch.float32, bd) \
        == jax_dist.shardable(shape, levels, spec, StandIn, jnp.float32, bd)


def test_ineligible_design_refuses_codegen(runs):
    ranks, _ = runs
    assert all(r["gate_raises"] for r in ranks)
    assert not distributed.shardable((4, 16, 64), TRILEVEL, ("model", None, None),
                                     StandIn, torch.float32)


def test_hook_matches_jax_single_device(runs):
    from repro.configs.types import ProjectionSpec
    from repro.optim.projection_hook import apply_projection

    ranks, params = runs
    want = {k: {n: jnp.asarray(w) for n, w in v.items()} for k, v in params.items()}
    for hs in HOOK:
        want = apply_projection(want, ProjectionSpec(**hs), 0)
    specs = ranks[0]["hook_specs"]
    assert specs == {"attn": {"wq": (None, None, "model", None)},
                     "mlp": {"w_up": (None, None, "model")}}
    for b in ("plain", "codegen"):
        for grp, leaf in (("attn", "wq"), ("mlp", "w_up")):
            ref = np.asarray(want[grp][leaf])
            got = _gather([r[f"hook_{b}"][grp][leaf] for r in ranks],
                          specs[grp][leaf], ref.shape)
            np.testing.assert_allclose(got, ref, atol=1e-5, err_msg=f"{b} {leaf}")
            assert 0 < np.mean(got == 0) < 1  # the radius cut, not erased


def test_planner_serves_the_sharded_key(runs):
    ranks, _ = runs
    y = _rand(PLAN["shape"], 12)
    want = np.asarray(multilevel_project(jnp.asarray(y), BILEVEL, 2.0))
    for r in ranks:
        assert r["plan"]["method"] == "sharded"
        assert r["plan"]["candidates"] == ["sharded"]  # no card: no kernels
        assert r["plan"]["generic_raises"]
    for which in ("auto", "forced"):
        got = _gather([r["plan"][which] for r in ranks], PLAN["spec"], PLAN["shape"])
        np.testing.assert_allclose(got, want, atol=1e-5)


def test_two_sharded_axes_on_a_2x2_mesh(runs):
    # rows over "data" (the reduce's pmax spans it), columns over "model"
    # (the outer solve gathers them): one collective each, among the ranks
    # of one line of the mesh
    ranks, _ = runs
    y = _rand((32, 64), 31)
    want = np.asarray(multilevel_project(jnp.asarray(y), BILEVEL, 2.5, method="sort"))
    layout = {"data": 2, "model": WORLD // 2}
    for b in ("plain", "codegen"):
        got = sharding.unshard([r["mesh22"][b] for r in ranks], ("data", "model"),
                               layout, (32, 64)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, err_msg=b)
        for r in ranks:
            c = r["mesh22"][f"counts_{b}"]
            assert (c["by_op"]["pmax"]["calls"], c["by_op"]["all_gather"]["calls"]) == (1, 1)
            assert c["by_op"]["pmax"]["bytes"] == 4 * 64 // layout["model"]
            assert c["by_op"]["all_gather"]["bytes"] == 4 * 64


def test_specials_wrap_the_schedule_body(runs):
    ranks, _ = runs
    y2, y3 = _rand((32, 64), 21), _rand((4, 16, 64), 22)
    want2 = np.asarray(multilevel_project(jnp.asarray(y2), BILEVEL, 2.0, method="sort"))
    want3 = np.asarray(multilevel_project(jnp.asarray(y3), TRILEVEL, 2.0, method="sort"))
    for name, spec, want in (("make_bilevel", (None, "model"), want2),
                             ("bilevel_body", (None, "model"), want2),
                             ("make_trilevel", (None, None, "model"), want3),
                             ("trilevel_body", (None, None, "model"), want3)):
        got = _gather([r["specials"][name] for r in ranks], spec, want.shape)
        np.testing.assert_allclose(got, want, atol=1e-5, err_msg=name)
    assert all(r["uneven_special_raises"] for r in ranks)


def test_shard_and_unshard_are_inverse():
    x = torch.arange(1, 3 * 5 * 2 + 1, dtype=torch.float32).reshape(3, 5, 2)
    spec = (None, "model", None)
    pieces = [sharding.shard(x, spec, StandIn, rank=r) for r in range(WORLD)]
    assert all(p.shape == (3, 2, 2) for p in pieces)
    assert float(pieces[3].abs().sum()) == 0.0  # rank 3 holds only padding
    assert float(pieces[2][:, 1].abs().sum()) == 0.0
    assert torch.equal(sharding.unshard(pieces, spec, StandIn, x.shape), x)
