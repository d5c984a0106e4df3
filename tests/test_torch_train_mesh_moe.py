"""The sharded train step of the MoE family (deepseek-v3-671b,
kimi-k2-1t-a32b: MLA attention and GShard MoE layers) on 4 gloo CPU ranks
against the port's single-device step and JAX's.

One module-scoped run starts 4 rank processes
(``_torch_train_mesh_moe_worker.py``, a ``file://`` rendezvous in a
temporary directory) that serve every case: each arch's smoke config (4
layers, the first dense; 8 experts, top-2, one shared; 4 MLA heads of 16
nope + 8 rope, v 16) in float32, 2 steps of 8 sequences of 16 tokens in
micro-batches of 4, remat on, the launcher's constraint ``(w_up|w_gate)``
(the bi-level ℓ1,∞ projection of the dense, shared and expert leaves),
under ``param_rules(mesh)`` on the (2, 2) and (1, 4) meshes, deepseek-v3
in both dispatches. The experts and the MLA heads split over "model" on
both meshes, the 'embed' axis over "data" on (2, 2). The dispatch runs in
``dp_shards`` token groups, as JAX's launcher sets ``n_groups``: each data
rank's tokens are its own groups, with the global capacity. Each rank then
runs the train launcher of each arch on a 2 × 2 mesh for one step.

JAX's mesh path does not run on this host (ROADMAP § 3, reference items
2, 3 and 9), so each case is held against the port's single-device
unfused step from the same numpy parameters (``make_train_step(fused=
False)`` with the same ``n_groups``), and step 1's loss against JAX's
``make_train_step`` without a mesh (its loss function on the same
micro-batches with the same ``n_groups``, the forward alone compiled).
Tolerances as ``test_torch_train_mesh_families.py``'s: loss and gradient
norm within 1e-5 relative; AdamW's moments within 1e-5 of the leaf's
largest entry (the router's gradient, held by itself, too); parameters
within 1e-5 of the leaf's largest entry plus 1e-5 relative where the
first step's gradient is at least 1e-5. Routing is discrete, so it is
held exactly: every MoE layer's groups, capacity, experts and kept slots
on each rank equal the one-device route's on that rank's tokens, and the
balance loss averaged over the data ranks equals the one-device one
within 1e-6 relative.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_recurrent import numpy_params
from repro import models as jmodels
from repro.configs import registry as jreg
from repro.training import step as jstep
from repro_torch import _tree, interop, models
from repro_torch.configs import registry as treg
from repro_torch.launch import train as train_cli
from repro_torch.models import lm
from repro_torch.models.params import param_specs
from repro_torch.optim import adamw
from repro_torch.optim.projection_hook import _project_leaf
from repro_torch.parallel import sharding
from repro_torch.training.step import make_train_step, step_collectives

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _torch_train_mesh_moe_worker import (  # noqa: E402
    HOOK_LEAF, case_setup, record_routes)

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "_torch_train_mesh_moe_worker.py"
WORLD = 4
ARCHS = ("deepseek-v3-671b", "kimi-k2-1t-a32b")
SEEDS = {"deepseek-v3-671b": 0, "kimi-k2-1t-a32b": 1}
BASE = dict(steps=2, micro=4, batch=8, seq=16, radius=1.0, hook_radius=2.0)
CASES = [dict(BASE, arch=a, sizes=s, dispatch=d,
              name=f"{a.split('-')[0]}_{d}_{s[0]}x{s[1]}")
         for a, d in ((ARCHS[0], "einsum"), (ARCHS[0], "scatter"),
                      (ARCHS[1], "einsum"))
         for s in ([2, 2], [1, 4])]
NAMES = [c["name"] for c in CASES]
LAUNCH = ["--smoke", "--device", "cpu", "--mesh", "2x2", "--steps", "1",
          "--batch", "4", "--microbatch", "2", "--seq", "8", "--radius", "1.0",
          "--attn", "chunked"]
HOOK_SHAPE = (3, 8, 64, 32)   # moe_blocks/mlp/w_up of the smoke configs


def _case(name):
    return next(c for c in CASES if c["name"] == name)


def _sizes(case):
    return dict(zip(("data", "model"), case["sizes"]))


def _reference(case, init):
    """The port's single-device unfused step from the same init with the
    mesh's ``n_groups``: per-step loss and gradient norm, the first step's
    moments, the final state; and the routes and balance loss of one
    forward of the first micro-batch."""
    cfg, tcfg, pipe = case_setup(case)
    dp = case["sizes"][0]
    p = _tree.tree_map(lambda x: x.clone(), init)
    with torch.no_grad():
        (_, aux), routes = record_routes(lambda: lm.forward(
            p, torch.from_numpy(pipe.batch(0)[0])[:, :-1], cfg,
            impl="chunked", n_groups=dp))
    st = {"params": p, "opt": adamw.init(p, tcfg)}
    fn = make_train_step(cfg, tcfg, models.get(cfg), impl="chunked",
                         n_groups=dp, fused=False)
    out = {"losses": [], "grad_norms": [], "lr": [], "routes": routes,
           "aux": float(aux)}
    for i in range(case["steps"]):
        st, m = fn(st, {"tokens": torch.from_numpy(pipe.batch(i))})
        out["losses"].append(float(m["loss"]))
        out["grad_norms"].append(float(m["grad_norm"]))
        out["lr"].append(float(m["lr"]))
        if i == 0:
            for key in ("m", "v"):
                out[f"{key}1"] = _tree.tree_map(torch.clone, st["opt"][key])
    out["state"] = st
    return out


def _jax_step1_loss(case, jcfg, np_params):
    """Step 1's loss as JAX's ``make_train_step`` reports it (no mesh,
    float32, chunked attention, the mesh's ``n_groups``): the mean over the
    micro-batches of its loss function at the initial parameters."""
    _, _, pipe = case_setup(case)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, dispatch=case["dispatch"]))
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    fn = jax.jit(jstep.make_loss_fn(jcfg, jmodels.get(jcfg), impl="chunked",
                                    n_groups=case["sizes"][0], remat=False,
                                    compute_dtype=jnp.float32))
    return float(np.mean([float(fn(jp, jnp.asarray(mb)))
                          for mb in pipe.batch(0)]))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_mesh_moe")
    (tmp / "cases.json").write_text(json.dumps({"cases": CASES,
                                                "launch": LAUNCH,
                                                "archs": ARCHS}))
    inits = {}
    for arch in ARCHS:
        jcfg = jreg.smoke_config(arch)
        np_params = numpy_params(jmodels.get(jcfg).template(jcfg), SEEDS[arch])
        inits[arch] = (jcfg, np_params,
                       interop.from_numpy_tree(np_params, device="cpu"))
        torch.save(inits[arch][2], tmp / f"init_{arch}.pt")
    leaf = torch.from_numpy(np.random.default_rng(5).standard_normal(
        HOOK_SHAPE).astype(np.float32))
    torch.save(leaf, tmp / "hook_leaf.pt")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(r), str(WORLD),
                               str(tmp)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    threads = torch.get_num_threads()
    # one thread here too: the references are small, and beside the ranks
    # (and the test runner's other workers) a thread pool only contends
    torch.set_num_threads(1)
    try:
        refs, jax_loss, by_cfg = {}, {}, {}
        for c in CASES:
            jcfg, np_params, init = inits[c["arch"]]
            refs[c["name"]] = _reference(c, init)
            key = (c["arch"], c["dispatch"], c["sizes"][0])
            if key not in by_cfg:
                by_cfg[key] = _jax_step1_loss(c, jcfg, np_params)
            jax_loss[c["name"]] = by_cfg[key]
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        torch.set_num_threads(threads)
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    ranks = [torch.load(tmp / f"rank{r}.pt") for r in range(WORLD)]
    return ranks, refs, jax_loss, leaf


def _full(ranks, name, key):
    res = [r["cases"][name] for r in ranks]
    return sharding.unshard_tree([r[key] for r in res], res[0]["specs"],
                                 _sizes(_case(name)))


@pytest.mark.parametrize("name", NAMES)
def test_loss_and_grad_norm_match_single_device(runs, name):
    ranks, refs, _, _ = runs
    ref = refs[name]
    for r in ranks:
        got = r["cases"][name]
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norms"], ref["grad_norms"],
                                   rtol=1e-5)
        assert got["losses"] == ranks[0]["cases"][name]["losses"]
        assert got["grad_norms"] == ranks[0]["cases"][name]["grad_norms"]


@pytest.mark.parametrize("name", NAMES)
def test_step1_loss_matches_jax(runs, name):
    ranks, _, jax_loss, _ = runs
    np.testing.assert_allclose(ranks[0]["cases"][name]["losses"][0],
                               jax_loss[name], rtol=1e-5)


def _hold(what, a, b, rel):
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                               atol=rel * float(b.abs().max()), err_msg=what)


@pytest.mark.parametrize("name", NAMES)
def test_params_and_moments_match_single_device(runs, name):
    """Step 1's moments hold the gradient: m and √v (|g|) within 1e-5 of
    their largest entry; the last step's within 1e-4 (a last-bit
    difference near a zero gradient moves an entry by up to 2 lr, and the
    next gradient with it); the parameters as the module docstring says."""
    ranks, refs, _, _ = runs
    ref = refs[name]
    lr_sum = sum(ref["lr"])
    got_p, got_m, got_v, got_m1, got_v1 = (
        _full(ranks, name, k) for k in ("params", "m", "v", "m1", "v1"))
    want = ref["state"]
    for (path, p), wp, m, wm, v, wv, m1, wm1, v1, wv1 in zip(
            _tree.leaves_with_paths(got_p), _tree.leaves(want["params"]),
            _tree.leaves(got_m), _tree.leaves(want["opt"]["m"]),
            _tree.leaves(got_v), _tree.leaves(want["opt"]["v"]),
            _tree.leaves(got_m1), _tree.leaves(ref["m1"]),
            _tree.leaves(got_v1), _tree.leaves(ref["v1"])):
        _hold(f"{name} {path} m1", m1, wm1, 1e-5)
        _hold(f"{name} {path} sqrt(v1)", v1.sqrt(), wv1.sqrt(), 1e-5)
        _hold(f"{name} {path} m", m, wm, 1e-4)
        _hold(f"{name} {path} v", v, wv, 1e-4)
        well = (wm1.abs() / (1 - 0.9)) >= 1e-5
        d = (p - wp).abs()
        bar = 1e-5 * float(wp.abs().max()) + 1e-5 * wp.abs()
        assert bool((d[well] <= bar[well]).all()), (name, path, float(d[well].max()))
        assert float(d.max()) <= 2 * lr_sum, (name, path, float(d.max()))


@pytest.mark.parametrize("name", NAMES)
def test_router_gradient_matches_single_device(runs, name):
    """The router is replicated over "model" and used on both sides of the
    experts' branch: through the gates of this rank's experts (summed over
    the ranks) and through the balance loss (the same on every rank). Its
    step-1 gradient (m1 = 0.1 g) must be the one-device one, entry by entry
    within 1e-5 of its largest and in norm within 1e-5: the balance loss's
    part counted once, not once per "model" rank."""
    ranks, refs, _, _ = runs
    got = _full(ranks, name, "m1")["moe_blocks"]["mlp"]["router"]
    want = refs[name]["m1"]["moe_blocks"]["mlp"]["router"]
    _hold(f"{name} router m1", got, want, 1e-5)
    np.testing.assert_allclose(float(got.norm()), float(want.norm()), rtol=1e-5)


@pytest.mark.parametrize("name", NAMES)
def test_routes_and_balance_loss_match_one_device(runs, name):
    """Every MoE layer's route on a rank is the one-device route's groups
    of that rank's tokens: the same group size and capacity, and the same
    experts and kept slots; the balance loss averaged over the data ranks
    is the one-device one."""
    ranks, refs, _, _ = runs
    case = _case(name)
    dp = case["sizes"][0]
    want = refs[name]["routes"]
    auxes = []
    for r, res in enumerate(ranks):
        got = res["cases"][name]["routes"]
        d = sharding.rank_coords(r, _sizes(case))["data"]
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert (g["tg"], g["cap"]) == (w["tg"], w["cap"])
            assert g["g"] * dp == w["g"]
            part = slice(d * g["g"], (d + 1) * g["g"])
            assert torch.equal(g["top_i"], w["top_i"][part]), (name, r)
            assert torch.equal(g["keep"], w["keep"][part]), (name, r)
        assert not all(bool(w["keep"].all()) for w in want)  # capacity binds
        auxes.append(res["cases"][name]["aux"])
    np.testing.assert_allclose(np.mean(auxes), refs[name]["aux"], rtol=1e-6)


@pytest.mark.parametrize("name", NAMES)
def test_replicated_copies_are_bit_identical(runs, name):
    """Ranks whose coordinates agree on every axis a leaf is sharded over
    hold the same slice of it: the same bits in params and moments."""
    ranks, _, _, _ = runs
    sizes = _sizes(_case(name))
    specs = ranks[0]["cases"][name]["specs"]
    coords = [sharding.rank_coords(r, sizes) for r in range(WORLD)]
    for key in ("params", "m", "v"):
        per_rank = [_tree.leaves(r["cases"][name][key]) for r in ranks]
        for i, (path, sp) in enumerate(_tree.leaves_with_paths(specs)):
            axes = sharding.spec_axes(sp)
            for r in range(1, WORLD):
                for q in range(r):
                    if all(coords[r][a] == coords[q][a] for a in axes):
                        assert torch.equal(per_rank[r][i], per_rank[q][i]), \
                            (name, key, path, q, r)


@pytest.mark.parametrize("name", NAMES)
def test_collective_counts_match_the_model(runs, name):
    ranks, _, _, _ = runs
    case = _case(name)
    cfg, tcfg, pipe = case_setup(case)
    model = step_collectives(cfg, tcfg, ranks[0]["cases"][name]["specs"],
                             _sizes(case), pipe.batch(0).shape)
    want = {op: {"calls": model["calls"][op], "bytes": model["bytes"][op]}
            for op in model["calls"]}
    for r, res in enumerate(ranks):
        for i, counts in enumerate(res["cases"][name]["counts"]):
            assert counts["by_op"] == want, (r, i, counts["by_op"], want)


@pytest.mark.parametrize("name", NAMES)
def test_hook_on_expert_sharded_leaf_matches_one_device(runs, name):
    """The mesh-native hook on an expert leaf (L, E, d, f), experts over
    "model" (a batch axis of the projection) and d over "data": each rank
    projects its own experts, and the gathered result is the one-device
    projection of the whole leaf, expert by expert."""
    ranks, _, _, leaf = runs
    case = _case(name)
    spec = ranks[0]["cases"][name]["specs"]["moe_blocks"]["mlp"]["w_up"]
    assert spec[1] == "model"
    got = sharding.unshard([r["cases"][name]["hook"] for r in ranks], spec,
                           _sizes(case), leaf.shape)
    levels = [("inf", 1), ("1", 1)]
    moved = False
    for i in range(leaf.shape[0]):
        for e in range(leaf.shape[1]):
            want = _project_leaf(leaf[i, e], levels, case["hook_radius"], "sort")
            _hold(f"{name} {HOOK_LEAF} [{i}, {e}]", got[i, e], want, 1e-6)
            moved |= not torch.equal(want, leaf[i, e])
    assert moved


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_trains_each_moe_arch_on_a_2x2_mesh(runs, arch):
    """``launch.train.run`` under ``--mesh 2x2`` (bf16 compute, no remat,
    ``--attn chunked``): a finite loss the same on every rank, the
    collectives = the step's model, and each projected leaf's column
    sparsity reported (the dense, shared and expert w_up/w_gate)."""
    ranks, _, _, _ = runs
    got = [r["launch"][arch] for r in ranks]
    assert np.isfinite(got[0]["losses"]).all() and len(got[0]["losses"]) == 1
    assert all(g["losses"] == got[0]["losses"] for g in got)
    cfg = treg.smoke_config(arch)
    mesh = {"data": 2, "model": 2}
    tcfg = train_cli.launch_config(train_cli._parser().parse_args(LAUNCH))
    specs = param_specs(models.get(cfg).template(cfg),
                        sharding.param_rules(mesh), mesh)
    model = step_collectives(cfg, tcfg, specs, mesh, (2, 2, 9))
    want = {op: {"calls": model["calls"][op], "bytes": model["bytes"][op]}
            for op in model["calls"]}
    for g in got:
        assert [c["by_op"] for c in g["collectives"]] == [want]
    assert {"dense_blocks/mlp/w_up", "moe_blocks/mlp/w_up",
            "moe_blocks/mlp/shared/w_gate"} <= set(got[0]["sparsity"])
    assert all(0 <= v <= 100 for v in got[0]["sparsity"].values())


@pytest.mark.parametrize("kind", ["single", "multi"])
@pytest.mark.parametrize("arch", ARCHS)
def test_meta_train_cell_counts_equal_step_collectives(arch, kind):
    """The dry run's train cell of each MoE arch (smoke config, 128 × 16
    tokens in micro-batches of 64) walks on ``meta`` on one rank of the
    production meshes, 32 × 8 and 2 × 32 × 8 (the giants' 'embed' over
    ("pod", "data") there, one entry over two mesh axes): its collectives
    by op, calls and bytes, equal ``step_collectives``' model, and the cost
    walk splits them by the axes each spans. (The full
    configs' specs on both meshes equal JAX's:
    ``test_torch_launch_specs.py::test_state_specs_equal_jax``.)"""
    from repro_torch.configs.types import SHAPES
    from repro_torch.launch import specs as TSP
    from repro_torch.launch.mesh import make_abstract_mesh
    from repro_torch.roofline import costs

    cfg = treg.smoke_config(arch)
    mesh = make_abstract_mesh(kind)
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=16, global_batch=128)
    tune = dataclasses.replace(TSP.tuning_for(cfg), microbatch=64)
    cell = TSP.train_cell(cfg, shape, mesh, tune=tune)
    state, batch = cell["args"]
    mesh.reset_counts()
    with costs.walk(mesh=mesh) as w:
        cell["fn"](state, batch)
    specs = cell["specs"]["state"]["params"]
    model = step_collectives(cfg, cell["tcfg"], specs, mesh,
                             tuple(batch["tokens"].shape))
    got = mesh.counts()["by_op"]
    assert {op: c["calls"] for op, c in got.items()} == model["calls"]
    assert {op: c["bytes"] for op, c in got.items()} == model["bytes"]
    assert specs["moe_blocks"]["mlp"]["w_up"] == (
        None, "model", ("pod", "data") if kind == "multi" else "data", None)
    # the cost walk prices each collective by the axes it spans: the
    # experts' and heads' psums over "model", the FSDP gathers over the
    # 'embed' entry's axes
    by_axis = dict(w.costs.coll_by_axis)
    fsdp = "pod,data" if kind == "multi" else "data"
    assert by_axis["model"] > 0 and by_axis[fsdp] > 0
    assert sum(by_axis.values()) == w.costs.coll_bytes


def test_a_stack_cut_to_no_layers_trains_under_the_constraint():
    """zamba2-7b cut to one super-group (``--layers 3`` of its smoke config,
    whose super-group holds 3 layers) leaves its trailing Mamba stack with
    no layer: the launcher trains under the constraint all the same, an
    empty leaf being its own projection, and reports the sparsity of the
    others."""
    run = train_cli.run(["--device", "cpu", "--smoke", "--arch", "zamba2-7b",
                         "--layers", "3", "--steps", "1", "--radius", "5.0",
                         "--seq", "16", "--batch", "2", "--telemetry-every", "1"])
    empty = [n for n, x in _tree.leaves_with_paths(run["state"]["params"])
             if x.numel() == 0]
    assert empty and np.isfinite(run["losses"]).all()
    assert run["sparsity"] and not set(empty) & set(run["sparsity"])


def test_inplace_update_in_slices_equals_the_whole_leaf(monkeypatch):
    """``adamw.update(inplace=True)`` takes a large float32-moment leaf in
    slices of its leading axis (deepseek-v3's 3.45 GiB embedding would
    otherwise hold several leaf-sized temporaries at once on a card that
    four ranks share): the parameters and both moments equal the
    whole-leaf update's bit for bit, for a leaf cut into slices, a
    one-layer stack and a vector."""
    monkeypatch.setattr(adamw, "_SLICE", 1000)
    cfg = dataclasses.replace(case_setup(CASES[0])[1], projection=None)
    rng = np.random.default_rng(3)
    params = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for k, s in (("a", (50, 64)), ("b", (7,)), ("c", (1, 40, 64)))}
    grads = {k: torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32))
             for k, p in params.items()}
    assert len(adamw._slices(params["a"])) == 4
    whole = {k: p.clone() for k, p in params.items()}
    got = adamw.update(grads, adamw.init(params, cfg), params, cfg, inplace=True)
    want = adamw.update(grads, adamw.init(whole, cfg), whole, cfg)
    for k in params:
        assert torch.equal(got[0][k], want[0][k]), k
        for part in ("m", "v"):
            assert torch.equal(got[1][part][k], want[1][part][k]), (k, part)
