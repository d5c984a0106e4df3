"""The sharded train step of the audio, hybrid and recurrent families
(whisper-large-v3, zamba2-7b, xlstm-1.3b) on 4 gloo CPU ranks against the
port's single-device step and JAX's.

One module-scoped run starts 4 rank processes
(``_torch_train_mesh_families_worker.py``, a ``file://`` rendezvous in a
temporary directory) that serve every case: each family's smoke config in
float32, 2 steps of 8 sequences of 16 tokens in micro-batches of 4, remat
on, the launcher's constraint ``(w_up|w_gate|w_in)`` (the bi-level ℓ1,∞
projection), under ``param_rules(mesh)`` on the (2, 2) and (1, 4) meshes,
and whisper at a vocabulary of 254, which "model" shards on (2, 2) and
not on (1, 4) (as whisper-large-v3's 51,866). Each rank then runs the
train launcher of each family on a 2 × 2 mesh for one step.

The smoke configs split every family's heads over "model" on both meshes:
whisper's 4 q heads over 2 kv heads (kv sharded on (2, 2), replicated and
picked per rank on (1, 4)), zamba's shared attention, xLSTM's 4 mLSTM and
sLSTM heads (one a rank on (1, 4)); Mamba2's fused ``w_in`` (328 wide)
shards over "model" in pieces that do not line up with its heads, and
the sLSTM's FFN (170 wide) shards on (2, 2) and not on (1, 4).

JAX's mesh path does not run on this host (ROADMAP § 3, reference items
2, 3 and 9), so each case is held against the port's single-device
unfused step from the same numpy parameters (``make_train_step(fused=
False)``), and step 1's loss against JAX's ``make_train_step`` without a
mesh (its loss function on the same micro-batches, the forward alone
compiled). Tolerances as ``test_torch_train_mesh.py``'s: loss and gradient norm
within 1e-5 relative; AdamW's moments within 1e-5 of the leaf's largest
entry; parameters within 1e-5 of the leaf's largest entry plus 1e-5
relative where the first step's gradient is at least 1e-5 (elsewhere
AdamW's g / (|g| + eps) turns on the gradient's last bits, and the bound
is its per-step move, 2 · Σ lr_t). Replicated leaves are bit-identical
across ranks, and every rank's collectives per step equal
``training.step.step_collectives``' model.
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
from repro_torch.optim import adamw
from repro_torch.optim.projection_hook import _matches, _sharded_leaf_names
from repro_torch.parallel import sharding
from repro_torch.parallel.mesh import AbstractMesh
from repro_torch.models.params import param_specs
from repro_torch.training.step import make_train_step, step_collectives

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _torch_train_mesh_families_worker import case_setup  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "_torch_train_mesh_families_worker.py"
WORLD = 4
ARCHS = ("whisper-large-v3", "zamba2-7b", "xlstm-1.3b")
BASE = dict(vocab=256, steps=2, micro=4, batch=8, seq=16, radius=1.0)
# whisper runs JAX's chunked attention, as test_torch_whisper.py's train
# steps do: on the zero audio's cross keys the flash backward's delta puts
# dec_blocks/cross/wk's gradient 1.2e-5 of its largest entry from float64;
# zamba's shared attention runs flash (the plain version here) on the mesh
IMPL = {"whisper-large-v3": "chunked", "zamba2-7b": "flash", "xlstm-1.3b": "flash"}
CASES = [dict(BASE, arch=a, sizes=s, impl=IMPL[a],
              name=f"{a.split('-')[0]}_{s[0]}x{s[1]}")
         for a in ARCHS for s in ([2, 2], [1, 4])]
CASES.append(dict(BASE, arch=ARCHS[0], sizes=[1, 4], vocab=254,
                  impl=IMPL[ARCHS[0]], name="whisper_v254_1x4"))
NAMES = [c["name"] for c in CASES]
LAUNCH = ["--smoke", "--device", "cpu", "--mesh", "2x2", "--steps", "1",
          "--batch", "4", "--microbatch", "2", "--seq", "8", "--radius", "1.0"]
SEED = 7


def _case(name):
    return next(c for c in CASES if c["name"] == name)


def _sizes(case):
    return dict(zip(("data", "model"), case["sizes"]))


def _numpy_init(case):
    """The JAX config and the case's parameters drawn in numpy, shared by
    both packages."""
    jcfg = dataclasses.replace(jreg.smoke_config(case["arch"]),
                               vocab=case["vocab"])
    return jcfg, numpy_params(jmodels.get(jcfg).template(jcfg), SEED)


def _reference(case, init):
    """The port's single-device unfused step from the same init: per-step
    loss and gradient norm, the first step's moments, the final state."""
    cfg, tcfg, pipe = case_setup(case)
    p = _tree.tree_map(lambda x: x.clone(), init)
    st = {"params": p, "opt": adamw.init(p, tcfg)}
    fn = make_train_step(cfg, tcfg, models.get(cfg), impl=case["impl"],
                         fused=False)
    out = {"losses": [], "grad_norms": [], "lr": []}
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
    float32, chunked attention): the mean over the micro-batches of its
    loss function (``make_loss_fn``) at the initial parameters, the
    forward alone compiled."""
    _, _, pipe = case_setup(case)
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    fn = jax.jit(jstep.make_loss_fn(jcfg, jmodels.get(jcfg), impl="chunked",
                                    n_groups=1, remat=False,
                                    compute_dtype=jnp.float32))
    return float(np.mean([float(fn(jp, jnp.asarray(mb)))
                          for mb in pipe.batch(0)]))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_mesh_families")
    (tmp / "cases.json").write_text(json.dumps({"cases": CASES,
                                                "launch": LAUNCH,
                                                "archs": ARCHS}))
    inits = {}
    for c in CASES:
        jcfg, np_params = _numpy_init(c)
        inits[c["name"]] = (jcfg, np_params,
                            interop.from_numpy_tree(np_params, device="cpu"))
        torch.save(inits[c["name"]][2], tmp / f"init_{c['name']}.pt")
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
        # the references run while the ranks do; JAX's once per config (the
        # two meshes of a family share it)
        refs, jax_loss, by_cfg = {}, {}, {}
        for c in CASES:
            jcfg, np_params, init = inits[c["name"]]
            refs[c["name"]] = _reference(c, init)
            key = (c["arch"], c["vocab"])
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
    return ranks, refs, jax_loss


def _full(ranks, name, key):
    res = [r["cases"][name] for r in ranks]
    return sharding.unshard_tree([r[key] for r in res], res[0]["specs"],
                                 _sizes(_case(name)))


@pytest.mark.parametrize("name", NAMES)
def test_loss_and_grad_norm_match_single_device(runs, name):
    ranks, refs, _ = runs
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
    ranks, _, jax_loss = runs
    np.testing.assert_allclose(ranks[0]["cases"][name]["losses"][0],
                               jax_loss[name], rtol=1e-5)


def _hold(what, a, b, rel):
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                               atol=rel * float(b.abs().max()), err_msg=what)


@pytest.mark.parametrize("name", NAMES)
def test_params_and_moments_match_single_device(runs, name):
    """Step 1's moments hold the gradient: m and √v (|g|) within 1e-5 of
    their largest entry. The last step's moments within 1e-4 (phase 9 (a)'s
    bar in ``chip_smoke.py``): step 1's update moves an entry whose gradient
    lies near 0 by up to 2 lr on a last-bit difference, which moves the
    next gradient (2.1e-5 of its largest entry on zamba's Mamba w_in)."""
    ranks, refs, _ = runs
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
        m1 = wm1
        well = (m1.abs() / (1 - 0.9)) >= 1e-5
        d = (p - wp).abs()
        bar = 1e-5 * float(wp.abs().max()) + 1e-5 * wp.abs()
        assert bool((d[well] <= bar[well]).all()), (name, path, float(d[well].max()))
        assert float(d.max()) <= 2 * lr_sum, (name, path, float(d.max()))


@pytest.mark.parametrize("name", NAMES)
def test_replicated_copies_are_bit_identical(runs, name):
    """Ranks whose coordinates agree on every axis a leaf is sharded over
    hold the same slice of it: the same bits in params and moments (a
    missing or doubled backward psum would let them drift)."""
    ranks, _, _ = runs
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
    ranks, _, _ = runs
    case = _case(name)
    cfg, tcfg, pipe = case_setup(case)
    model = step_collectives(cfg, tcfg, ranks[0]["cases"][name]["specs"],
                             _sizes(case), pipe.batch(0).shape)
    want = {op: {"calls": model["calls"][op], "bytes": model["bytes"][op]}
            for op in model["calls"]}
    for r, res in enumerate(ranks):
        for i, counts in enumerate(res["cases"][name]["counts"]):
            assert counts["by_op"] == want, (r, i, counts["by_op"], want)


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_trains_each_family_on_a_2x2_mesh(runs, arch):
    """``launch.train.run`` under ``--mesh 2x2`` (bf16 compute, no remat):
    a finite loss the same on every rank, the collectives = the step's
    model, and each projected leaf's column sparsity reported."""
    ranks, _, _ = runs
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
    assert got[0]["sparsity"] and all(0 <= v <= 100
                                      for v in got[0]["sparsity"].values())


def _constrained(cfg, sizes):
    """(path, global shape, spec) of every leaf the launcher's constraint
    projects, and whether the hook runs it on the mesh executor."""
    tpl = models.get(cfg).template(cfg)
    specs = dict(_tree.leaves_with_paths(param_specs(
        tpl, sharding.param_rules(sizes), sizes)))
    match = _matches(train_cli.launch_config(
        train_cli._parser().parse_args(["--radius", "1.0"])).projection)
    mesh = AbstractMesh(list(sizes.values()), list(sizes))
    out = []
    for path, pd in _tree.leaves_with_paths(tpl):
        if match(path, torch.empty(pd.shape, device="meta")):
            names = _sharded_leaf_names(mesh, specs[path], len(pd.shape), 2)
            out.append((path, pd.shape, names))
    return out, mesh


@pytest.mark.parametrize("sizes", [(2, 2), (1, 4)])
@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_constrained_leaves_take_the_codegen_body(arch, sizes):
    """At full width (zamba cut to 13 layers, xLSTM to 16, whisper to 4 +
    4) every leaf of the launcher's constraint is sharded on both meshes,
    so the hook runs it on the mesh executor, and ``shardable`` sends it to
    the generated kernels on the card, never to the plain body."""
    from repro_torch.kernels.codegen.distributed import shardable
    from repro_torch.models import lm

    cfg = lm.cut_depth(treg.get_arch(arch), {"whisper-large-v3": 4,
                                             "zamba2-7b": 13,
                                             "xlstm-1.3b": 16}[arch])
    leaves, mesh = _constrained(cfg, dict(zip(("data", "model"), sizes)))
    assert leaves
    for path, shape, names in leaves:
        assert names is not None, (arch, sizes, path)
        assert shardable(shape, [("inf", 1), ("1", 1)], names, mesh,
                         torch.float32, len(shape) - 2), (arch, sizes, path)


@pytest.mark.parametrize("loop", ["slstm", "mlstm"])
def test_meta_walk_counts_the_recurrent_loops(loop, monkeypatch):
    """The dry run's walk on ``meta`` runs one sLSTM step or mLSTM chunk and
    counts the others (``costs.walked_steps``/``count_steps``): forward and
    backward, its FLOPs equal the walk of every step, and its bytes lie
    within 2 % of them (the stand-in outputs' copy and its backward)."""
    from repro_torch.models import xlstm
    from repro_torch.roofline import costs

    b, s, h, dh = 2, 64, 4, 32

    def walked():
        if loop == "slstm":
            ins = [torch.empty((b, s, 4, h, dh), device="meta", requires_grad=True),
                   torch.empty((4, h, dh, dh), device="meta", requires_grad=True)]
            fn = xlstm._slstm_scan
        else:
            ins = [torch.empty(sh, device="meta", requires_grad=True)
                   for sh in [(b, s, h, dh)] * 3 + [(b, s, h)] * 2]
            fn = lambda *a: xlstm.mlstm_chunkwise(*a, chunk=8)  # noqa: E731
        with costs.walk() as w:
            y, _ = fn(*ins)
            torch.autograd.grad(y.sum(), ins)
        return w.costs

    sampled = walked()
    monkeypatch.setattr(costs, "walked_steps", lambda n, like: n)
    full = walked()
    assert sampled.flops == full.flops > 0
    assert abs(sampled.bytes / full.bytes - 1) <= 0.02, (sampled.bytes, full.bytes)
