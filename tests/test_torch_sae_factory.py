"""Parity of the port's SAE factory (``repro_torch.training.sae_factory`` and
the modules under it) with the JAX package's, on the CPU, at smoke widths.

Inputs cross over as numpy: the LM and SAE parameters are made by the JAX
package's ``init_params`` and carried to the port with
``interop.from_numpy_tree``; optimizer tests draw gradients from a seeded
numpy generator. Tolerances, each with its reason:

* harvested activations: atol 2e-5 (4 f32 layers, sums in another order);
  the meta and the reader's row selection are exact;
* one AdamW / fused AdamW+project step: 1e-6 (the same f32 operations; the
  projection's 64-step bisection moves θ by an ulp);
* ``train_sae`` over 6 steps: losses rtol 1e-5, final params atol 1e-5,
  column sparsity exact (gradients differ in the last bits, and Adam's
  normalized update carries that into the weights);
* MMCS: 1e-6.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.types import ProjectionSpec as JSpec, TrainConfig as JTrain
from repro.data import DataConfig as JDataConfig
from repro.data.activations import ActivationReader as JReader
from repro.models import params as jparams, sae as jsae
from repro.optim import adamw as jadamw, fused_step as jfused
from repro.training import sae_factory as JF
from repro.training.mmcs import mmcs as jmmcs, mmcs_sym as jmmcs_sym, mmcs_table as jmmcs_table
from repro_torch import _tree, interop
from repro_torch.configs.types import ProjectionSpec, TrainConfig
from repro_torch.data import DataConfig, DataPipeline, pipeline as tpipeline
from repro_torch.data.activations import ActivationReader
from repro_torch.launch import sae_factory as tcli
from repro_torch.models import sae as tsae
from repro_torch.optim import adamw as tadamw, fused_step as tfused
from repro_torch.optim import projection_hook as thook
from repro_torch.training import sae_factory as TF
from repro_torch.training.mmcs import mmcs as tmmcs, mmcs_sym as tmmcs_sym, mmcs_table as tmmcs_table

FCFG = dict(layers=(0, 2), harvest_steps=3, seq_len=8, lm_batch=2,
            train_steps=6, sae_batch=16, microbatch=8, expansion=2, radius=0.2)
BILEVEL = (("inf", 1), ("1", 1))
TRILEVEL = (("inf", 1), ("inf", 1), ("1", 1))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _to_torch(tree):
    return interop.from_numpy_tree(_np(tree), device="cpu")


@pytest.fixture(scope="module")
def harvests(tmp_path_factory):
    """The same smoke harvest written by each package, from the JAX init."""
    jd, td = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("torch")
    jf = JF.SAEFactoryConfig(**FCFG)
    jmeta = JF.harvest_activations(jf, jd)
    _, _, lm_params = JF.lm_for(jf)
    tmeta = TF.harvest_activations(TF.SAEFactoryConfig(**FCFG), td,
                                   params=_to_torch(lm_params))
    return jd, jmeta, td, tmeta


# ------------------------------------------------------------------ harvest
def test_harvest_meta_and_shards_match_jax(harvests):
    jd, jmeta, td, tmeta = harvests
    assert tmeta == jmeta
    assert json.loads((td / "meta.json").read_text()) == jmeta
    jfiles = sorted(p.name for p in jd.glob("*.npy"))
    assert sorted(p.name for p in td.glob("*.npy")) == jfiles
    assert len(jfiles) == len(FCFG["layers"]) * FCFG["harvest_steps"]
    for name in jfiles:
        a, b = np.load(td / name), np.load(jd / name)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=2e-5, rtol=0)


@pytest.mark.parametrize("step", [0, 1, 5, 40])
@pytest.mark.parametrize("layer", [0, 2])
def test_activation_reader_batches_identical(harvests, step, layer):
    jd, _, td, _ = harvests
    kw = dict(vocab=1, seq_len=0, global_batch=8, microbatch=4,
              activation_dir=str(jd), activation_layer=layer)
    want = JReader(jd, JDataConfig(**kw)).batch(step)
    np.testing.assert_array_equal(ActivationReader(jd, DataConfig(**kw)).batch(step),
                                  want)
    kw["activation_dir"] = str(td)
    got = DataPipeline(DataConfig(**kw)).batch(step)
    assert got.shape == (2, 4, want.shape[1])
    np.testing.assert_allclose(got.reshape(want.shape), want, atol=2e-5)


def test_token_stream_is_bit_identical():
    from repro.data import pipeline as jpipeline
    cfg = dict(vocab=100352, seq_len=32, global_batch=4, microbatch=2, seed=3)
    for step in (0, 7):
        np.testing.assert_array_equal(
            tpipeline._hash_tokens(step, tpipeline.DataConfig(**cfg)),
            jpipeline._hash_tokens(step, jpipeline.DataConfig(**cfg)))
    a = tpipeline.classification_synthetic(50, 40, 8)
    b = jpipeline.classification_synthetic(50, 40, 8)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(tpipeline.lung_like(40, 30, 6), jpipeline.lung_like(40, 30, 6)):
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------- optimizer
def _opt_tree(seed, scale=0.5):
    rng = np.random.default_rng(seed)

    def mk(*s):
        return (rng.normal(size=s) * scale).astype(np.float32)

    return {"blocks": {"mlp": {"w_up": mk(3, 16, 64), "w_down": mk(3, 64, 16)},
                       "attn": {"w_in": mk(16, 64)}},
            "emb": mk(64, 64)}


def _configs(levels, every=1, transpose=False):
    kw = dict(lr=1e-2, warmup=2, total_steps=10, master_dtype="",
              weight_decay=0.1)
    spec = dict(pattern=r"w_up|w_in", levels=levels, radius=0.7,
                every=every, method="bisect", transpose=transpose)
    return (JTrain(projection=JSpec(**spec), **kw),
            TrainConfig(projection=ProjectionSpec(**spec), **kw))


def _assert_close(t_tree, j_tree, atol):
    flat_t = dict(_tree.leaves_with_paths(t_tree))
    flat_j = {"/".join(str(getattr(k, "key", k)) for k in path): v
              for path, v in jax.tree_util.tree_leaves_with_path(j_tree)}
    assert set(flat_t) == set(flat_j)
    for name, v in flat_t.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(flat_j[name]),
                                   atol=atol, rtol=atol, err_msg=name)


def _two_steps(jstep, tstep, jcfg, tcfg):
    """Run two steps of each package from the same params and grads."""
    p = _opt_tree(0)
    jp, jstate = p, jadamw.init(p, jcfg)
    tp = interop.from_numpy_tree(p, device="cpu")
    tstate = tadamw.init(tp, tcfg)
    for s in (1, 2):
        g = _opt_tree(s, scale=0.3)
        jp, jstate, jm = jstep(g, jstate, jp)
        tp, tstate, tm = tstep(interop.from_numpy_tree(g, device="cpu"), tstate, tp)
        _assert_close(tp, jp, 1e-6)
        _assert_close(tstate["m"], jstate["m"], 1e-6)
        _assert_close(tstate["v"], jstate["v"], 1e-6)
        assert int(tstate["step"]) == int(jstate["step"]) == s
        for k in ("grad_norm", "lr"):
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-6)
    return tp


def test_adamw_update_matches_jax():
    jcfg, tcfg = _configs(BILEVEL)
    _two_steps(lambda g, s, p: jadamw.update(g, s, p, jcfg),
               lambda g, s, p: tadamw.update(g, s, p, tcfg), jcfg, tcfg)


def _fused_in_place(tcfg):
    """The port's fused step, checked to write into its inputs."""
    def step(g, s, p):
        before = {n: t.data_ptr() for n, t in _tree.leaves_with_paths(p)}
        newp, news, m = tfused.fused_update(g, s, p, tcfg)
        assert newp is p and news is s
        assert {n: t.data_ptr() for n, t in _tree.leaves_with_paths(newp)} == before
        return newp, news, m
    return step


@pytest.mark.parametrize("levels,transpose", [(BILEVEL, False), (BILEVEL, True),
                                              (TRILEVEL, False)])
def test_fused_update_matches_jax(levels, transpose):
    jcfg, tcfg = _configs(levels, transpose=transpose)
    tp = _two_steps(lambda g, s, p: jfused.fused_update(g, s, p, jcfg),
                    _fused_in_place(tcfg), jcfg, tcfg)
    spec = tcfg.projection
    want = ["blocks/mlp/w_up"] if levels == TRILEVEL else \
        ["blocks/attn/w_in", "blocks/mlp/w_up"]   # w_in is 2-D: no 3 axes
    assert thook.matched_names(tp, spec) == want
    report = TF.constraint_report(tp, spec)
    assert report["feasible"] and report["max_violation"] <= 1e-5 * spec.radius


def test_fused_update_every_gate():
    jcfg, tcfg = _configs(BILEVEL, every=2)
    _two_steps(lambda g, s, p: jfused.fused_update(g, s, p, jcfg),
               _fused_in_place(tcfg), jcfg, tcfg)


def test_projection_hook_matches_jax():
    from repro.optim import projection_hook as jhook
    _, tcfg = _configs(TRILEVEL)
    jcfg, _ = _configs(TRILEVEL)
    p = _opt_tree(5, scale=2.0)
    got = thook.project_tree(interop.from_numpy_tree(p, device="cpu"),
                             tcfg.projection)
    want = jhook.project_tree(p, jcfg.projection)
    _assert_close(got, want, 1e-6)
    ts = thook.tree_sparsity(got, tcfg.projection)
    js = jhook.tree_sparsity(want, jcfg.projection)
    assert {k: float(v) for k, v in ts.items()} == pytest.approx(
        {k: float(v) for k, v in js.items()})


# -------------------------------------------------------------- SAE training
def _jax_train(harvest_dir, layer, jf, seed):
    """The JAX train_sae loop, keeping every step's loss."""
    meta = JF.read_meta(harvest_dir)
    d_in = meta["d_model"]
    tcfg = JF.sae_train_config(jf)
    pipe = JF.DataPipeline(JF.DataConfig(
        vocab=1, seq_len=0, global_batch=jf.sae_batch, microbatch=jf.microbatch,
        activation_dir=str(harvest_dir), activation_layer=layer))
    state = JF.init_sae_state(d_in, jf.expansion * d_in, tcfg,
                              jax.random.PRNGKey(seed), heads=jf.heads)
    init = _np(state["params"])
    step = jax.jit(JF.make_sae_train_step(tcfg))
    losses = []
    for i in range(jf.train_steps):
        state, m = step(state, {"tokens": jnp.asarray(pipe.batch(i))})
        losses.append(float(m["loss"]))
    return init, state["params"], losses


@pytest.mark.parametrize("heads", [1, 4])
def test_train_sae_matches_jax(harvests, heads):
    jd = harvests[0]
    jf = JF.SAEFactoryConfig(**FCFG, heads=heads)
    tf = TF.SAEFactoryConfig(**FCFG, heads=heads)
    init, jparams_, jlosses = _jax_train(jd, 2, jf, seed=1)
    out = TF.train_sae(jd, 2, tf, seed=1, device="cpu",
                       params=interop.from_numpy_tree(init, device="cpu"))
    np.testing.assert_allclose(out["losses"], jlosses, rtol=1e-5)
    assert out["losses"][-1] < out["losses"][0]
    _assert_close(out["params"], jparams_, 1e-5)
    spec = TF.sae_projection_spec(tf)
    from repro.optim.projection_hook import tree_sparsity as jsparsity
    want = {k: float(v) for k, v in jsparsity(
        jparams_, JF.sae_projection_spec(jf)).items()}
    assert out["sparsity"] == want
    assert out["metrics"]["loss"] == pytest.approx(jlosses[-1], rel=1e-5)
    jdiag = jsae.dict_metrics(jparams_, jnp.asarray(JF.DataPipeline(JF.DataConfig(
        vocab=1, seq_len=0, global_batch=jf.sae_batch, microbatch=jf.microbatch,
        activation_dir=str(jd), activation_layer=2)).batch(0)).reshape(-1, 64))
    for k, v in jdiag.items():
        assert out["metrics"][k] == pytest.approx(float(v), rel=1e-4, abs=1e-6), k
    assert out["dictionary"].shape == (64, 64 * FCFG["expansion"])
    rep = TF.constraint_report(out["params"], spec)
    assert rep["max_violation"] <= 1e-5 * spec.radius
    jrep = JF.constraint_report(jparams_, JF.sae_projection_spec(jf))
    assert rep["norms"] == pytest.approx(jrep["norms"], rel=1e-5)


def test_sae_forward_and_losses_match_jax():
    rng = np.random.default_rng(4)
    tmpl = jsae.dict_template(16, 32, heads=4)
    p = jax.tree_util.tree_map(
        lambda d: rng.normal(size=d.shape).astype(np.float32), tmpl,
        is_leaf=jparams.is_def)
    x = rng.normal(size=(5, 16)).astype(np.float32)
    tp = interop.from_numpy_tree(p, device="cpu")
    assert float(tsae.dict_loss(tp, torch.from_numpy(x), l1=0.1)) == pytest.approx(
        float(jsae.dict_loss(p, jnp.asarray(x), l1=0.1)), rel=1e-6)
    # the supervised AE of §7.3
    from repro.configs import registry as jreg
    cfg = jreg.smoke_config("sae-paper")
    sp = jparams.init_params(jsae.template(cfg), jax.random.PRNGKey(0))
    xs = rng.normal(size=(6, cfg.d_model)).astype(np.float32)
    ys = rng.integers(0, cfg.vocab, 6).astype(np.int32)
    jl, jaux = jsae.loss_fn(sp, {"x": jnp.asarray(xs), "y": jnp.asarray(ys)}, cfg)
    tl, taux = tsae.loss_fn(_to_torch(sp), {"x": torch.from_numpy(xs),
                                            "y": torch.from_numpy(ys)}, cfg)
    assert float(tl) == pytest.approx(float(jl), rel=1e-6)
    assert float(taux["ce"]) == pytest.approx(float(jaux["ce"]), rel=1e-6)


# --------------------------------------------------------------------- MMCS
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mmcs_matches_jax(seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(12, 9)).astype(np.float32)
    b = rng.normal(size=(12, 7)).astype(np.float32)
    b[:, 2] = 0.0   # a dead feature matches nothing
    assert float(tmmcs(a, b)) == pytest.approx(float(jmmcs(a, b)), abs=1e-6)
    assert float(tmmcs_sym(torch.from_numpy(a), torch.from_numpy(b))) == \
        pytest.approx(float(jmmcs_sym(a, b)), abs=1e-6)
    assert float(tmmcs(a, a)) == pytest.approx(1.0, abs=1e-6)
    t = tmmcs_table({"a": a, "b": b})
    assert t[("a", "b")] == pytest.approx(jmmcs_table({"a": a, "b": b})[("a", "b")],
                                          abs=1e-6)


# ---------------------------------------------------------------- the whole
def test_cli_runs_on_cpu(tmp_path, capsys):
    rc = tcli.main(["--out", str(tmp_path), "--layers", "1", "--harvest-steps",
                    "2", "--train-steps", "3", "--heads", "2", "--seeds", "0,1",
                    "--device", "cpu"])
    assert rc == 0
    summary = json.loads((tmp_path / "summary.json").read_text())
    rec = summary["layers"]["1"]
    assert set(rec["mmcs"]) == {"seed0_vs_seed1"}
    assert 0.0 < rec["mmcs"]["seed0_vs_seed1"] <= 1.0 + 1e-6
    assert all(c["feasible"] for c in rec["constraint"].values())
    assert all(np.isfinite(rec["losses"][s]).all() for s in rec["losses"])
    assert (tmp_path / "metrics.jsonl").exists()
    assert "layer 1: mmcs=" in capsys.readouterr().out


def test_run_factory_on_cpu_matches_its_parts(tmp_path):
    tf = TF.SAEFactoryConfig(**dict(FCFG, layers=(1,), harvest_steps=2,
                                    train_steps=3))
    out = TF.run_factory(tf, tmp_path, seeds=(0, 1), device="cpu")
    rec = out["layers"][1]
    again = TF.train_sae(tmp_path, 1, tf, seed=1, device="cpu")
    assert rec["losses"][1] == again["losses"]
    assert rec["metrics"][1] == again["metrics"]
    assert out["meta"]["layers"] == [1]
