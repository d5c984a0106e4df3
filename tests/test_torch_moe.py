"""Parity of the port's MoE family (``repro_torch.models.layers.moe_apply``,
the ``dense_blocks``/``moe_blocks`` stacks of ``models.lm``, the train
step and the launchers on an MoE arch) with the JAX package's, on the CPU,
at the smoke widths of ``deepseek-v3-671b`` and ``kimi-k2-1t-a32b`` (4
layers, the first dense; 8 experts, top-2, one shared; MLA heads of 16
nope + 8 rope and v 16).

Parameters are drawn in numpy from the JAX template's init statistics (a
seed per arch), handed to JAX as arrays and to the port with
``interop.from_numpy_tree``; inputs come from a seeded numpy generator. Routing is discrete, so it is held first and
exactly: the experts each (token, slot) picks (``top_i``) and which slots
are kept (``keep``), with capacity binding (the dropped count is asserted
above 0). Then, in float32 (sums in another order): ``moe_apply``'s output
and aux within 1e-6 · max|out|, its gradients within 1e-5 of each
gradient's largest entry; the forward's logits and collected activations
within 2e-5, aux within 1e-6 relative; the projection of the 4-D expert
leaves within 1e-6 · max|w|; three train steps' losses and gradient norms
within 1e-5 relative and parameters within 5e-5 of each leaf's largest
entry plus 1e-5 relative (a few gradient entries sit near AdamW's eps,
where float32 rounding moves the update most; 1.9e-5 measured, against a
step of lr = 3e-4).
"""

import dataclasses
import gc
import json
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.configs import registry as jreg
from repro.configs import types as jtypes
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.models import params as jparams
from repro.optim import adamw as jadamw
from repro.optim import projection_hook as jhook
from repro.training import step as jstep
from repro_torch import _tree, interop
from repro_torch import models as tmodels
from repro_torch.configs import registry as treg
from repro_torch.configs import types as ttypes
from repro_torch.core.multilevel import multilevel_norm
from repro_torch.data import DataConfig, DataPipeline
from repro_torch.launch import sae_factory as factory_cli
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.models import params as tparams
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import projection_hook as thook
from repro_torch.training import step as tstep

ARCHS = ["deepseek-v3-671b", "kimi-k2-1t-a32b"]
KEYS = {"deepseek-v3-671b": 0, "kimi-k2-1t-a32b": 1}
_CACHE = {}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def numpy_params(template, seed):
    """A parameter tree drawn in numpy with ``init_params``' statistics
    (ones, zeros, normal of ``scale``, ``scaled`` = 1/sqrt of every axis
    but the last), leaves in sorted-path order."""
    rng = np.random.default_rng(seed)
    flat, tree = jax.tree_util.tree_flatten_with_path(
        template, is_leaf=jparams.is_def)
    out = []
    for _, pd in flat:
        if pd.init in ("ones", "zeros"):
            out.append((np.ones if pd.init == "ones" else np.zeros)(
                pd.shape, np.float32))
            continue
        std = (max(np.prod(pd.shape[:-1]), 1) ** -0.5
               if pd.init == "scaled" else pd.scale)
        out.append((rng.standard_normal(pd.shape) * std).astype(np.float32))
    return jax.tree_util.tree_unflatten(tree, out)


def _setup(arch):
    """(JAX cfg, JAX params, port cfg, port params), made once per arch."""
    if arch not in _CACHE:
        cfg = jreg.smoke_config(arch)
        params = numpy_params(jlm.template(cfg), KEYS[arch])
        jp = jax.tree_util.tree_map(jnp.asarray, params)
        tp = interop.from_numpy_tree(params, device="cpu")
        _CACHE[arch] = (cfg, jp, treg.smoke_config(arch), tp)
    return _CACHE[arch]


def _get(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _jax_route(p, x, cfg, n_groups):
    """``top_i`` and ``keep`` as ``repro/models/layers.py:253-272`` makes
    them (the JAX function returns neither)."""
    tkns, m = x.shape
    e, k = cfg.n_experts, cfg.top_k
    g = np.gcd(n_groups, tkns)
    tg = tkns // g
    cap = int(max(1, np.ceil(tg * k / e * cfg.capacity_factor)))
    probs = jax.nn.softmax(x.reshape(g, tg, m).astype(jnp.float32)
                           @ p["router"].astype(jnp.float32), axis=-1)
    _, top_i = jax.lax.top_k(probs, k)
    onehot = jax.nn.one_hot(top_i, e, dtype=jnp.float32)
    flat = onehot.reshape(g, tg * k, e)
    pos = jnp.sum((jnp.cumsum(flat, axis=1) - flat).reshape(g, tg, k, e)
                  * onehot, axis=-1)
    return np.asarray(top_i), np.asarray(pos < cap), cap


# ------------------------------------------------------------------ moe_apply
def _moe_inputs(arch, layer=1, tokens=48, seed=5):
    cfg, jp, _, tp = _setup(arch)
    jm = jax.tree_util.tree_map(lambda a: a[layer], jp["moe_blocks"]["mlp"])
    tm = _tree.tree_map(lambda a: a[layer].clone(), tp["moe_blocks"]["mlp"])
    x = np.random.default_rng(seed).normal(
        size=(tokens, cfg.d_model)).astype(np.float32)
    # capacity factor 1: 6 slots an expert for 24 tokens × top-2 / 8
    # experts in each of 2 groups, so the busier experts drop tokens
    mcfg = dataclasses.replace(cfg.moe, capacity_factor=1.0)
    return mcfg, jm, tm, x


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dispatch", ["einsum", "scatter"])
def test_moe_apply_routing_then_values_and_grads_match_jax(arch, dispatch):
    mcfg, jm, tm, x = _moe_inputs(arch)
    mcfg = dataclasses.replace(mcfg, dispatch=dispatch)
    top_i, keep, cap = _jax_route(jm, jnp.asarray(x), mcfg, 2)
    r = tlayers.moe_route(tm, torch.from_numpy(x), mcfg, n_groups=2)
    assert r["cap"] == cap == 6
    np.testing.assert_array_equal(r["top_i"].numpy(), top_i)
    np.testing.assert_array_equal(r["keep"].numpy(), keep)
    assert int((~keep).sum()) > 0, "capacity does not bind"

    cot = np.random.default_rng(6).normal(size=x.shape).astype(np.float32)

    def jloss(p, xx):
        y, aux = jlayers.moe_apply(p, xx, mcfg, n_groups=2)
        return jnp.sum(y * cot) + aux, (y, aux)

    (_, (jy, jaux)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jm, jnp.asarray(x))
    tp = _tree.tree_map(lambda a: a.requires_grad_(), tm)
    tx = torch.from_numpy(x).requires_grad_()
    ty, taux = tlayers.moe_apply(tp, tx, mcfg, n_groups=2)
    (ty * torch.from_numpy(cot)).sum().add(taux).backward()
    scale = float(np.abs(np.asarray(jy)).max())
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), rtol=0,
                               atol=1e-6 * scale)
    np.testing.assert_allclose(float(taux.detach()), float(jaux), rtol=1e-6)
    grads = dict(_tree.leaves_with_paths(_tree.tree_map(lambda a: a.grad, tp)))
    grads["x"] = tx.grad
    want = dict(_tree.leaves_with_paths(_np(jgp)))
    want["x"] = np.asarray(jgx)
    assert sorted(grads) == sorted(want)
    for name, g in grads.items():
        w = want[name]
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_einsum_and_scatter_dispatch_agree(arch):
    """The two dispatches of the port on the same inputs (phase 11 (c) of
    ``chip_smoke.py`` holds them on the card)."""
    mcfg, _, tm, x = _moe_inputs(arch, tokens=64, seed=7)
    out = {}
    for d in ("einsum", "scatter"):
        out[d] = tlayers.moe_apply(tm, torch.from_numpy(x),
                                   dataclasses.replace(mcfg, dispatch=d),
                                   n_groups=1)
    scale = float(out["einsum"][0].abs().max())
    torch.testing.assert_close(out["scatter"][0], out["einsum"][0], rtol=0,
                               atol=1e-6 * scale)
    assert float(out["scatter"][1]) == float(out["einsum"][1])
    with pytest.raises(ValueError, match="dispatch"):
        tlayers.moe_apply(tm, torch.from_numpy(x),
                          dataclasses.replace(mcfg, dispatch="ring"), n_groups=1)


def test_routing_ties_go_to_the_lower_expert():
    """Equal router probabilities: ``jax.lax.top_k`` takes the lower index
    first, and so does the port's stable sort."""
    mcfg = ttypes.MoEConfig(n_experts=8, top_k=3, d_expert=4)
    router = np.zeros((4, 8), np.float32)
    router[0, 5] = router[0, 2] = 1.0        # experts 2 and 5 tie, the rest tie
    x = np.eye(4, dtype=np.float32)[[0, 0, 1, 2]]
    r = tlayers.moe_route({"router": torch.from_numpy(router)},
                          torch.from_numpy(x), mcfg, n_groups=1)
    top_i, _, _ = _jax_route({"router": jnp.asarray(router)}, jnp.asarray(x),
                             mcfg, 1)
    np.testing.assert_array_equal(r["top_i"].numpy(), top_i)
    assert r["top_i"][0, 0].tolist() == [2, 5, 0]
    assert r["top_i"][0, 2].tolist() == [0, 1, 2]


# ------------------------------------------------------------------ the model
@pytest.mark.parametrize("arch", ARCHS)
def test_templates_interop_and_init_statistics(arch):
    cfg, jp, tcfg, tp = _setup(arch)
    shapes = lambda t, isdef: jax.tree_util.tree_map(  # noqa: E731
        lambda d: d.shape, t, is_leaf=isdef)
    tt = tlm.template(tcfg)
    assert shapes(tt, tparams.is_def) == shapes(jlm.template(cfg), jparams.is_def)
    assert set(tt) == {"embed", "final_norm", "unembed", "dense_blocks",
                       "moe_blocks"}
    assert tparams.count_params(tt) == jparams.count_params(jlm.template(cfg))
    # interop carries the nested stacks leaf for leaf
    want = dict(_tree.leaves_with_paths(_np(jp)))
    got = dict(_tree.leaves_with_paths(tp))
    assert sorted(got) == sorted(want)
    for name, t in got.items():
        np.testing.assert_array_equal(t.numpy(), want[name], err_msg=name)
    assert tp["moe_blocks"]["mlp"]["w_up"].shape == (3, 8, 64, 32)
    assert tp["moe_blocks"]["mlp"]["shared"]["w_up"].shape == (3, 64, 32)
    # "scaled": 1/sqrt of every axis but the last, stack and experts included
    p = tparams.init_params(tt, 3, device="cpu")
    w = p["moe_blocks"]["mlp"]["w_up"]
    assert float(w.std()) == pytest.approx(np.prod(w.shape[:-1]) ** -0.5,
                                           rel=0.05)
    assert tmodels.get(tcfg).forward is tlm.forward


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl,site", [("chunked", "resid"), ("naive", "mlp")])
def test_forward_logits_aux_and_collect_match_jax(arch, impl, site,
                                                  monkeypatch):
    cfg, jp, tcfg, tp = _setup(arch)
    toks = np.random.default_rng(KEYS[arch]).integers(
        0, cfg.vocab, (2, 40)).astype(np.int32)
    dropped = []
    route = tlayers.moe_route

    def counting(*a, **k):
        r = route(*a, **k)
        dropped.append(int((~r["keep"]).sum()))
        return r

    monkeypatch.setattr(tlayers, "moe_route", counting)
    jl, ja, jc = jlm.forward(jp, jnp.asarray(toks), cfg, impl=impl,
                             remat=False, collect=site)
    with torch.no_grad():
        tl, ta, tc = tlm.forward(tp, torch.from_numpy(toks), tcfg, impl=impl,
                                 remat=False, collect=site)
    assert tc.shape == (4, 2, 40, cfg.d_model)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=2e-5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=2e-5)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)
    assert len(dropped) == 3 and sum(dropped) > 0, dropped   # 3 MoE layers


def test_loss_fn_adds_the_aux_as_jax_does():
    """0.01 · aux enters the loss (``repro/training/step.py:61-66``), with
    ``n_groups`` reaching the dispatch, under remat (the train steps below
    hold the same loss against JAX's)."""
    _, _, tcfg, tp = _setup(ARCHS[0])
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, tcfg.vocab, (4, 17)))
    got = tstep.make_loss_fn(tcfg, tmodels.get(tcfg), impl="chunked",
                             n_groups=4, remat=True,
                             compute_dtype=torch.float32)(tp, toks)
    with torch.no_grad():
        logits, aux = tlm.forward(tp, toks[:, :-1], tcfg, n_groups=4,
                                  remat=False)
        one, _ = tlm.forward(tp, toks[:, :-1], tcfg, n_groups=1, remat=False)
    assert float(aux) > 0
    assert not torch.equal(logits, one)          # the groups queue apart
    np.testing.assert_allclose(
        float(got), float(tstep.xent(logits, toks[:, 1:]) + 0.01 * aux),
        rtol=1e-6)


def test_projection_of_expert_leaves_matches_jax():
    """The hook treats the leading (layers, experts) axes of the 4-D expert
    leaves as batch axes, as JAX's vmap does."""
    _, jp, _, tp = _setup(ARCHS[1])
    spec_j = jtypes.ProjectionSpec(pattern=r"moe_blocks/mlp/(w_up|w_gate)",
                                   radius=0.5)
    spec_t = ttypes.ProjectionSpec(pattern=r"moe_blocks/mlp/(w_up|w_gate)",
                                   radius=0.5)
    want = _np(jhook.project_tree(jp, spec_j))
    got = thook.project_tree(tp, spec_t)
    for leaf in ("w_up", "w_gate"):
        w = want["moe_blocks"]["mlp"][leaf]
        g = got["moe_blocks"]["mlp"][leaf]
        assert g.shape == (3, 8, 64, 32)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-6 * float(np.abs(w).max()))
        norms = [float(multilevel_norm(x, [("inf", 1), (1, 1)]))
                 for x in g.reshape(-1, 64, 32)]
        assert max(norms) <= 0.5 * (1 + 1e-5)
    assert torch.equal(got["moe_blocks"]["mlp"]["shared"]["w_up"],
                       tp["moe_blocks"]["mlp"]["shared"]["w_up"])


def test_three_train_steps_with_projected_experts_match_jax():
    """``make_train_step`` against JAX's with no mesh (ROADMAP § 3,
    reference side item 3), ``n_groups=2``, the bi-level projection on
    every ``w_up``/``w_gate``: the dense stack's, the 4-D experts' and the
    shared experts'. On deepseek-v3's smoke config, whose shapes kimi-k2's
    shares (the train CLI below runs kimi-k2)."""
    arch = ARCHS[0]
    cfg, jp0, tcfg, tp0 = _setup(arch)
    kw = dict(microbatch=2, lr=3e-4, total_steps=3, warmup=1, remat=False,
              master_dtype="", compute_dtype="float32")
    radius = 0.5
    jt = jtypes.TrainConfig(**kw, projection=jtypes.ProjectionSpec(
        pattern=r"(w_up|w_gate)", radius=radius))
    tt = ttypes.TrainConfig(**kw, projection=ttypes.ProjectionSpec(
        pattern=r"(w_up|w_gate)", radius=radius))
    japi = jmodels.get(cfg)
    js = {"params": jp0, "opt": jadamw.init(jp0, jt)}
    tparams_ = _tree.tree_map(torch.clone, tp0)
    ts = {"params": tparams_, "opt": tadamw.init(tparams_, tt)}
    jfn = jax.jit(jstep.make_train_step(cfg, jt, japi, impl="chunked",
                                        n_groups=2))
    tfn = tstep.make_train_step(tcfg, tt, tmodels.get(tcfg), impl="chunked",
                                n_groups=2)
    pipe = DataPipeline(DataConfig(vocab=cfg.vocab, seq_len=25,
                                   global_batch=4, microbatch=2))
    for i in range(3):
        batch = pipe.batch(i)
        js, jm = jfn(js, {"tokens": jnp.asarray(batch)})
        ts, tm = tfn(ts, {"tokens": torch.from_numpy(batch)})
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                       err_msg=f"step {i + 1} {k}")
        jp = _np(js["params"])
        for name, t in _tree.leaves_with_paths(ts["params"]):
            w = _get(jp, name)
            np.testing.assert_allclose(
                t.numpy(), w, rtol=1e-5, atol=5e-5 * float(np.abs(w).max()),
                err_msg=f"step {i + 1} {name}")
    # the constraint binds on the 4-D expert leaves: each (layer, expert)
    # slice on the ball, some of its columns zero
    for leaf in ("w_up", "w_gate"):
        w = ts["params"]["moe_blocks"]["mlp"][leaf]
        norms = [float(multilevel_norm(x, [("inf", 1), (1, 1)]))
                 for x in w.reshape(-1, 64, 32)]
        assert max(norms) <= radius * (1 + 1e-5)
        cols = w.abs().amax(dim=2)                        # (L, E, f)
        assert 0 < int((cols == 0).sum()) < cols.numel()


# ------------------------------------------------------------- the launchers
def test_train_cli_on_moe_arch(capsys):
    out = train_cli.run(["--device", "cpu", "--smoke", "--arch", ARCHS[1],
                         "--attn", "chunked", "--steps", "2", "--seq", "16",
                         "--batch", "4", "--radius", "0.5"])
    text = capsys.readouterr().out
    assert "step     2 loss" in text
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    assert "moe_blocks/mlp/w_up" in out["sparsity"]
    assert out["state"]["params"]["moe_blocks"]["mlp"]["w_up"].shape == (
        3, 8, 64, 32)


def test_sae_factory_cli_harvests_an_moe_lm(tmp_path, capsys):
    rc = factory_cli.main(["--device", "cpu", "--arch", ARCHS[1], "--attn",
                           "chunked", "--out", str(tmp_path), "--layers", "1,3",
                           "--harvest-steps", "1", "--train-steps", "3",
                           "--seeds", "0"])
    assert rc == 0
    summary = json.loads((tmp_path / "summary.json").read_text())
    assert summary["meta"]["arch"] == ARCHS[1] + "-smoke"
    assert summary["meta"]["layers"] == [1, 3]
    for rec in summary["layers"].values():
        assert all(c["feasible"] for c in rec["constraint"].values())
        assert all(np.isfinite(rec["losses"]["0"]))
    assert "layer 3: mmcs=" in capsys.readouterr().out


def test_harvest_frees_the_lm_on_return(tmp_path, monkeypatch):
    """The LM's weights die when ``harvest_activations`` returns, with no
    garbage collection pass: nothing the forward made (its per-layer views
    of the stacked weights) sits in a reference cycle. At full width they
    are 60 GB that the SAE steps need (``chip_smoke.py`` phase 11 (d))."""
    from repro_torch.training import sae_factory as F

    made = []
    init = F.PM.init_params

    def recording(*a, **k):
        p = init(*a, **k)
        made.extend(weakref.ref(t) for t in _tree.leaves(p))
        return p

    monkeypatch.setattr(F.PM, "init_params", recording)
    fcfg = F.SAEFactoryConfig(arch=ARCHS[0], layers=(3,), harvest_steps=1,
                              seq_len=8, lm_batch=2)
    gc.disable()
    try:
        F.harvest_activations(fcfg, tmp_path, device="cpu", impl="chunked")
        alive = sum(r() is not None for r in made)
    finally:
        gc.enable()
    assert made and alive == 0


def test_refusals(tmp_path):
    """No silent fallback: flash on MLA, a depth cut that leaves no MoE
    layer, and a sharded MoE forward whose dispatch groups do not split
    over the batch's slices each raise. A sharded MoE forward runs: on a
    (2, 2) abstract mesh, with one token group a data rank (JAX's
    ``n_groups = dp_shards``), it gives this rank's logits (its half of
    the vocabulary), and its collectives forward are those that
    ``sharded_collectives`` counts forward."""
    from repro_torch.parallel import sharding
    from repro_torch.parallel.mesh import AbstractMesh

    cfg, _, tcfg, tp = _setup(ARCHS[0])
    toks = torch.zeros(1, 4, dtype=torch.int64)
    with pytest.raises(ValueError, match=r"q/k heads are 24 wide .* v heads "
                       r"16.*impl='chunked'"):
        tlm.forward(tp, toks, tcfg, impl="flash")
    mesh = AbstractMesh((2, 2), ("data", "model"))
    specs = tparams.param_specs(tlm.template(tcfg), sharding.param_rules(mesh),
                                mesh.shape)
    shards = _tree.tree_map(
        lambda x, sp: torch.empty(sharding.local_shape(x.shape, sp, mesh),
                                  device="meta"), tp, specs)
    meta_toks = torch.zeros(1, 4, dtype=torch.int64, device="meta")
    logits, aux = tlm.forward(shards, meta_toks, tcfg, n_groups=2, remat=False,
                              mesh=mesh, param_specs=specs)
    assert logits.shape == (1, 4, tcfg.vocab // 2) and aux.shape == ()
    fwd = mesh.counts()["by_op"]
    model = tlm.sharded_collectives(tcfg, specs, mesh, 1, 4, remat=False,
                                    itemsize=4)
    assert fwd["all_gather"] == {"calls": model["calls"]["all_gather"],
                                 "bytes": model["bytes"]["all_gather"]}
    with pytest.raises(ValueError, match=r"1 token groups do not split over "
                       r"the 2 slices"):
        tlm.forward(shards, meta_toks, tcfg, n_groups=1, mesh=mesh,
                    param_specs=specs)
    full = dataclasses.replace(tcfg, mla=treg.get_arch(ARCHS[0]).mla)
    with pytest.raises(ValueError, match=r"192 wide \(128 nope \+ 64 rope\) "
                       r"and its v heads 128"):
        tlm.forward(tp, toks, full, impl="flash")
    for cli in (serve_cli.run, train_cli.run):
        with pytest.raises(ValueError, match="leave no MoE layer"):
            cli(["--device", "cpu", "--smoke", "--arch", ARCHS[0],
                 "--layers", "1"])
    with pytest.raises(ValueError, match="leave no MoE layer"):
        tlm.cut_depth(treg.get_arch(ARCHS[0]), 3)
    cut = tlm.cut_depth(treg.get_arch(ARCHS[0]), 4)
    assert (cut.n_layers, cut.moe.first_dense) == (4, 3)
    assert [s[1:] for s in tlm.stacks(cut)] == [(False, 3), (True, 1)]
    with pytest.raises(ValueError, match="flash kernels"):
        factory_cli.main(["--device", "cpu", "--arch", ARCHS[1], "--out",
                          str(tmp_path), "--harvest-steps", "1"])
