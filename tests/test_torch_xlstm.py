"""Parity of the port's SSM family (``repro_torch/models/xlstm.py``) with
the JAX package's, on the CPU, at the smoke widths of ``xlstm-1.3b`` (8
layers: 2 super-blocks of 3 mLSTM and 1 sLSTM; d_model 64, 4 heads, mLSTM
heads of 32 after the up-projection by 2, sLSTM heads of 16; chunk 8).

Parameters are drawn in numpy from the JAX template's init statistics and
handed to JAX as arrays and to the port with ``interop.from_numpy_tree``;
inputs come from seeded numpy generators. Tolerances: float32 outputs,
states and gradients within 1e-5 of the largest entry (sums in another
order); three train steps with losses and gradient norms at
``tests/test_torch_train.py``'s float32 bars and parameters at
``tests/test_torch_moe.py``'s (``_torch_recurrent.train_parity``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_recurrent import (assert_close_tree, setup, sharded_loss_on_meta,
                              template_shapes, train_parity)
from repro.models import params as jparams
from repro.models import xlstm as jx
from repro.serving import lm as jserve
from repro_torch import _tree
from repro_torch import models as tmodels
from repro_torch.configs import registry as treg
from repro_torch.core.multilevel import multilevel_norm
from repro_torch.data import DataConfig, DataPipeline
from repro_torch.data.activations import harvest
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import lm as tlm
from repro_torch.models import params as tparams
from repro_torch.models import xlstm as tx
from repro_torch.serving import lm as tserve

ARCH = "xlstm-1.3b"
SEED = 12
REL = 1e-5


def _close(got, want, rel=REL, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(
        got.detach().numpy(), want, rtol=0,
        atol=rel * float(np.abs(want).max()), err_msg=what)


def _close_state(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, what=f"{what} state {i}")


# ------------------------------------------------------------- the template
def test_template_interop_and_api():
    cfg, jp, tcfg, tp = setup(ARCH, SEED)
    tt = tx.template(tcfg)
    assert template_shapes(tt, tparams.is_def) == template_shapes(
        jx.template(cfg), jparams.is_def)
    assert tparams.count_params(tt) == jparams.count_params(jx.template(cfg))
    assert_close_tree(tp, jp, 0.0)
    assert tp["mlstm"]["w_gates"].shape == (2, 3, 128, 8)
    assert tp["slstm"]["r"].shape == (2, 4, 4, 16, 16)
    api = tmodels.get(tcfg)
    assert (api.template, api.forward, api.decode_step) == (
        tx.template, tx.forward, tx.decode_step)
    # the SSM family's make_cache is make_state, whatever the length
    st = api.make_cache(tcfg, 3, 1000, dtype=torch.bfloat16, device="cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in st.items()} == {
        k: (v.shape, torch.float32) for k, v in jx.make_state(cfg, 3).items()}
    assert float(st["mlstm_m"].max()) == float(st["slstm_m"].max()) == float(
        np.float32(-1e30))
    # the full config: 2.020 B template parameters (ArchConfig.params_count()
    # reads 2.219 B, ROADMAP § 3 reference item 5)
    assert tparams.count_params(tx.template(treg.get_arch(ARCH))) == 2_019_633_152


# -------------------------------------------------------------------- mLSTM
def _mlstm_inputs(s, seed):
    rng = np.random.default_rng(seed)
    b, h, d = 2, 3, 8
    q, k, v = (rng.normal(size=(b, s, h, d)).astype(np.float32) for _ in range(3))
    li = rng.normal(size=(b, s, h)).astype(np.float32)
    lf = np.log(1.0 / (1.0 + np.exp(-rng.normal(size=(b, s, h)) - 2.0))).astype(
        np.float32)
    return q, k, v, li, lf


def test_mlstm_sequential_and_chunkwise_match_jax():
    """13 tokens: the sequential recurrence, then chunks of 5 (the last
    padded) from the state it ends in, each against JAX's; the chunkwise
    form from zeros against the sequential one."""
    q, k, v, li, lf = _mlstm_inputs(13, 1)
    tt = [torch.from_numpy(a) for a in (q, k, v, li, lf)]
    jt = [jnp.asarray(a) for a in (q, k, v, li, lf)]
    jy, jst = jx.mlstm_sequential(*jt)
    ty, tst = tx.mlstm_sequential(*tt)
    _close(ty, jy, what="sequential y")
    _close_state(tst, jst, "sequential")
    jy2, jst2 = jx.mlstm_chunkwise(*jt, chunk=5, state=jst)
    ty2, tst2 = tx.mlstm_chunkwise(*tt, chunk=5, state=tst)
    _close(ty2, jy2, what="chunkwise y")
    _close_state(tst2, jst2, "chunkwise")
    ty3, tst3 = tx.mlstm_chunkwise(*tt, chunk=5)
    _close(ty3, ty.numpy(), rel=1e-4, what="chunkwise vs sequential")
    _close_state(tst3, [a.numpy() for a in tst], "chunkwise vs sequential")


def test_mlstm_chunkwise_grads_match_jax():
    q, k, v, li, lf = _mlstm_inputs(11, 2)
    cot = np.random.default_rng(3).normal(size=q.shape).astype(np.float32)

    def jloss(*a):
        return jnp.sum(jx.mlstm_chunkwise(*a, chunk=4)[0] * cot)

    jg = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in (q, k, v, li, lf)))
    tt = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, li, lf)]
    (tx.mlstm_chunkwise(*tt, chunk=4)[0] * torch.from_numpy(cot)).sum().backward()
    for name, t, w in zip("q k v li lf".split(), tt, jg):
        _close(t.grad, w, what=f"grad {name}")


def test_slstm_block_from_zeros_and_from_a_state_matches_jax():
    cfg, jp, tcfg, tp = setup(ARCH, SEED)
    jl = jax.tree_util.tree_map(lambda a: a[1], jp["slstm"])
    tl = _tree.tree_map(lambda a: a[1], tp["slstm"])
    x = np.random.default_rng(4).normal(size=(2, 9, cfg.d_model)).astype(
        np.float32)
    jy, jst = jx._slstm_block(jl, jnp.asarray(x[:, :5]), cfg)
    with torch.no_grad():
        ty, tst = tx._slstm_block(tl, torch.from_numpy(x[:, :5]), tcfg)
        _close(ty, jy, what="y")
        _close_state(tst, jst, "sLSTM")
        jy, jst = jx._slstm_block(jl, jnp.asarray(x[:, 5:]), cfg, state=jst)
        ty, tst = tx._slstm_block(tl, torch.from_numpy(x[:, 5:]), tcfg, state=tst)
    _close(ty, jy, what="y from a state")
    _close_state(tst, jst, "sLSTM from a state")


# -------------------------------------------------------------------- model
def test_forward_matches_jax_and_the_sequential_mode():
    """20 tokens over chunks of 8 (a ragged last chunk)."""
    cfg, jp, tcfg, tp = setup(ARCH, SEED)
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (2, 20)).astype(
        np.int32)
    jl, jaux = jx.forward(jp, jnp.asarray(toks), cfg, remat=False)
    with torch.no_grad():
        tl, taux = tx.forward(tp, torch.from_numpy(toks), tcfg, remat=False)
        seq, _ = tx.forward(tp, torch.from_numpy(toks), tcfg, remat=False,
                            seq_mode="sequential")
    assert tl.shape == (2, 20, cfg.vocab) and taux == jaux == 0.0
    _close(tl, jl, what="logits")
    _close(seq, jl, rel=1e-4, what="sequential logits")
    with pytest.raises(ValueError, match="seq_mode"):
        tx.forward(tp, torch.from_numpy(toks), tcfg, seq_mode="parallel")


def test_state_and_six_decode_steps_match_jax():
    cfg, jp, tcfg, tp = setup(ARCH, SEED)
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (2, 6)).astype(np.int32)
    jst = jx.make_state(cfg, 2)
    tst = tx.make_state(tcfg, 2, device="cpu")
    jstep = jax.jit(lambda p, t, s, pos: jx.decode_step(p, t, s, pos, cfg))
    with torch.no_grad():
        for i in range(6):
            jlg, jst = jstep(jp, jnp.asarray(toks[:, i]), jst, jnp.int32(i))
            tlg, tst = tx.decode_step(tp, torch.from_numpy(toks[:, i]), tst, i,
                                      tcfg)
            _close(tlg, jlg, what=f"step {i} logits")
        assert_close_tree(tst, jst, REL, "state")
        full, _ = tx.forward(tp, torch.from_numpy(toks), tcfg, remat=False)
    _close(tlg, full[:, -1].numpy(), rel=1e-4, what="decode vs forward")


def test_generate_and_prefill_match_jax():
    cfg, jp, tcfg, tp = setup(ARCH, SEED)
    prompt = np.random.default_rng(7).integers(0, cfg.vocab, (2, 5)).astype(
        np.int32)
    want = np.asarray(jserve.generate(jp, cfg, jnp.asarray(prompt), 4))
    got = tserve.generate(tp, tcfg, torch.from_numpy(prompt), 4)
    np.testing.assert_array_equal(got.numpy(), want)
    jpre = jserve.make_prefill(cfg, jx)(jp, jnp.asarray(prompt))
    tpre = tserve.make_prefill(tcfg, tmodels.get(tcfg), impl="flash")(
        tp, torch.from_numpy(prompt))
    _close(tpre, jpre, what="prefill")


# ----------------------------------------------------------------- training
def test_three_projected_train_steps_match_jax():
    """JAX's ``make_train_step`` with the bi-level projection on
    ``(w_up|w_gate|w_in)``, which ``re.search`` also finds in mLSTM's
    ``w_gates``: the 4-D ``mlstm/w_up`` (2, 3, 64, 256) and ``mlstm/w_gates``
    (2, 3, 128, 8), and the sLSTM's ``w_in`` and ``w_up``; 20-token rows,
    so the last chunk pads. The radius binds on every slice at its first
    projection, the 8-column ``w_gates`` (l1,inf norm about 0.8) included."""
    radius = 0.05
    ts = train_parity(ARCH, SEED, radius, seq=20)
    params = ts["params"]
    for leaf in (params["mlstm"]["w_up"], params["mlstm"]["w_gates"],
                 params["slstm"]["w_in"], params["slstm"]["w_up"]):
        slices = leaf.reshape(-1, *leaf.shape[-2:])
        norms = [float(multilevel_norm(w, [("inf", 1), (1, 1)])) for w in slices]
        assert max(norms) <= radius * (1 + 1e-5)
        # some columns zero in each leaf (after a zeroing, AdamW's next
        # update moves every entry by about lr, so a slice's columns may all
        # come back small and non-zero)
        cols = slices.abs().amax(dim=1)
        assert 0 < int((cols == 0).sum()) < cols.numel()


# ------------------------------------------------------------ the launchers
def test_train_and_serve_cli_on_cpu(capsys):
    out = train_cli.run(["--device", "cpu", "--smoke", "--arch", ARCH,
                         "--steps", "2", "--seq", "12", "--batch", "4",
                         "--radius", "2.0"])
    text = capsys.readouterr().out
    assert "attention: none; a ssm model takes no --attn (flash not used)" in text
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    assert {"mlstm/w_up", "mlstm/w_gates", "slstm/w_in", "slstm/w_up"} <= set(
        out["sparsity"])
    res = serve_cli.run(["--device", "cpu", "--smoke", "--arch", ARCH,
                         "--batch", "2", "--prompt-len", "4", "--new", "3",
                         "--layers", "4"])
    assert res["cfg"].n_layers == 4 and res["tokens"].shape == (2, 3)


def test_refusals(tmp_path):
    """A cut below one super-block and a harvest each raise by name. A 1x2
    launch passes the family's gate and stops only where it needs a world
    of two ranks, and the sharded loss runs on one rank of an abstract 2x2
    mesh with the model's collectives (the 2x2 launch itself:
    ``tests/test_torch_train_mesh_families.py``)."""
    for cli in (serve_cli.run, train_cli.run):
        with pytest.raises(ValueError, match="leave no xLSTM super-block"):
            cli(["--device", "cpu", "--smoke", "--arch", ARCH, "--layers", "3"])
    with pytest.raises(ValueError, match="cut to at least 8"):
        tlm.cut_depth(treg.get_arch(ARCH), 7)
    assert tlm.cut_depth(treg.get_arch(ARCH), 16).n_layers == 16
    with pytest.raises(ValueError, match="torchrun"):
        train_cli.run(["--device", "cpu", "--smoke", "--arch", ARCH,
                       "--mesh", "1x2"])
    got, want = sharded_loss_on_meta(ARCH)
    assert got == want and got["psum"] > 0
    _, _, tcfg, tp = setup(ARCH, SEED)
    pipe = DataPipeline(DataConfig(vocab=tcfg.vocab, seq_len=8, global_batch=2,
                                   microbatch=2))
    with pytest.raises(ValueError, match="ssm family's forward collects none"):
        harvest(tp, tcfg, pipe, tmp_path, forward=tx.forward)
    assert not any(tmp_path.iterdir())
