"""Parity of the port's hybrid family (``repro_torch.models.layers``'
Mamba2 and ``models/zamba.py``) with the JAX package's, on the CPU, at the
smoke widths of ``zamba2-7b`` (7 layers: 2 super-groups of 2 Mamba2 layers
and a shared attention application, then 1 trailing layer; d_model 64,
8 SSM heads of 16 over n_groups=2 groups, d_state 16, chunk 16; 4
attention heads of 16).

Parameters are drawn in numpy from the JAX template's init statistics and
handed to JAX as arrays and to the port with ``interop.from_numpy_tree``;
inputs come from seeded numpy generators. Tolerances: float32 outputs,
states and gradients within 1e-5 of the largest entry (sums in another
order); three train steps with losses and gradient norms at
``tests/test_torch_train.py``'s float32 bars and parameters at
``tests/test_torch_moe.py``'s (``_torch_recurrent.train_parity`` says why).

The SSD's intra-chunk decay departs from the JAX package on purpose: the
port masks before the ``exp`` (``repro_torch/models/layers.py``,
``_ssd_chunked``), so at zamba2-7b's chunk of 128 its dt-gradient is finite
where JAX's is NaN; both are held here against the token-by-token
recurrence.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_recurrent import (assert_close_tree, setup, sharded_loss_on_meta,
                              template_shapes, train_parity)
from repro.models import layers as jlayers
from repro.models import zamba as jzamba
from repro.models import params as jparams
from repro.serving import lm as jserve
from repro_torch import _tree
from repro_torch import models as tmodels
from repro_torch.configs import registry as treg
from repro_torch.core.multilevel import multilevel_norm
from repro_torch.launch import sae_factory as factory_cli
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.models import params as tparams
from repro_torch.models import zamba as tzamba
from repro_torch.serving import lm as tserve

ARCH = "zamba2-7b"
SEED = 11
REL = 1e-5


def _close(got, want, rel=REL, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(
        got.detach().numpy(), want, rtol=0,
        atol=rel * float(np.abs(want).max()), err_msg=what)


def _windowed(cfg):
    """The smoke config with its shared attention windowed from 16 tokens
    on, to a window of 8 (a ring of 8 slots at decode)."""
    return dataclasses.replace(cfg, hybrid=dataclasses.replace(
        cfg.hybrid, long_seq=16, window_at_long=8))


# ------------------------------------------------------------- the template
def test_template_interop_and_api():
    cfg, jp, tcfg, tp = setup(ARCH, SEED)
    tt = tzamba.template(tcfg)
    assert template_shapes(tt, tparams.is_def) == template_shapes(
        jzamba.template(cfg), jparams.is_def)
    assert tparams.count_params(tt) == jparams.count_params(jzamba.template(cfg))
    # interop carries the double stacks leaf for leaf
    assert_close_tree(tp, jp, 0.0)
    assert tp["mamba_super"]["w_in"].shape == (2, 2, 64, 328)
    assert tp["mamba_trailing"]["w_in"].shape == (1, 64, 328)
    api = tmodels.get(tcfg)
    assert (api.template, api.forward, api.make_cache, api.decode_step) == (
        tzamba.template, tzamba.forward, tzamba.make_cache, tzamba.decode_step)
    # the full config: 5.79 B template parameters (ArchConfig.params_count()
    # reads 19.03 B, ROADMAP § 3 reference item 5)
    full = treg.get_arch(ARCH)
    assert tparams.count_params(tzamba.template(full)) == 5_793_843_520
    # a cut to a multiple of attn_every leaves an empty trailing stack
    cut = tlm.cut_depth(full, 12)
    t = tzamba.template(cut)
    assert t["mamba_super"]["w_in"].shape == (2, 5, 3584, 14704)
    assert t["mamba_trailing"]["w_in"].shape == (0, 3584, 14704)
    assert tlm.cut_depth(full, 1).n_layers == 1


# ------------------------------------------------------------------- mamba2
def _mamba_inputs(seq, seed):
    cfg, jp, tcfg, tp = setup(ARCH, SEED)
    jl = jax.tree_util.tree_map(lambda a: a[1, 0], jp["mamba_super"])
    tl = _tree.tree_map(lambda a: a[1, 0].clone(), tp["mamba_super"])
    x = np.random.default_rng(seed).normal(size=(2, seq, cfg.d_model)).astype(
        np.float32)
    return cfg, jl, tl, x


def test_mamba2_apply_chunked_with_a_ragged_pad_and_its_grads_match_jax():
    """21 tokens over chunks of 16: the second chunk is padded. Heads 0-3
    read B/C group 0 and heads 4-7 group 1 (``repeat_interleave``)."""
    cfg, jl, tl, x = _mamba_inputs(21, 3)
    cot = np.random.default_rng(4).normal(size=x.shape).astype(np.float32)

    def jloss(p, xx):
        y, _ = jlayers.mamba2_apply(p, xx, cfg.ssm)
        return jnp.sum(y * cot), y

    (_, jy), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jl, jnp.asarray(x))
    tp = _tree.tree_map(lambda a: a.requires_grad_(), tl)
    tx = torch.from_numpy(x).requires_grad_()
    ty, st = tlayers.mamba2_apply(tp, tx, cfg.ssm)
    assert st is None
    (ty * torch.from_numpy(cot)).sum().backward()
    _close(ty, jy, what="y")
    assert_close_tree(_tree.tree_map(lambda a: a.grad, tp), jgp, REL, "grad")
    _close(tx.grad, jgx, what="grad x")


def test_mamba2_state_form_matches_jax_and_the_chunked_form():
    """Six single-token steps against a (conv, ssm) state: outputs and the
    new states equal JAX's step by step, and the outputs equal the chunked
    form's over the same six tokens."""
    cfg, jl, tl, x = _mamba_inputs(6, 5)
    ssm = cfg.ssm
    di = ssm.expand * cfg.d_model
    conv_shape = (2, ssm.d_conv, di + 2 * ssm.n_groups * ssm.d_state)
    ssm_shape = (2, di // ssm.head_dim, ssm.d_state, ssm.head_dim)
    jst = (jnp.zeros(conv_shape), jnp.zeros(ssm_shape))
    tst = (torch.zeros(conv_shape), torch.zeros(ssm_shape))
    ys = []
    with torch.no_grad():
        for t in range(6):
            jy, jst = jlayers.mamba2_apply(jl, jnp.asarray(x[:, t:t + 1]), ssm,
                                           state=jst)
            ty, tst = tlayers.mamba2_apply(tl, torch.from_numpy(x[:, t:t + 1]),
                                           ssm, state=tst)
            _close(ty, jy, what=f"step {t} y")
            _close(tst[0], jst[0], what=f"step {t} conv")
            _close(tst[1], jst[1], what=f"step {t} ssm")
            ys.append(ty)
        full, _ = tlayers.mamba2_apply(tl, torch.from_numpy(x), ssm)
    torch.testing.assert_close(torch.cat(ys, dim=1), full, rtol=0,
                               atol=REL * float(full.abs().max()))


def _recurrence(x, dt, A, B, C):
    """The SSD token by token: h_t = h_{t-1}·exp(dt_t·A) + dt_t·B_t⊗x_t,
    y_t = C_t·h_t. Every exponent is dt·A <= 0."""
    b, s, h, p = x.shape
    rep = h // B.shape[2]
    Bh = B.repeat_interleave(rep, dim=2)
    Ch = C.repeat_interleave(rep, dim=2)
    state = torch.zeros(b, h, B.shape[3], p)
    ys = []
    for t in range(s):
        decay = torch.exp(dt[:, t] * -torch.exp(A))
        state = state * decay[..., None, None] + (
            dt[:, t, :, None, None] * Bh[:, t, :, :, None] * x[:, t, :, None, :])
        ys.append(torch.einsum("bhn,bhnp->bhp", Ch[:, t], state))
    return torch.stack(ys, dim=1)


@pytest.mark.parametrize("dt_value", [0.69, 0.72])
def test_ssd_gradient_at_chunk_128(dt_value):
    """One chunk of 128 tokens with A = -1 and a constant dt: off the
    causal triangle cum_i - cum_j reaches 127·dt, past float32's exp limit
    (88.72) once dt > 0.699. JAX's ``where(causal, exp(li), 0)`` then has a
    NaN dt-gradient; the port masks first, so its gradient stays finite and
    matches the token-by-token recurrence's, and below the limit it equals
    JAX's."""
    rng = np.random.default_rng(8)
    b, s, h, g, n, p = 1, 128, 2, 1, 4, 4
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    B = rng.normal(size=(b, s, g, n)).astype(np.float32)
    C = rng.normal(size=(b, s, g, n)).astype(np.float32)
    cot = rng.normal(size=(b, s, h, p)).astype(np.float32)
    A = np.zeros(h, np.float32)
    dt = np.full((b, s, h), dt_value, np.float32)

    def jloss(dt_):
        y = jlayers._ssd_chunked(jnp.asarray(x), dt_, jnp.asarray(A),
                                 jnp.asarray(B), jnp.asarray(C), chunk=128)
        return jnp.sum(y * cot)

    jg = np.asarray(jax.grad(jloss)(jnp.asarray(dt)))
    tdt = torch.from_numpy(dt).requires_grad_()
    targs = [torch.from_numpy(a) for a in (x, A, B, C)]
    (tlayers._ssd_chunked(targs[0], tdt, *targs[1:], chunk=128)
     * torch.from_numpy(cot)).sum().backward()
    rdt = torch.from_numpy(dt).requires_grad_()
    (_recurrence(targs[0], rdt, *targs[1:]) * torch.from_numpy(cot)).sum().backward()
    assert torch.isfinite(tdt.grad).all()
    _close(tdt.grad, rdt.grad.numpy(), what="port vs recurrence")
    if dt_value == 0.72:
        assert np.isnan(jg).any()
    else:
        assert np.isfinite(jg).all()
        _close(tdt.grad, jg, what="port vs JAX")


# -------------------------------------------------------------------- model
@pytest.mark.parametrize("windowed", [False, True])
def test_forward_matches_jax(windowed):
    """The whole model on 24 tokens (a ragged last chunk), and with the
    shared attention windowed to 8."""
    cfg, jp, tcfg, tp = setup(ARCH, SEED)
    if windowed:
        cfg, tcfg = _windowed(cfg), _windowed(tcfg)
        assert tzamba._window_for(tcfg, 24) == 8
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (2, 24)).astype(
        np.int32)
    jl, jaux = jzamba.forward(jp, jnp.asarray(toks), cfg, remat=False)
    with torch.no_grad():
        tl, taux = tzamba.forward(tp, torch.from_numpy(toks), tcfg, remat=False)
    assert tl.shape == (2, 24, cfg.vocab) and taux == jaux == 0.0
    _close(tl, jl, what="logits")


def test_cache_and_six_decode_steps_match_jax():
    cfg, jp, tcfg, tp = setup(ARCH, SEED)
    jc = jzamba.make_cache(cfg, 2, 8, dtype=jnp.float32)
    tc = tzamba.make_cache(tcfg, 2, 8, dtype=torch.float32, device="cpu")
    assert {k: tuple(v.shape) for k, v in tc.items()} == {
        k: v.shape for k, v in jc.items()}
    assert tc["ssm_super"].dtype == torch.float32
    assert tzamba.make_cache(tcfg, 1, 4, device="cpu")["k"].dtype == torch.bfloat16
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (2, 6)).astype(np.int32)
    jstep = jax.jit(lambda p, t, c, pos: jzamba.decode_step(p, t, c, pos, cfg))
    with torch.no_grad():
        for i in range(6):
            jlg, jc = jstep(jp, jnp.asarray(toks[:, i]), jc, jnp.int32(i))
            tlg, tc = tzamba.decode_step(tp, torch.from_numpy(toks[:, i]), tc, i,
                                         tcfg)
            _close(tlg, jlg, what=f"step {i} logits")
        assert_close_tree(tc, jc, REL, "cache")
        with pytest.raises(ValueError, match="past the cache's 8 slots"):
            tzamba.decode_step(tp, torch.from_numpy(toks[:, 0]), tc, 8, tcfg)


def test_ring_decode_matches_jax_and_the_windowed_forward():
    """A window of 8 over 20 tokens: the cache is a ring of 8 slots written
    at ``pos % 8`` (``max_len`` given, as it must be for a ring), each
    step's logits equal JAX's, and the last equals the windowed forward's."""
    cfg, jp, tcfg, tp = setup(ARCH, SEED)
    cfg, tcfg = _windowed(cfg), _windowed(tcfg)
    toks = np.random.default_rng(9).integers(0, cfg.vocab, (1, 20)).astype(np.int32)
    jc = jzamba.make_cache(cfg, 1, 20, dtype=jnp.float32)
    tc = tzamba.make_cache(tcfg, 1, 20, dtype=torch.float32, device="cpu")
    assert tc["k"].shape[2] == jc["k"].shape[2] == 8
    jstep = jax.jit(lambda p, t, c, pos: jzamba.decode_step(p, t, c, pos, cfg,
                                                           max_len=20))
    with torch.no_grad():
        for i in range(20):
            jlg, jc = jstep(jp, jnp.asarray(toks[:, i]), jc, jnp.int32(i))
            tlg, tc = tzamba.decode_step(tp, torch.from_numpy(toks[:, i]), tc, i,
                                         tcfg, max_len=20)
            _close(tlg, jlg, what=f"step {i} logits")
        full, _ = tzamba.forward(tp, torch.from_numpy(toks), tcfg, remat=False)
    _close(tlg, full[:, -1].numpy(), rel=1e-4, what="ring decode vs forward")


def test_generate_and_prefill_match_jax():
    cfg, jp, tcfg, tp = setup(ARCH, SEED)
    prompt = np.random.default_rng(10).integers(0, cfg.vocab, (2, 5)).astype(
        np.int32)
    want = np.asarray(jserve.generate(jp, cfg, jnp.asarray(prompt), 4))
    got = tserve.generate(tp, tcfg, torch.from_numpy(prompt), 4)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    jpre = jserve.make_prefill(cfg, jzamba)(jp, jnp.asarray(prompt))
    tpre = tserve.make_prefill(tcfg, tmodels.get(tcfg), impl="flash")(
        tp, torch.from_numpy(prompt))
    _close(tpre, jpre, what="prefill")


# ----------------------------------------------------------------- training
def test_three_projected_train_steps_match_jax():
    """JAX's ``make_train_step`` (no mesh: ROADMAP § 3 reference item 3)
    with the bi-level projection on ``(w_up|w_gate|w_in)``: the 4-D
    ``mamba_super/w_in`` (2, 2, 64, 328), the trailing (1, 64, 328) and the
    shared block's MLP; 24-token rows, so the SSD pads."""
    radius = 5.0
    ts = train_parity(ARCH, SEED, radius, seq=24)
    params = ts["params"]
    for leaf in (params["mamba_super"]["w_in"], params["mamba_trailing"]["w_in"],
                 params["shared"]["mlp"]["w_up"], params["shared"]["mlp"]["w_gate"]):
        slices = leaf.reshape(-1, *leaf.shape[-2:])
        norms = [float(multilevel_norm(w, [("inf", 1), (1, 1)])) for w in slices]
        assert max(norms) <= radius * (1 + 1e-5)
        cols = slices.abs().amax(dim=1)
        assert all(0 < int((c == 0).sum()) < c.numel() for c in cols)
    # the SSM's other leaves are not matched
    assert not torch.equal(params["mamba_super"]["w_out"],
                           setup(ARCH, SEED)[3]["mamba_super"]["w_out"])


def test_the_family_gate_gives_the_forward_jax_keywords(monkeypatch):
    """No ``impl`` and no ``n_groups`` reach a hybrid forward or decode
    step, from the loss, the prefill or the decode step, whatever the
    caller asked (``repro/training/step.py:57-60``,
    ``repro/serving/lm.py:28-29, 42-43``)."""
    _, _, tcfg, tp = setup(ARCH, SEED)
    seen = []

    def spy(fn):
        def inner(*a, **k):
            seen.append(sorted(k))
            return fn(*a, **k)
        return inner

    api = tmodels.ModelAPI(tzamba.template, spy(tzamba.forward),
                           tzamba.make_cache, spy(tzamba.decode_step))
    toks = torch.zeros(1, 5, dtype=torch.int64)
    from repro_torch.training import step as tstep

    tstep.make_loss_fn(tcfg, api, impl="flash", n_groups=4, remat=False,
                       compute_dtype=torch.float32)(tp, toks)
    tserve.make_prefill(tcfg, api, impl="flash")(tp, toks)
    cache = api.make_cache(tcfg, 1, 4, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        tserve.make_decode_step(tcfg, api, n_groups=4)(tp, toks[:, 0], cache, 0)
    assert seen == [["act_spec", "remat"], ["act_spec", "remat"], []]


# ------------------------------------------------------------ the launchers
def test_train_and_serve_cli_on_cpu(capsys):
    out = train_cli.run(["--device", "cpu", "--smoke", "--arch", ARCH,
                         "--steps", "2", "--seq", "20", "--batch", "4",
                         "--radius", "5.0"])
    text = capsys.readouterr().out
    assert "attention: chunked (the shared block); a hybrid model takes no " \
           "--attn (flash not used)" in text
    assert "step     2 loss" in text
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    assert {"mamba_super/w_in", "mamba_trailing/w_in", "shared/mlp/w_up",
            "shared/mlp/w_gate"} <= set(out["sparsity"])
    res = serve_cli.run(["--device", "cpu", "--smoke", "--arch", ARCH,
                         "--batch", "2", "--prompt-len", "5", "--new", "3"])
    assert res["tokens"].shape == (2, 3)
    assert "2 requests × 3 new tokens" in capsys.readouterr().out


def test_refusals(tmp_path):
    """No silent fallback: a harvest and flash on a shared attention wider
    than the kernels take (136) each raise by name; zamba2-7b's 112 is a
    kernel width. A 2x2 launch passes the family's gate and stops only
    where it needs a world of four ranks, and the sharded loss runs on one
    rank of an abstract 2x2 mesh with the model's collectives (the 2x2
    launch itself: ``tests/test_torch_train_mesh_families.py``)."""
    with pytest.raises(ValueError, match="torchrun"):
        train_cli.run(["--device", "cpu", "--smoke", "--arch", ARCH, "--steps",
                       "1", "--mesh", "2x2"])
    got, want = sharded_loss_on_meta(ARCH)
    assert got == want and got["all_gather"] > 0
    with pytest.raises(ValueError, match="hybrid family's forward collects none"):
        factory_cli.main(["--device", "cpu", "--arch", ARCH, "--attn", "chunked",
                          "--out", str(tmp_path), "--harvest-steps", "1"])
    _, _, tcfg, tp = setup(ARCH, SEED)
    full = dataclasses.replace(tcfg, d_model=3584, n_heads=32, head_dim=0)
    assert full.resolved_head_dim == 112
    tzamba._check_impl(full, "flash")
    wide = dataclasses.replace(tcfg, d_model=4352, n_heads=32, head_dim=0)
    assert wide.resolved_head_dim == 136
    with pytest.raises(ValueError, match=r"heads are 136 wide.*impl='chunked'"):
        tzamba.forward(tp, torch.zeros(1, 4, dtype=torch.int64), wide,
                       impl="flash")
    # at the smoke width (16) flash runs, on its plain version here
    with torch.no_grad():
        a, _ = tzamba.forward(tp, torch.zeros(1, 4, dtype=torch.int64), tcfg,
                              impl="flash", remat=False)
        b, _ = tzamba.forward(tp, torch.zeros(1, 4, dtype=torch.int64), tcfg,
                              remat=False)
    torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
