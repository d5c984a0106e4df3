"""Parity of the port's audio family (``repro_torch/models/whisper.py`` and
``layers.layer_norm``) with the JAX package's, on the CPU, at the smoke
widths of ``whisper-large-v3`` (2 encoder and 4 decoder layers, d_model 64,
4 query heads over 2 kv heads of 16, d_ff 128, 32 encoder frames, vocab
256).

Parameters are drawn in numpy from the JAX template's init statistics and
handed to JAX as arrays and to the port with ``interop.from_numpy_tree``
(``tests/_torch_recurrent.py``); inputs come from seeded numpy generators.
JAX runs ``impl="chunked"``. Tolerances: float32 outputs and gradients
within 1e-5 of the largest entry (sums in another order); decode against
the teacher-forced forward within JAX's own 5e-3
(``tests/test_models.py``); three train steps at ``tests/
test_torch_train.py``'s float32 bars for losses and gradient norms and
``tests/test_torch_moe.py``'s for parameters
(``_torch_recurrent.train_parity``).

JAX's serving decodes against a cross cache that nothing fills
(``repro/models/whisper.py:142-151``): ``generate`` is held to it as it
is, and the decode with the audio holds a cache filled from ``encode``, as
``tests/test_models.py`` fills it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_recurrent import (assert_close_tree, setup, sharded_loss_on_meta,
                              template_shapes, train_parity)
from repro.models import layers as jlayers
from repro.models import params as jparams
from repro.models import whisper as jw
from repro.serving import lm as jserve
from repro.training import step as jstep
from repro_torch import _tree
from repro_torch import models as tmodels
from repro_torch.configs import registry as treg
from repro_torch.core.multilevel import multilevel_norm
from repro_torch.data import DataConfig, DataPipeline
from repro_torch.data.activations import harvest
from repro_torch.launch import sae_factory as factory_cli
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.models import params as tparams
from repro_torch.models import whisper as tw
from repro_torch.serving import lm as tserve
from repro_torch.training import step as tstep

ARCH = "whisper-large-v3"
SEED = 13
REL = 1e-5
_REF = {}


def _close(got, want, rel=REL, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(
        got.detach().numpy(), want, rtol=0,
        atol=rel * float(np.abs(want).max()), err_msg=what)


def _inputs(cfg, seq=12):
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab, (2, seq)).astype(np.int32)
    frames = (rng.normal(size=(2, cfg.enc_frames, cfg.d_model)) * 0.1).astype(
        np.float32)
    return toks, frames


def _jax_forward(audio):
    """JAX's encoder states and logits (chunked), once per frames case."""
    if audio not in _REF:
        cfg, jp, _, _ = setup(ARCH, SEED)
        toks, frames = _inputs(cfg)
        fr = jnp.asarray(frames) if audio else jnp.zeros(
            (2, cfg.enc_frames, cfg.d_model), jnp.float32)
        enc = jw.encode(jp, fr, cfg, impl="chunked", remat=False)
        logits, aux = jw.forward(jp, jnp.asarray(toks), cfg,
                                 frames=jnp.asarray(frames) if audio else None,
                                 impl="chunked", remat=False)
        assert aux == 0.0
        _REF[audio] = (np.asarray(enc), np.asarray(logits))
    return _REF[audio]


def _filled_cache(params, enc, cache):
    """``cache`` with the cross K/V of ``enc`` (B, F, d) in every decoder
    layer: xk = enc @ wk, xv = enc @ wv + bv (``tests/test_models.py``)."""
    cross = params["dec_blocks"]["cross"]
    if isinstance(enc, torch.Tensor):
        xk = torch.einsum("bsd,ldhk->lbshk", enc, cross["wk"])
        xv = torch.einsum("bsd,ldhk->lbshk", enc, cross["wv"]) \
            + cross["bv"][:, None, None]
        cache["xk"].copy_(xk)
        cache["xv"].copy_(xv)
        return cache
    xk = jnp.einsum("bsd,ldhk->lbshk", enc, cross["wk"])
    xv = jnp.einsum("bsd,ldhk->lbshk", enc, cross["wv"]) \
        + cross["bv"][:, None, None]
    return dict(cache, xk=xk, xv=xv)


# ------------------------------------------------------------- the template
def test_template_interop_and_api():
    cfg, jp, tcfg, tp = setup(ARCH, SEED)
    tt = tw.template(tcfg)
    assert template_shapes(tt, tparams.is_def) == template_shapes(
        jw.template(cfg), jparams.is_def)
    assert tparams.count_params(tt) == jparams.count_params(jw.template(cfg))
    # interop carries both stacks leaf for leaf
    assert_close_tree(tp, jp, 0.0)
    assert tp["enc_blocks"]["mlp"]["w_up"].shape == (2, 64, 128)
    assert tp["dec_blocks"]["cross"]["wk"].shape == (4, 64, 2, 16)
    assert "bk" not in tp["dec_blocks"]["self"]
    assert tp["pos_dec"].shape == (tw.DEC_POS_MAX, 64)
    api = tmodels.get(tcfg)
    assert (api.template, api.forward, api.make_cache, api.decode_step) == (
        tw.template, tw.forward, tw.make_cache, tw.decode_step)
    # the full config: 1.579 B template parameters; ArchConfig.params_count()
    # reads 2.020 B (ROADMAP § 3 reference item 5)
    full = treg.get_arch(ARCH)
    assert tparams.count_params(tw.template(full)) == 1_579_450_880
    assert full.params_count() == 2_020_213_760
    cut = tlm.cut_depth(full, 4)
    assert (cut.n_layers, cut.n_enc_layers) == (4, 4)
    t = tw.template(cut)
    assert t["enc_blocks"]["mlp"]["w_up"].shape == (4, 1280, 5120)
    assert t["dec_blocks"]["mlp"]["w_up"].shape == (4, 1280, 5120)


def test_layer_norm_matches_jax():
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(2, 7, 64)) * 3 + 1).astype(np.float32)
    s = rng.normal(size=(64,)).astype(np.float32)
    b = rng.normal(size=(64,)).astype(np.float32)
    want = jlayers.layer_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b))
    got = tlayers.layer_norm(*(torch.from_numpy(a) for a in (x, s, b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    # bf16 in, bf16 out; the statistics in float32
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = tlayers.layer_norm(xb, torch.from_numpy(s), torch.from_numpy(b))
    want = jlayers.layer_norm(jnp.asarray(xb.float().numpy(), jnp.bfloat16),
                              jnp.asarray(s), jnp.asarray(b))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0, atol=1e-6)


# -------------------------------------------------------------------- model
@pytest.mark.parametrize("audio", [False, True])
@pytest.mark.parametrize("impl", ["naive", "chunked", "flash"])
def test_encode_and_forward_match_jax(impl, audio):
    """The encoder's states and the teacher-forced logits, on zero frames
    (``frames=None``) and on random ones; ``flash`` runs the kernels'
    plain version here, with the encoder's and the cross-attention's 32
    keys against 12 queries non-causal."""
    cfg, jp, tcfg, tp = setup(ARCH, SEED)
    toks, frames = _inputs(cfg)
    jenc, jlogits = _jax_forward(audio)
    fr = torch.from_numpy(frames) if audio else None
    with torch.no_grad():
        enc = tw.encode(tp, fr if audio else torch.zeros(2, 32, 64), tcfg,
                        impl=impl, remat=False)
        logits, aux = tw.forward(tp, torch.from_numpy(toks), tcfg, frames=fr,
                                 impl=impl, remat=False)
    assert logits.shape == (2, 12, cfg.vocab) and aux == 0.0
    _close(enc, jenc, what="encoder states")
    _close(logits, jlogits, what="logits")


def test_flash_gradients_match_jax():
    """The loss's gradients through ``impl="flash"`` (the Function's plain
    backward here) and remat, against ``jax.grad`` of JAX's chunked
    forward: every parameter and the frames."""
    cfg, jp, tcfg, tp = setup(ARCH, SEED)
    toks, frames = _inputs(cfg)

    def jloss(p, fr):
        logits, _ = jw.forward(p, jnp.asarray(toks[:, :-1]), cfg, frames=fr,
                               impl="chunked", remat=True)
        return jstep.xent(logits, jnp.asarray(toks[:, 1:]))

    jl, (jgp, jgf) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        jp, jnp.asarray(frames))
    p = _tree.tree_map(lambda a: a.clone().requires_grad_(), tp)
    fr = torch.from_numpy(frames).requires_grad_()
    logits, _ = tw.forward(p, torch.from_numpy(toks[:, :-1]), tcfg, frames=fr,
                           impl="flash", remat=True)
    loss = tstep.xent(logits, torch.from_numpy(toks[:, 1:]))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
    assert_close_tree(_tree.tree_map(lambda a: a.grad, p), jgp, REL, "grad")
    _close(fr.grad, jgf, what="grad frames")


def test_make_cache_shapes_and_dtypes():
    cfg, _, tcfg, _ = setup(ARCH, SEED)
    tc = tw.make_cache(tcfg, 3, 10, device="cpu")
    jc = jw.make_cache(cfg, 3, 10)
    assert {k: (tuple(v.shape), v.dtype) for k, v in tc.items()} == {
        "k": ((4, 3, 10, 2, 16), torch.bfloat16),
        "v": ((4, 3, 10, 2, 16), torch.bfloat16),
        "xk": ((4, 3, 32, 2, 16), torch.bfloat16),
        "xv": ((4, 3, 32, 2, 16), torch.bfloat16)}
    assert {k: tuple(v.shape) for k, v in tc.items()} == {
        k: v.shape for k, v in jc.items()}
    f32 = tmodels.get(tcfg).make_cache(tcfg, 1, 4, dtype=torch.float32,
                                       device="cpu")
    assert all(v.dtype == torch.float32 and not v.any() for v in f32.values())


def test_filled_cross_cache_decode_matches_jax_and_the_forward():
    """Eight decode steps with the cross cache filled from each package's
    encoder on random frames: logits and caches equal JAX's step by step,
    and every step's logits equal the teacher-forced forward's within
    JAX's 5e-3. A position past the cache raises."""
    cfg, jp, tcfg, tp = setup(ARCH, SEED)
    toks, frames = _inputs(cfg, seq=8)
    jenc = jw.encode(jp, jnp.asarray(frames), cfg, impl="chunked", remat=False)
    jc = _filled_cache(jp, jenc, jw.make_cache(cfg, 2, 8, dtype=jnp.float32))
    jstep_ = jax.jit(lambda p, t, c, pos: jw.decode_step(p, t, c, pos, cfg))
    with torch.no_grad():
        enc = tw.encode(tp, torch.from_numpy(frames), tcfg, remat=False)
        tc = _filled_cache(tp, enc, tw.make_cache(tcfg, 2, 8, dtype=torch.float32,
                                                  device="cpu"))
        _close(tc["xk"], jc["xk"], what="xk")
        _close(tc["xv"], jc["xv"], what="xv")
        full, _ = tw.forward(tp, torch.from_numpy(toks), tcfg,
                             frames=torch.from_numpy(frames), remat=False)
        for i in range(8):
            jlg, jc = jstep_(jp, jnp.asarray(toks[:, i]), jc, jnp.int32(i))
            tlg, tc = tw.decode_step(tp, torch.from_numpy(toks[:, i]), tc, i,
                                     tcfg)
            _close(tlg, jlg, what=f"step {i} logits")
            np.testing.assert_allclose(tlg.numpy(), full[:, i].numpy(),
                                       rtol=5e-3, atol=5e-3)
        assert_close_tree(tc, jc, REL, "cache")
        with pytest.raises(ValueError, match="past the cache's 8 slots"):
            tw.decode_step(tp, torch.from_numpy(toks[:, 0]), tc, 8, tcfg)


def test_generate_and_prefill_match_jax():
    """``generate`` decodes against the zero cross cache of ``make_cache``,
    as JAX's does: token for token the same; the prefill (the forward on
    zero frames) as JAX's."""
    cfg, jp, tcfg, tp = setup(ARCH, SEED)
    prompt = np.random.default_rng(10).integers(0, cfg.vocab, (2, 5)).astype(
        np.int32)
    want = np.asarray(jserve.generate(jp, cfg, jnp.asarray(prompt), 4))
    got = tserve.generate(tp, tcfg, torch.from_numpy(prompt), 4)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    jpre = jserve.make_prefill(cfg, jw)(jp, jnp.asarray(prompt))
    tpre = tserve.make_prefill(tcfg, tmodels.get(tcfg), impl="flash")(
        tp, torch.from_numpy(prompt))
    _close(tpre, jpre, what="prefill")


# ----------------------------------------------------------------- training
def test_three_projected_train_steps_match_jax():
    """JAX's ``make_train_step(impl="chunked")`` (no mesh: ROADMAP § 3
    reference item 3) against the port's with ``impl="flash"``, the
    bi-level projection on both stacks' ``w_up``, zero audio frames."""
    radius = 5.0
    # both moments held per leaf, then the parameters with AdamW's own
    # slack: the biases start at zero, so each one's bar is 5e-5 of lr
    # (``train_parity``). The port runs JAX's chunked attention: on the
    # zero audio's cross keys and values the flash backward's delta =
    # rowsum(dO ∘ O) puts dec_blocks/cross/wk's gradient 1.2e-5 of its
    # largest entry from float64, the chunked softmax's 5.1e-6 (ROADMAP
    # § 2(c)); the flash path's gradients are held to jax.grad above
    ts = train_parity(ARCH, SEED, radius, seq=12, impl="chunked",
                      adam_slack=True)
    params = ts["params"]
    for stack in ("enc_blocks", "dec_blocks"):
        # every layer's slice starts outside the ball (norms 20-30) and ends
        # on its boundary; the columns zeroed at step 1 regrow by about lr a
        # step, as much as the next steps' threshold takes, so no count of
        # zero columns is held here
        leaf = params[stack]["mlp"]["w_up"]
        norms = [float(multilevel_norm(w, [("inf", 1), (1, 1)])) for w in leaf]
        assert all(radius * (1 - 1e-5) <= n <= radius * (1 + 1e-5)
                   for n in norms), (stack, norms)
    # the other leaves are not matched
    assert not torch.equal(params["dec_blocks"]["mlp"]["b_up"],
                           setup(ARCH, SEED)[3]["dec_blocks"]["mlp"]["b_up"])


def test_the_family_gate_gives_the_forward_jax_keywords():
    """``impl`` and no ``n_groups`` reach the audio forward from the loss
    and the prefill, and nothing but the position reaches its decode step
    (``repro/training/step.py:57-60``, ``repro/serving/lm.py:28-29,
    42-43``)."""
    _, _, tcfg, tp = setup(ARCH, SEED)
    seen = []

    def spy(fn):
        def inner(*a, **k):
            seen.append((sorted(k), k.get("impl")))
            return fn(*a, **k)
        return inner

    api = tmodels.ModelAPI(tw.template, spy(tw.forward), tw.make_cache,
                           spy(tw.decode_step))
    toks = torch.zeros(1, 5, dtype=torch.int64)
    tstep.make_loss_fn(tcfg, api, impl="flash", n_groups=4, remat=False,
                       compute_dtype=torch.float32)(tp, toks)
    tserve.make_prefill(tcfg, api, impl="naive")(tp, toks)
    cache = api.make_cache(tcfg, 1, 4, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        tserve.make_decode_step(tcfg, api, n_groups=4)(tp, toks[:, 0], cache, 0)
    kw = ["act_spec", "impl", "remat"]
    assert seen == [(kw, "flash"), (kw, "naive"), ([], None)]


# ------------------------------------------------------------ the launchers
def test_train_and_serve_cli_on_cpu(capsys):
    out = train_cli.run(["--device", "cpu", "--smoke", "--arch", ARCH,
                         "--steps", "2", "--seq", "12", "--batch", "4",
                         "--radius", "2.0"])
    text = capsys.readouterr().out
    assert ("constraint (w_up|w_gate|w_in) radius 2 on: dec_blocks/mlp/w_up "
            "(4, 64, 128), enc_blocks/mlp/w_up (2, 64, 128)") in text
    assert "step     2 loss" in text
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    assert set(out["sparsity"]) == {"enc_blocks/mlp/w_up", "dec_blocks/mlp/w_up"}
    res = serve_cli.run(["--device", "cpu", "--smoke", "--arch", ARCH,
                         "--layers", "2", "--batch", "2", "--prompt-len", "5",
                         "--new", "3"])
    assert res["tokens"].shape == (2, 3)
    assert (res["cfg"].n_layers, res["cfg"].n_enc_layers) == (2, 2)
    assert "2 requests × 3 new tokens" in capsys.readouterr().out


def test_refusals(tmp_path):
    """No silent fallback: a harvest, the SAE factory and a cut to no layer
    each raise by name. A 2x2 launch passes the family's gate and stops
    only where it needs a world of four ranks, and the sharded loss runs
    on one rank of an abstract 2x2 mesh with the model's collectives (the
    2x2 launch itself: ``tests/test_torch_train_mesh_families.py``)."""
    with pytest.raises(ValueError, match="torchrun"):
        train_cli.run(["--device", "cpu", "--smoke", "--arch", ARCH, "--steps",
                       "1", "--mesh", "2x2"])
    got, want = sharded_loss_on_meta(ARCH)
    assert got == want and got["psum"] > 0
    _, _, tcfg, tp = setup(ARCH, SEED)
    pipe = DataPipeline(DataConfig(vocab=tcfg.vocab, seq_len=8, global_batch=2,
                                   microbatch=2))
    with pytest.raises(ValueError, match="audio family's forward collects none"):
        harvest(tp, tcfg, pipe, tmp_path / "h", forward=tw.forward)
    assert not (tmp_path / "h").exists()
    with pytest.raises(ValueError, match="audio family's forward collects none"):
        factory_cli.main(["--device", "cpu", "--arch", ARCH, "--out",
                          str(tmp_path / "f"), "--harvest-steps", "1"])
    for n in (0, -1):
        with pytest.raises(ValueError, match="a model needs a layer"):
            tlm.cut_depth(treg.get_arch(ARCH), n)
    with pytest.raises(ValueError, match="a model needs a layer"):
        serve_cli.run(["--device", "cpu", "--smoke", "--arch", ARCH,
                       "--layers", "-1"])
