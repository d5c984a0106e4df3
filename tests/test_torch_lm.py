"""Parity of the port's dense LM (``repro_torch.models.lm`` + ``layers``) with
the JAX package's, on the CPU, at smoke widths.

Parameters are made once by the JAX package's own ``init_params`` and carried
to the port with ``interop.from_numpy_tree`` (same stacked layout, no axis
moved); tokens come from a seeded numpy generator. Each port ``impl`` is held
to a JAX ``impl`` computing the same function: "naive" and "chunked" to
their namesakes, "flash" (the kernel's plain version on the CPU) to JAX's
"pallas" where its CPU oracle takes the shape (MHA) and to "naive" for GQA.
Tolerance: atol 2e-5 on logits and on the collected activations (float32,
4 layers, sums in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.models import params as jparams
from repro_torch import interop, models as tmodels
from repro_torch.configs import registry as treg
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.models import params as tparams

ARCHS = ["stablelm-1.6b", "granite-3-2b"]
IMPLS = [("naive", "naive"), ("chunked", "chunked"), ("flash", None)]


def _jax_impl(arch, port_impl):
    if port_impl != "flash":
        return port_impl
    cfg = jreg.smoke_config(arch)
    return "pallas" if cfg.n_kv_heads == cfg.n_heads else "naive"


def _setup(arch, seed=0):
    cfg = jreg.smoke_config(arch)
    jp = jparams.init_params(jlm.template(cfg), jax.random.PRNGKey(seed))
    tp = interop.from_numpy_tree(jax.tree_util.tree_map(np.asarray, jp),
                                 device="cpu")
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (2, 40)).astype(np.int32)
    return cfg, jp, tp, toks


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_the_jax_packages(arch):
    for get in ("get_arch", "smoke_config"):
        j = getattr(jreg, get)(arch)
        t = getattr(treg, get)(arch)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert t.resolved_head_dim == j.resolved_head_dim
        assert t.params_count() == j.params_count()
    assert sorted(treg.ARCHS) == sorted(jreg.ARCHS)


@pytest.mark.parametrize("arch", ARCHS)
def test_template_matches_and_init_statistics(arch):
    cfg = treg.smoke_config(arch)
    tt, jt = tlm.template(cfg), jlm.template(jreg.smoke_config(arch))
    jshapes = jax.tree_util.tree_map(lambda d: d.shape, jt,
                                     is_leaf=jparams.is_def)
    tshapes = jax.tree_util.tree_map(lambda d: d.shape, tt,
                                     is_leaf=tparams.is_def)
    assert tshapes == jshapes
    assert tparams.count_params(tt) == jparams.count_params(jt)
    p1 = tparams.init_params(tt, 3, device="cpu")
    p2 = tparams.init_params(tt, 3, device="cpu")
    p3 = tparams.init_params(tt, 4, device="cpu")
    assert torch.equal(p1["blocks"]["attn"]["wq"], p2["blocks"]["attn"]["wq"])
    assert not torch.equal(p1["blocks"]["attn"]["wq"], p3["blocks"]["attn"]["wq"])
    assert torch.all(p1["blocks"]["ln1"] == 1)
    wq = p1["blocks"]["attn"]["wq"]
    fan_in = np.prod(wq.shape[:-1])
    assert float(wq.std()) == pytest.approx(fan_in ** -0.5, rel=0.1)
    assert float(p1["embed"].std()) == pytest.approx(0.02, rel=0.1)
    assert tmodels.get(cfg).forward is tlm.forward


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("port_impl,_", IMPLS)
@pytest.mark.parametrize("site", ["resid", "mlp"])
def test_forward_collect_matches_jax(arch, port_impl, _, site):
    cfg, jp, tp, toks = _setup(arch)
    jl, _, ja = jlm.forward(jp, jnp.asarray(toks), cfg,
                            impl=_jax_impl(arch, port_impl), remat=False,
                            collect=site)
    with torch.no_grad():
        tl, aux, ta = tlm.forward(tp, torch.from_numpy(toks),
                                  treg.smoke_config(arch), impl=port_impl,
                                  remat=False, collect=site)
    assert ta.shape == (cfg.n_layers, 2, 40, cfg.d_model)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=2e-5, rtol=0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-5, rtol=0)
    assert aux == 0.0


def test_forward_without_collect_and_with_remat():
    cfg, jp, tp, toks = _setup("stablelm-1.6b", seed=1)
    jl, _ = jlm.forward(jp, jnp.asarray(toks), cfg, impl="chunked")
    tl, _ = tlm.forward(tp, torch.from_numpy(toks), treg.smoke_config(
        "stablelm-1.6b"), impl="chunked", remat=True)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), atol=2e-5)


@pytest.mark.parametrize("window", [None, 5])
def test_attention_impls_agree_with_jax_layers(window):
    rng = np.random.default_rng(2)
    q = rng.normal(size=(2, 33, 8, 16)).astype(np.float32)
    k = rng.normal(size=(2, 33, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 33, 2, 16)).astype(np.float32)
    want = jlayers.attention_naive(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), window=window)
    for impl in ("naive", "chunked", "flash"):
        got = tlayers.attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), window=window, impl=impl,
                                chunk=16)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_rope_and_norm_match_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(7)[None], (2, 7))
    for pct in (1.0, 0.25):
        jf = jlayers.rope_frequencies(16, pct, 10000.0, jnp.asarray(pos))
        tf = tlayers.rope_frequencies(16, pct, 10000.0, torch.from_numpy(pos.copy()))
        np.testing.assert_allclose(
            tlayers.apply_rope(torch.from_numpy(x), tf).numpy(),
            np.asarray(jlayers.apply_rope(jnp.asarray(x), jf)), atol=1e-6)
    s = rng.normal(size=(16,)).astype(np.float32)
    np.testing.assert_allclose(
        tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(s)).numpy(),
        np.asarray(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(s))), atol=1e-6)


def test_unported_families_raise():
    """Every family of the registry is served: whisper by ``models.whisper``
    (``tests/test_torch_whisper.py``), the recurrent families by ``zamba``
    and ``xlstm`` (``tests/test_torch_zamba.py``, ``tests/test_torch_xlstm.
    py``) and the MoE family (deepseek-v3, kimi-k2) by ``lm``, with its two
    stacks; a family the port does not know raises by name."""
    wcfg = treg.smoke_config("whisper-large-v3")
    api = tmodels.get(wcfg)
    assert (api.template, api.forward, api.make_cache, api.decode_step) == (
        tmodels.whisper.template, tmodels.whisper.forward,
        tmodels.whisper.make_cache, tmodels.whisper.decode_step)
    with pytest.raises(ValueError, match="unknown family 'encdec'"):
        tmodels.get(dataclasses.replace(wcfg, family="encdec"))
    for arch in ("deepseek-v3-671b", "kimi-k2-1t-a32b"):
        cfg = treg.smoke_config(arch)
        api = tmodels.get(cfg)
        assert (api.template, api.forward, api.decode_step) == (
            tlm.template, tlm.forward, tlm.decode_step)
        t = tlm.template(cfg)
        assert t["dense_blocks"]["mlp"]["w_up"].shape == (1, 64, 128)
        assert t["moe_blocks"]["mlp"]["w_up"].shape == (3, 8, 64, 32)
        assert t["moe_blocks"]["attn"]["wkv_b"].shape == (3, 16, 4, 32)
