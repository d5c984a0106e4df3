"""Parity of the port's MLA attention and MoE decode (``repro_torch.models.
lm``'s ``_attn_mla``, the absorbed ``_attn_mla_decode``, the latent cache
of ``make_cache``/``decode_step``, ``serving/lm.py`` and ``launch/serve.py``
on an MoE arch) with the JAX package's, on the CPU, at the smoke widths of
``deepseek-v3-671b`` and ``kimi-k2-1t-a32b`` (MLA q/k heads of 16 nope + 8
rope, v heads of 16, a latent of 16; 8 experts, top-2).

Parameters and inputs are drawn in numpy (``tests/test_torch_moe.py``'s
``numpy_params``, a seed per arch). Tolerances, float32 (sums in another
order): ``_attn_mla`` within 1e-5 · max|out|; the absorbed decode within
1e-5 · max|out| of JAX's and of the full expansion's row at the same
position; six ``decode_step``s' logits within 1e-5 · max|logits| and the
latent caches within 1e-6 of their largest entry plus 1e-6 relative. bf16 (parameters, hidden states and cache in
bf16, as JAX's default cache): within 2e-2 · max|out| (rounded at other
places). The teacher-forced forward against the decode replay within
1e-4 · max|logits| with a drop-free capacity factor: a forward's tokens and
a decode step's batch queue for the experts in different groups, so
capacity drops differ between the two (``tests/test_models.py:64-75``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.configs import registry as jreg
from repro.models import lm as jlm
from repro.serving import lm as jserving
from repro_torch import _tree
from repro_torch import models as tmodels
from repro_torch.configs import registry as treg
from repro_torch.launch import serve as serve_cli
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.serving import lm as tserving

from test_torch_moe import ARCHS, KEYS, _setup


def _layer(tree, i):
    return jax.tree_util.tree_map(lambda a: a[i], tree)


def _hidden(cfg, shape, seed):
    return np.random.default_rng(seed).normal(
        size=shape + (cfg.d_model,)).astype(np.float32)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["naive", "chunked"])
def test_attn_mla_matches_jax(arch, impl):
    cfg, jp, tcfg, tp = _setup(arch)
    h = _hidden(cfg, (2, 24), 3)
    pos = np.broadcast_to(np.arange(24)[None], (2, 24))
    want, _ = jlm._attn_mla(_layer(jp["dense_blocks"]["attn"], 0),
                            jnp.asarray(h), cfg, positions=jnp.asarray(pos),
                            impl=impl, window=None)
    got = tlm._attn_mla(_tree.tree_map(lambda a: a[0], tp["dense_blocks"]["attn"]),
                        torch.from_numpy(h), tcfg,
                        positions=torch.from_numpy(pos.copy()), impl=impl,
                        window=None)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def _decode_attn(arch, dtype, steps=10):
    """JAX's and the port's absorbed decode over ``steps`` positions of one
    layer (MoE stack, layer 1), and the port's full expansion."""
    cfg, jp, tcfg, tp = _setup(arch)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jl = jax.tree_util.tree_map(lambda a: a.astype(jdt),
                                _layer(jp["moe_blocks"]["attn"], 1))
    tl = _tree.tree_map(lambda a: a[1].to(tdt), tp["moe_blocks"]["attn"])
    h = _hidden(cfg, (2, steps), 4)
    m = cfg.mla
    jc = {"c_kv": jnp.zeros((2, steps, m.kv_lora_rank), jdt),
          "k_rope": jnp.zeros((2, steps, m.qk_rope_dim), jdt)}
    tc = {"c_kv": torch.zeros(2, steps, m.kv_lora_rank, dtype=tdt),
          "k_rope": torch.zeros(2, steps, m.qk_rope_dim, dtype=tdt)}
    hj, ht = jnp.asarray(h).astype(jdt), torch.from_numpy(h).to(tdt)
    jout, tout = [], []
    for p in range(steps):
        o, jc = jlm._attn_mla_decode(jl, hj[:, p:p + 1], cfg, pos=p, cache=jc)
        jout.append(np.asarray(o.astype(jnp.float32)))
        freqs = tlayers.rope_frequencies(
            m.qk_rope_dim, 1.0, cfg.rope_theta,
            torch.full((2, 1), p, dtype=torch.int32))
        tout.append(tlm._attn_mla_decode(tl, ht[:, p:p + 1], tcfg, pos=p,
                                         freqs=freqs, cache=tc).float().numpy())
    pos = torch.arange(steps)[None].expand(2, steps)
    full = tlm._attn_mla(tl, ht, tcfg, positions=pos, impl="naive",
                         window=None).float().numpy()
    return (np.concatenate(jout, 1), np.concatenate(tout, 1), full,
            {k: np.asarray(v.astype(jnp.float32)) for k, v in jc.items()},
            {k: v.float().numpy() for k, v in tc.items()})


@pytest.mark.parametrize("arch", ARCHS)
def test_absorbed_decode_matches_jax_and_the_expansion(arch):
    jo, to, full, jc, tc = _decode_attn(arch, "float32")
    scale = np.abs(jo).max()
    np.testing.assert_allclose(to, jo, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(to, full, rtol=0, atol=1e-5 * scale)
    for k in jc:
        np.testing.assert_allclose(tc[k], jc[k], rtol=1e-6,
                                   atol=1e-6 * np.abs(jc[k]).max())


def test_absorbed_decode_in_bfloat16_matches_jax():
    """bf16 weights, hidden states and cache: the logits over the cache in
    float32, the latent output cast to bf16 before ``W_kv_b``."""
    jo, to, _, _, _ = _decode_attn(ARCHS[1], "bfloat16", steps=6)
    np.testing.assert_allclose(to, jo, rtol=0, atol=2e-2 * np.abs(jo).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_six_decode_steps_match_jax(arch):
    cfg, jp, tcfg, tp = _setup(arch)
    japi, tapi = jmodels.get(cfg), tmodels.get(tcfg)
    jcache = japi.make_cache(cfg, 2, 6, dtype=jnp.float32)
    tcache = tapi.make_cache(tcfg, 2, 6, dtype=torch.float32, device="cpu")
    assert {k: tuple(v.shape) for k, v in tcache.items()} == {
        "c_kv": (4, 2, 6, 16), "k_rope": (4, 2, 6, 8)}
    jstep = jax.jit(jserving.make_decode_step(cfg, japi))
    tstep = tserving.make_decode_step(tcfg, tapi)
    toks = np.random.default_rng(KEYS[arch]).integers(
        0, cfg.vocab, (2,)).astype(np.int32)
    for pos in range(6):
        jn, jlog, jcache = jstep(jp, jnp.asarray(toks), jcache, jnp.int32(pos))
        with torch.inference_mode():
            _, tlog, tcache = tstep(tp, torch.from_numpy(toks), tcache, pos)
        jlog = np.asarray(jlog)
        np.testing.assert_allclose(tlog.numpy(), jlog, rtol=0,
                                   atol=1e-5 * np.abs(jlog).max(),
                                   err_msg=f"{arch} position {pos}")
        toks = np.array(jn)
    for k in tcache:
        want = np.asarray(jcache[k])
        np.testing.assert_allclose(tcache[k].numpy(), want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())


def test_decode_replay_equals_the_forward_when_nothing_drops():
    _, _, tcfg, tp = _setup(ARCHS[0])
    cfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, capacity_factor=16.0))
    api = tmodels.get(cfg)
    prompt = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab, (2, 8)))
    cache = api.make_cache(cfg, 2, 8, dtype=torch.float32, device="cpu")
    step = tserving.make_decode_step(cfg, api)
    with torch.inference_mode():
        for i in range(8):
            _, logits, cache = step(tp, prompt[:, i], cache, i)
        full = tserving.make_prefill(cfg, api)(tp, prompt)
    np.testing.assert_allclose(logits.numpy(), full.numpy(), rtol=0,
                               atol=1e-4 * float(full.abs().max()))


def test_serve_cli_on_an_moe_arch_keeps_its_dense_layers():
    res = serve_cli.run(["--device", "cpu", "--smoke", "--arch", ARCHS[1],
                         "--layers", "2", "--batch", "2", "--prompt-len", "5",
                         "--new", "3"])
    cfg, params = res["cfg"], res["params"]
    assert (cfg.n_layers, cfg.moe.first_dense) == (2, 1)
    assert params["dense_blocks"]["ln1"].shape[0] == 1
    assert params["moe_blocks"]["mlp"]["w_up"].shape == (1, 8, 64, 32)
    assert tuple(res["tokens"].shape) == (2, 3)
    want = tserving.generate(params, cfg, res["prompts"], 3)
    assert torch.equal(res["tokens"], want)
    # a full-width MLA cache holds 576 values a token and layer
    full = treg.get_arch(ARCHS[0])
    cache = tlm.make_cache(dataclasses.replace(full, n_layers=1), 1, 2,
                           dtype=torch.float32, device="cpu")
    assert sum(v.shape[-1] for v in cache.values()) == 576
