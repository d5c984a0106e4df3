"""Parity of the port's LM decode and serving (``repro_torch.models.lm``'s
``make_cache``/``decode_step``, ``layers.attention_decode``,
``serving/lm.py`` and ``launch/serve.py``) with the JAX package's, on the
CPU, at smoke widths.

Parameters are made by the JAX package's own ``init_params`` and carried to
the port with ``interop.params_from_jax``; tokens come from a seeded numpy
generator. Tolerances: ``attention_decode`` 1e-6 (float32, sums in another
order); decode logits 1e-5 · max|logits| with the port fed JAX's token
sequence; the generated tokens equal JAX's at every position, up to the
first whose top-2 logit margin in JAX is within 10× that bar (a near tie may
go either way, and every later token depends on it). The windowed model
(``h2o-danube-1.8b``, window 16 at smoke size) decodes 20 steps so that its
ring of 16 slots wraps; the dense one (``granite-3-2b``) 12. Prefill against
decode and batch independence follow ``tests/test_serving.py:25-83``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.configs import registry as jreg
from repro.models import layers as jlayers
from repro.models import params as jparams
from repro.serving import lm as jserving
from repro_torch import interop
from repro_torch import models as tmodels
from repro_torch.configs import registry as treg
from repro_torch.launch import serve as serve_cli
from repro_torch.models import layers as tlayers
from repro_torch.serving import lm as tserving

STEPS = {"granite-3-2b": 12, "h2o-danube-1.8b": 20}
BAR = 1e-5


def _setup(arch, seed=0):
    jcfg = jreg.smoke_config(arch)
    jp = jparams.init_params(jmodels.get(jcfg).template(jcfg),
                             jax.random.PRNGKey(seed))
    tp = interop.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                 device="cpu")
    tcfg = treg.smoke_config(arch)
    return jcfg, jp, tcfg, tp


# --------------------------------------------------------- attention_decode
@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("lengths", [(3, 8), (8, 8), (11, 14)])
def test_attention_decode_matches_jax(window, lengths):
    """Plain cache (valid prefix per request) and ring (every slot valid
    once the length passes T = 8), GQA 4 over 2, the length a (B,)
    tensor."""
    rng = np.random.default_rng(7)
    b, h, kv, d, t = 2, 4, 2, 16, 8
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    k = rng.normal(size=(b, t, kv, d)).astype(np.float32)
    v = rng.normal(size=(b, t, kv, d)).astype(np.float32)
    if window is None:
        lengths = tuple(min(n, t) for n in lengths)
    cur = np.asarray(lengths, np.int32)
    want = np.asarray(jlayers.attention_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(cur),
        window=window))
    got = tlayers.attention_decode(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), torch.from_numpy(cur),
                                   window=window)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


# -------------------------------------------------------------- decode_step
def _decode_both(arch, batch=2, seed=0):
    """JAX's greedy decode of a seeded prompt token, step by step, and the
    port's decode fed JAX's token at every step: (JAX logits, port logits,
    JAX tokens) per step."""
    jcfg, jp, tcfg, tp = _setup(arch, seed)
    n = STEPS[arch]
    japi, tapi = jmodels.get(jcfg), tmodels.get(tcfg)
    jcache = japi.make_cache(jcfg, batch, n, dtype=jnp.float32)
    tcache = tapi.make_cache(tcfg, batch, n, dtype=torch.float32, device="cpu")
    jstep = jax.jit(jserving.make_decode_step(jcfg, japi))
    tstep = tserving.make_decode_step(tcfg, tapi)
    toks = np.random.default_rng(seed).integers(0, jcfg.vocab, (batch,)).astype(
        np.int32)
    out = []
    for pos in range(n):
        jn, jl, jcache = jstep(jp, jnp.asarray(toks), jcache, jnp.int32(pos))
        with torch.inference_mode():
            tn, tl, tcache = tstep(tp, torch.from_numpy(toks), tcache, pos)
        out.append((np.asarray(jl), tl.numpy(), np.asarray(jn), tn.numpy()))
        toks = np.array(jn)
    return jcfg, tcache, out


@pytest.mark.parametrize("arch", sorted(STEPS))
def test_decode_step_matches_jax(arch):
    cfg, cache, steps = _decode_both(arch)
    if cfg.window:
        assert cache["k"].shape[2] == cfg.window == 16 < STEPS[arch]  # wraps
    for pos, (jl, tl, _, _) in enumerate(steps):
        scale = float(np.abs(jl).max())
        np.testing.assert_allclose(tl, jl, rtol=0, atol=BAR * scale,
                                   err_msg=f"{arch} position {pos}")


@pytest.mark.parametrize("arch", sorted(STEPS))
def test_generate_tokens_match_jax(arch):
    """``generate`` against JAX's, held where JAX's choice is clear."""
    jcfg, jp, tcfg, tp = _setup(arch, seed=3)
    prompt = np.random.default_rng(3).integers(0, jcfg.vocab, (2, 6)).astype(
        np.int32)
    new = STEPS[arch] - 6
    want = np.asarray(jserving.generate(jp, jcfg, jnp.asarray(prompt), new))
    got = tserving.generate(tp, tcfg, torch.from_numpy(prompt), new)
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, new)
    # JAX's logits behind each generated token: its greedy run replayed
    japi = jmodels.get(jcfg)
    cache = japi.make_cache(jcfg, 2, 6 + new, dtype=jnp.float32)
    jstep = jax.jit(jserving.make_decode_step(jcfg, japi))
    seq = np.concatenate([prompt, want], axis=1)
    margins = []
    for pos in range(6 + new - 1):
        _, logits, cache = jstep(jp, jnp.asarray(seq[:, pos]), cache,
                                 jnp.int32(pos))
        if pos >= 5:
            top = np.sort(np.asarray(logits), axis=-1)[:, -2:]
            margins.append((top[:, 1] - top[:, 0])
                           / (BAR * np.abs(np.asarray(logits)).max()))
    clear = np.stack(margins, axis=1) > 10.0             # (B, new)
    for b in range(2):
        upto = new if clear[b].all() else int(np.argmin(clear[b]))
        assert upto > 0, "no clear token to compare"
        np.testing.assert_array_equal(got[b, :upto].numpy(), want[b, :upto])


def _tprompt(cfg, shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, shape).astype(np.int32))


def test_prefill_last_logits_match_decode():
    _, _, cfg, tp = _setup("granite-3-2b")
    api = tmodels.get(cfg)
    prompt = _tprompt(cfg, (2, 10), 4)
    last = tserving.make_prefill(cfg, api, impl="naive")(tp, prompt)
    cache = api.make_cache(cfg, 2, 16, dtype=torch.float32, device="cpu")
    step = tserving.make_decode_step(cfg, api)
    with torch.inference_mode():
        for i in range(10):
            _, logits, cache = step(tp, prompt[:, i], cache, i)
    np.testing.assert_allclose(logits.numpy(), last.numpy(), rtol=5e-3,
                               atol=5e-3)
    chunked = tserving.make_prefill(cfg, api)(tp, prompt)   # the default impl
    np.testing.assert_allclose(chunked.numpy(), last.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_swa_ring_cache_generation_matches_forward():
    """A prompt longer than the ring (24 tokens, window 16): the decode's
    last logits equal the teacher-forced windowed forward's."""
    _, _, cfg, tp = _setup("h2o-danube-1.8b")
    assert cfg.window == 16
    api = tmodels.get(cfg)
    prompt = _tprompt(cfg, (1, 24), 2)
    cache = api.make_cache(cfg, 1, 40, dtype=torch.float32, device="cpu")
    assert cache["k"].shape[2] == 16
    step = tserving.make_decode_step(cfg, api)
    with torch.inference_mode():
        for i in range(24):
            _, logits, cache = step(tp, prompt[:, i], cache, i)
        full, _ = api.forward(tp, prompt, cfg, impl="naive", remat=False)
    np.testing.assert_allclose(logits.numpy(), full[:, -1].numpy(), rtol=5e-3,
                               atol=5e-3)


def test_greedy_deterministic_and_batch_independent():
    _, _, cfg, tp = _setup("granite-3-2b")
    p1, p2 = _tprompt(cfg, (1, 8), 1), _tprompt(cfg, (1, 8), 11)
    a = tserving.generate(tp, cfg, torch.cat([p1, p2]), 5)
    b = tserving.generate(tp, cfg, torch.cat([p1, p2]), 5)
    assert torch.equal(a, b)
    assert torch.equal(a[0], tserving.generate(tp, cfg, p1, 5)[0])


def test_decode_api_and_refusals():
    cfg = treg.smoke_config("granite-3-2b")
    api = tmodels.get(cfg)
    assert api.make_cache is not None and api.decode_step is not None
    sae = tmodels.get(treg.get_arch("sae-paper"))
    assert sae.make_cache is None and sae.decode_step is None
    # the MoE family decodes from MLA's latent cache: c_kv and k_rope
    # (kv_lora_rank 16 and qk_rope_dim 8 at smoke size) for every layer
    for arch in ("deepseek-v3-671b", "kimi-k2-1t-a32b"):
        mcfg = treg.smoke_config(arch)
        mapi = tmodels.get(mcfg)
        assert mapi.make_cache is not None and mapi.decode_step is not None
        cache = mapi.make_cache(mcfg, 1, 4, device="cpu")
        assert {k: (tuple(v.shape), v.dtype) for k, v in cache.items()} == {
            "c_kv": ((4, 1, 4, 16), torch.bfloat16),
            "k_rope": ((4, 1, 4, 8), torch.bfloat16)}
    # whisper decodes from its self-attention cache and the encoder's cross
    # K/V (enc_frames 32 at smoke size), whatever the length asked
    wcfg = treg.smoke_config("whisper-large-v3")
    wapi = tmodels.get(wcfg)
    assert wapi.make_cache is not None and wapi.decode_step is not None
    cache = wapi.make_cache(wcfg, 1, 4, device="cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in cache.items()} == {
        "k": ((4, 1, 4, 2, 16), torch.bfloat16),
        "v": ((4, 1, 4, 2, 16), torch.bfloat16),
        "xk": ((4, 1, 32, 2, 16), torch.bfloat16),
        "xv": ((4, 1, 32, 2, 16), torch.bfloat16)}


# ------------------------------------------------------------ the launcher
def test_serve_cli_on_cpu_writes_metrics(tmp_path, capsys):
    out = tmp_path / "metrics.jsonl"
    res = serve_cli.run(["--device", "cpu", "--smoke", "--batch", "2",
                         "--prompt-len", "5", "--new", "4",
                         "--metrics-out", str(out)])
    text = capsys.readouterr().out
    assert "2 requests × 4 new tokens" in text and "tok/s" in text
    assert tuple(res["tokens"].shape) == (2, 4) and res["tok_per_s"] > 0
    assert out.exists()
    for line in out.read_text().splitlines():
        json.loads(line)
    # the same tokens as generate on the launcher's seeded params and prompts
    want = tserving.generate(res["params"], res["cfg"], res["prompts"], 4)
    assert torch.equal(res["tokens"], want)
    np.testing.assert_array_equal(
        res["prompts"].numpy(),
        np.random.default_rng(0).integers(0, res["cfg"].vocab, (2, 5)))


def test_serve_cli_layers_and_checkpoint(tmp_path):
    from repro_torch.runtime import CheckpointManager
    res = serve_cli.run(["--device", "cpu", "--smoke", "--layers", "2",
                         "--batch", "1", "--prompt-len", "3", "--new", "2"])
    assert res["cfg"].n_layers == 2
    assert res["params"]["blocks"]["ln1"].shape[0] == 2
    CheckpointManager(str(tmp_path)).save(1, {"params": res["params"]})
    again = serve_cli.run(["--device", "cpu", "--smoke", "--layers", "2",
                           "--batch", "1", "--prompt-len", "3", "--new", "2",
                           "--ckpt", str(tmp_path)])
    assert torch.equal(again["tokens"], res["tokens"])


def test_serve_cli_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_cli.run(["--smoke", "--batch", "1", "--prompt-len", "2",
                       "--new", "1"])
