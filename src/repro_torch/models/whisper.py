"""Whisper-large-v3 backbone (arXiv:2212.04356), port of
``repro/models/whisper.py``: an encoder-decoder transformer.

The conv/mel audio frontend is a stub, as in the JAX package: the encoder
takes pre-computed frame embeddings (B, enc_frames, d_model), and
``frames=None`` means zeros. Learned absolute positions, LayerNorm (scale
and bias), a GELU MLP (tanh form) and multi-head attention with biases on
q, v and the output (none on k). The decoder's positions are sized for
32k tokens (``DEC_POS_MAX``); the real model's context is 448.

The stacks keep the JAX package's layout, ``enc_blocks/mlp/w_up``
(n_enc_layers, d, f) and ``dec_blocks/{self,cross,mlp}/...`` (n_layers,
...), so a JAX parameter tree crosses over with
``interop.from_numpy_tree`` unchanged; ``lax.scan`` over a stack becomes a
Python loop. The encoder's self-attention and the decoder's
cross-attention (decoder queries against every encoder frame) are
non-causal, the decoder's self-attention causal; each goes through
``layers.attention`` with the caller's ``impl`` (``"flash"``: the CUDA
kernels on the card).

Serving (:func:`make_cache`, :func:`decode_step`) keeps the decoder's
self-attention cache, written in place at the Python int ``pos``, and the
cross-attention K/V of the encoder states (``xk``/``xv``). As in the JAX
package, ``make_cache`` returns them zero and no function here fills them:
a caller that wants the audio in the decode fills them from
:func:`encode` (``xk = enc @ wk``, ``xv = enc @ wv + bv`` per layer).
"""

from __future__ import annotations

import operator

import torch
import torch.nn.functional as F

from repro_torch import _tree
from repro_torch.configs.types import ArchConfig
from repro_torch.parallel import collectives as C

from . import layers as L
from . import lm
from .params import ParamDef

DEC_POS_MAX = 32768


def _attn_t(cfg: ArchConfig, n: int):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return {
        "wq": ParamDef((n, d, cfg.n_heads, hd), ("layers", "embed", "heads", None),
                       "scaled"),
        "bq": ParamDef((n, cfg.n_heads, hd), ("layers", "heads", None), "zeros"),
        "wk": ParamDef((n, d, cfg.n_kv_heads, hd),
                       ("layers", "embed", "kv_heads", None), "scaled"),
        "wv": ParamDef((n, d, cfg.n_kv_heads, hd),
                       ("layers", "embed", "kv_heads", None), "scaled"),
        "bv": ParamDef((n, cfg.n_kv_heads, hd), ("layers", "kv_heads", None), "zeros"),
        "wo": ParamDef((n, cfg.n_heads, hd, d), ("layers", "heads", None, "embed"),
                       "scaled"),
        "bo": ParamDef((n, d), ("layers", None), "zeros"),
    }


def _mlp_t(cfg: ArchConfig, n: int):
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_up": ParamDef((n, d, f), ("layers", "embed", "ffn"), "scaled"),
        "b_up": ParamDef((n, f), ("layers", "ffn"), "zeros"),
        "w_down": ParamDef((n, f, d), ("layers", "ffn", "embed"), "scaled"),
        "b_down": ParamDef((n, d), ("layers", None), "zeros"),
    }


def _ln_t(cfg: ArchConfig, n: int, name: str):
    return {
        f"{name}_s": ParamDef((n, cfg.d_model), ("layers", None), "ones"),
        f"{name}_b": ParamDef((n, cfg.d_model), ("layers", None), "zeros"),
    }


def template(cfg: ArchConfig):
    d = cfg.d_model
    ne, nd = cfg.n_enc_layers, cfg.n_layers
    enc = {"attn": _attn_t(cfg, ne), "mlp": _mlp_t(cfg, ne),
           **_ln_t(cfg, ne, "ln1"), **_ln_t(cfg, ne, "ln2")}
    dec = {"self": _attn_t(cfg, nd), "cross": _attn_t(cfg, nd),
           "mlp": _mlp_t(cfg, nd), **_ln_t(cfg, nd, "ln1"),
           **_ln_t(cfg, nd, "ln15"), **_ln_t(cfg, nd, "ln2")}
    return {
        "embed": ParamDef((cfg.vocab, d), ("vocab", "embed"), "normal", 0.02),
        "pos_enc": ParamDef((cfg.enc_frames, d), (None, "embed"), "normal", 0.01),
        "pos_dec": ParamDef((DEC_POS_MAX, d), (None, "embed"), "normal", 0.01),
        "enc_blocks": enc,
        "dec_blocks": dec,
        "enc_norm_s": ParamDef((d,), (None,), "ones"),
        "enc_norm_b": ParamDef((d,), (None,), "zeros"),
        "dec_norm_s": ParamDef((d,), (None,), "ones"),
        "dec_norm_b": ParamDef((d,), (None,), "zeros"),
    }


def _ln(x, p, name, eps):
    return L.layer_norm(x, p[f"{name}_s"], p[f"{name}_b"], eps)


def _mha(lp, hq, hkv, *, causal, impl, cfg=None, sh=None, sp=None):
    """Attention of queries from ``hq`` (B, Sq, D) over keys and values from
    ``hkv`` (B, Sk, D), biases on q, v and the output. Under a mesh (``sh``,
    ``sp`` this layer's specs) on this rank's heads: the inputs entered,
    ``bq`` (and ``bv`` with sharded kv heads) added on the local heads, the
    output psummed over "model" and ``bo`` added once, after it."""
    heads_tp = sh is not None and sh.tp(sp["wq"][-2])
    if sh is not None:
        kv_tp = sh.tp(sp["wk"][-2])
        whole = set() if kv_tp else {"wk", "wv", "bv"}
        lp = {k: sh.weight(x, sp[k], heads_tp and k in whole)
              for k, x in lp.items()}
    if heads_tp:
        same = hkv is hq
        hq = C.enter(hq, sh.mesh)
        hkv = hq if same else C.enter(hkv, sh.mesh)
    q = torch.einsum("bsd,dhk->bshk", hq, lp["wq"]) + lp["bq"]
    k = torch.einsum("bsd,dhk->bshk", hkv, lp["wk"])
    v = torch.einsum("bsd,dhk->bshk", hkv, lp["wv"]) + lp["bv"]
    if heads_tp and not kv_tp:  # the replicated kv heads the local q heads read
        k, v = lm._kv_for_local_heads(k, cfg, sh), lm._kv_for_local_heads(v, cfg, sh)
    o = L.attention(q, k, v, causal=causal, impl=impl)
    out = torch.einsum("bshk,hkd->bsd", o, lp["wo"])
    if heads_tp:
        out = C.leave(out, sh.mesh)
    return out + lp["bo"]


def _mlp(lp, x, sh=None, sp=None):
    """The GELU MLP; under a mesh on this rank's ffn slice (``b_up`` split
    with it), psummed over "model" and ``b_down`` added after."""
    tp = sh is not None and sh.tp(sp["w_up"][-1])
    if sh is not None:
        lp = {k: sh.weight(w, sp[k]) for k, w in lp.items()}
    if tp:
        x = C.enter(x, sh.mesh)
    h = F.gelu(x @ lp["w_up"] + lp["b_up"], approximate="tanh")  # jax.nn.gelu's
    out = h @ lp["w_down"]
    if tp:
        out = C.leave(out, sh.mesh)
    return out + lp["b_down"]


def _run(fn, x, remat, sh=None):
    """One block: recomputed in the backward under ``remat``
    (``torch.utils.checkpoint``; JAX's ``jax.checkpoint`` of the block)."""
    return lm.checkpointed(fn, x, sh is not None) if remat else fn(x)


def _layer_specs(param_specs, name):
    """A stack's per-layer specs: the stacked leaves' without the layer
    axis."""
    return _tree.tree_map(lambda sp: tuple(sp[1:]), param_specs[name])


def _pos(params, name, n, sh, param_specs):
    """The first ``n`` learned positions, FSDP-gathered under a mesh (the
    slice first, so only those rows are gathered)."""
    pos = params[name][:n]
    return pos if sh is None else sh.weight(pos, param_specs[name])


def encode(params, frames, cfg: ArchConfig, *, impl="chunked", remat=True,
           mesh=None, param_specs=None):
    """frames (B, F, d) stub embeddings -> encoder states (B, F, d). With
    ``mesh``/``param_specs`` (as :func:`forward`) ``frames`` are this
    rank's slice of the batch and every layer runs on its heads and ffn
    slice; the states come out the same on every rank of a "model" line."""
    sh = None if mesh is None else lm._Sharded(mesh, param_specs)
    lsp = None if sh is None else _layer_specs(param_specs, "enc_blocks")
    pos = _pos(params, "pos_enc", frames.shape[1], sh, param_specs)
    x = frames + pos[None].to(frames.dtype)
    for lp in _tree.unstack(params["enc_blocks"]):
        def body(h, p=lp):
            hn = _ln(h, p, "ln1", cfg.norm_eps)
            h = h + _mha(p["attn"], hn, hn, causal=False, impl=impl, cfg=cfg,
                         sh=sh, sp=lsp and lsp["attn"])
            return h + _mlp(p["mlp"], _ln(h, p, "ln2", cfg.norm_eps), sh,
                            lsp and lsp["mlp"])

        x = _run(body, x, remat, sh)
    return L.layer_norm(x, params["enc_norm_s"], params["enc_norm_b"],
                        cfg.norm_eps)


def forward(params, tokens, cfg: ArchConfig, *, frames=None, impl="chunked",
            remat=True, act_spec=None, mesh=None, param_specs=None, **_):
    """Teacher-forced decoder over ``tokens`` (B, S) with the encoder on
    ``frames`` (zeros when None): ``(logits (B, S, V), 0.0)``. The
    unembedding is the embedding's transpose. ``act_spec`` has no effect
    without a mesh, and other keywords are ignored, as in the JAX package.

    ``mesh`` and ``param_specs`` run the sharded forward (``models.lm``'s
    module docstring): ``params`` and ``tokens`` are this rank's shards
    (zero audio is this rank's slice of the batch), heads and ffn over
    "model" in all three attentions and both MLPs, the encoder states
    entering each decoder layer's cross-attention with their gradient
    psummed over "model", and the logits this rank's slice of the
    vocabulary where "model" shards the embedding
    (``lm.logits_spec``)."""
    if (mesh is None) != (param_specs is None):
        raise ValueError("a sharded forward takes both mesh= and param_specs=")
    b, s = tokens.shape
    emb = params["embed"]
    sh = None if mesh is None else lm._Sharded(mesh, param_specs)
    if frames is None:  # zero audio, as the JAX package's smoke/train path
        frames = torch.zeros((b, cfg.enc_frames, cfg.d_model), dtype=emb.dtype,
                             device=emb.device)
    enc = encode(params, frames, cfg, impl=impl, remat=remat, mesh=mesh,
                 param_specs=param_specs)
    rows = emb[tokens] if sh is None else lm.embed_sharded(params, param_specs,
                                                           tokens, sh)
    x = rows + _pos(params, "pos_dec", s, sh, param_specs)[None].to(emb.dtype)
    lsp = None if sh is None else _layer_specs(param_specs, "dec_blocks")
    for lp in _tree.unstack(params["dec_blocks"]):
        def body(h, p=lp):
            hn = _ln(h, p, "ln1", cfg.norm_eps)
            h = h + _mha(p["self"], hn, hn, causal=True, impl=impl, cfg=cfg,
                         sh=sh, sp=lsp and lsp["self"])
            h = h + _mha(p["cross"], _ln(h, p, "ln15", cfg.norm_eps), enc,
                         causal=False, impl=impl, cfg=cfg, sh=sh,
                         sp=lsp and lsp["cross"])
            return h + _mlp(p["mlp"], _ln(h, p, "ln2", cfg.norm_eps), sh,
                            lsp and lsp["mlp"])

        x = _run(body, x, remat, sh)
    x = L.layer_norm(x, params["dec_norm_s"], params["dec_norm_b"], cfg.norm_eps)
    if sh is None:
        return x @ emb.T, 0.0
    return lm.logits_sharded(x, params, param_specs, cfg, sh), 0.0


def tally(t, cfg: ArchConfig, param_specs, batch: int, seq: int, *,
          remat: bool) -> None:
    """The sharded forward's and backward's collectives on one rank into
    ``t`` (``lm.Tally``), for ``batch`` × ``seq`` decoder tokens: the
    encoder's over ``enc_frames``, the cross-attention's output over the
    tokens and its inputs' psums backward (the queries' and the encoder
    states')."""
    tpl = template(cfg)
    d, item = cfg.d_model, t.itemsize
    act, act_enc = batch * seq * d * item, batch * cfg.enc_frames * d * item
    fwd = 2 if remat else 1
    t.weight((cfg.enc_frames, d), param_specs["pos_enc"])
    for _ in range(cfg.n_enc_layers):
        _tally_mha(t, tpl["enc_blocks"]["attn"], param_specs["enc_blocks"]["attn"],
                   act_enc, None, fwd)
        t.mlp(tpl["enc_blocks"]["mlp"], param_specs["enc_blocks"]["mlp"],
              act_enc, fwd)
    t.top(cfg, tpl, param_specs, act, batch * seq)
    t.weight((seq, d), param_specs["pos_dec"])
    dec, dsp = tpl["dec_blocks"], param_specs["dec_blocks"]
    for _ in range(cfg.n_layers):
        _tally_mha(t, dec["self"], dsp["self"], act, None, fwd)
        _tally_mha(t, dec["cross"], dsp["cross"], act, act_enc, fwd)
        t.mlp(dec["mlp"], dsp["mlp"], act, fwd)


def _tally_mha(t, a, asp, act_q, act_kv, fwd):
    """:func:`_mha`'s collectives: the weights (the replicated kv heads'
    and ``bv`` psummed over "model" backward), the output's psum per run,
    and the entered inputs' psums backward (``act_kv`` a second input)."""
    heads_tp, kv_tp = t.tp(asp["wq"][-2]), t.tp(asp["wk"][-2])
    for name in sorted(a):
        whole = heads_tp and not kv_tp and name in ("wk", "wv", "bv")
        t.weight(a[name].shape[1:], asp[name][1:], fwd, whole)
    if heads_tp:
        t.add("psum", act_q, fwd + 1)
        if act_kv is not None:
            t.add("psum", act_kv)


def make_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, *, device=None):
    """Zeros on ``device`` (the card by default): the decoder's
    self-attention ``k``/``v`` (L, B, max_len, KV, hd) and the
    cross-attention ``xk``/``xv`` (L, B, enc_frames, KV, hd), which stay
    zero until the caller fills them (module docstring)."""
    from repro_torch import _device

    dev = _device.resolve(device)
    hd, n = cfg.resolved_head_dim, cfg.n_layers
    self_shape = (n, batch, max_len, cfg.n_kv_heads, hd)
    cross_shape = (n, batch, cfg.enc_frames, cfg.n_kv_heads, hd)
    return {"k": torch.zeros(self_shape, dtype=dtype, device=dev),
            "v": torch.zeros(self_shape, dtype=dtype, device=dev),
            "xk": torch.zeros(cross_shape, dtype=dtype, device=dev),
            "xv": torch.zeros(cross_shape, dtype=dtype, device=dev)}


def decode_step(params, tokens, cache, pos, cfg: ArchConfig, **_):
    """One decoder token for the whole batch: tokens (B,) int, ``pos`` a
    Python int. Self-attention against the cache, whose slot ``pos`` is
    written in place; cross-attention against the cache's ``xk``/``xv``
    over all ``enc_frames`` slots. Returns ``(logits (B, V), cache)``."""
    pos = operator.index(pos)
    if pos >= cache["k"].shape[2]:
        # JAX's update slice clamps such a write to the last slot
        raise ValueError(f"position {pos} is past the cache's "
                         f"{cache['k'].shape[2]} slots")
    b = tokens.shape[0]
    emb = params["embed"]
    x = (emb[tokens] + params["pos_dec"][pos]).to(emb.dtype)[:, None]
    cur = torch.full((b,), pos + 1, dtype=torch.int32, device=tokens.device)
    cur_x = torch.full((b,), cache["xk"].shape[2], dtype=torch.int32,
                       device=tokens.device)
    layer = {k: c.unbind(0) for k, c in cache.items()}
    for i, lp in enumerate(_tree.unstack(params["dec_blocks"])):
        sp, xp = lp["self"], lp["cross"]
        h = _ln(x, lp, "ln1", cfg.norm_eps)[:, 0]
        q = torch.einsum("bd,dhk->bhk", h, sp["wq"]) + sp["bq"]
        k = torch.einsum("bd,dhk->bhk", h, sp["wk"])
        v = torch.einsum("bd,dhk->bhk", h, sp["wv"]) + sp["bv"]
        kc, vc = layer["k"][i], layer["v"][i]
        kc[:, pos].copy_(k)
        vc[:, pos].copy_(v)
        a = L.attention_decode(q, kc, vc, cur)
        x = x + (torch.einsum("bhk,hkd->bd", a, sp["wo"]) + sp["bo"])[:, None]
        # cross-attention against the encoder's K/V
        h2 = _ln(x, lp, "ln15", cfg.norm_eps)[:, 0]
        q2 = torch.einsum("bd,dhk->bhk", h2, xp["wq"]) + xp["bq"]
        a2 = L.attention_decode(q2, layer["xk"][i], layer["xv"][i], cur_x)
        x = x + (torch.einsum("bhk,hkd->bd", a2, xp["wo"]) + xp["bo"])[:, None]
        x = x + _mlp(lp["mlp"], _ln(x, lp, "ln2", cfg.norm_eps))
    x = L.layer_norm(x, params["dec_norm_s"], params["dec_norm_b"], cfg.norm_eps)
    return x[:, 0] @ emb.T, cache
