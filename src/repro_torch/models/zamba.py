"""Zamba2-7B (arXiv:2411.15242), port of ``repro/models/zamba.py``: a
Mamba2 backbone plus ONE weight-shared attention+MLP block applied every
``attn_every`` layers.

81 layers = 13 super-groups of (5 mamba + 1 shared-attn application) + 3
trailing mamba layers. The shared block receives concat(x, x0) (the
embeddings re-injected, as in Zamba) projected back to d_model; the
per-application LoRA of the shared block is omitted, as in the JAX package.
The Mamba layers keep its double-stacked layout, ``mamba_super/w_in`` (n_super,
attn_every - 1, d, ...) and ``mamba_trailing/w_in`` (trailing, d, ...), so a
JAX parameter tree crosses over with ``interop.from_numpy_tree`` unchanged;
``lax.scan`` over a stack becomes a Python loop, and the trailing stack may
be empty (a depth cut to a multiple of ``attn_every``).

At sequence lengths >= hybrid.long_seq the shared attention switches to a
sliding window (hybrid.window_at_long), and its decode cache to a ring of
that many slots. The shared attention's heads are d_model / n_heads wide
(112 for zamba2-7b). The forward runs ``impl="chunked"`` by default (the
JAX package's training step passes no ``impl``, so its forward does too),
or ``"naive"``, or ``"flash"``: the flash kernels take zamba2-7b's 112
(as every multiple of 8 up to 128), and a width outside that raises.

Serving keeps an O(1) recurrent state per Mamba layer (the rolled conv
window and the SSM state, float32) and a KV cache for each shared-attention
site; :func:`decode_step` writes both in place.
"""

from __future__ import annotations

import operator

import torch

from repro_torch import _tree
from repro_torch.configs.types import ArchConfig

from . import layers as L
from . import lm
from .params import ParamDef


def _n_groups_trailing(cfg: ArchConfig):
    k = cfg.hybrid.attn_every
    n_super = cfg.n_layers // k
    trailing = cfg.n_layers - n_super * k
    return n_super, k - 1, trailing


def _stack(t, n, axis="layers"):
    return {k: ParamDef((n,) + pd.shape, (axis,) + pd.axes, pd.init, pd.scale)
            for k, pd in t.items()}


def template(cfg: ArchConfig):
    d = cfg.d_model
    n_super, m_per, trailing = _n_groups_trailing(cfg)
    mamba = L.mamba2_template(d, cfg.ssm)
    hd = cfg.resolved_head_dim
    shared = {
        "w_concat": ParamDef((2 * d, d), ("embed", None), "scaled"),
        "ln1": ParamDef((d,), (None,), "ones"),
        "wq": ParamDef((d, cfg.n_heads, hd), ("embed", "heads", None), "scaled"),
        "wk": ParamDef((d, cfg.n_kv_heads, hd), ("embed", "kv_heads", None), "scaled"),
        "wv": ParamDef((d, cfg.n_kv_heads, hd), ("embed", "kv_heads", None), "scaled"),
        "wo": ParamDef((cfg.n_heads, hd, d), ("heads", None, "embed"), "scaled"),
        "ln2": ParamDef((d,), (None,), "ones"),
        "mlp": L.mlp_template(d, cfg.d_ff, cfg.act),
        "norm_m": ParamDef((d,), (None,), "ones"),
    }
    return {
        "embed": ParamDef((cfg.vocab, d), ("vocab", "embed"), "normal", 0.02),
        "final_norm": ParamDef((d,), (None,), "ones"),
        "unembed": ParamDef((d, cfg.vocab), ("embed", "vocab"), "scaled"),
        "mamba_norm": {
            "super": ParamDef((n_super, m_per, d), ("layers", None, None), "ones"),
            "trailing": ParamDef((trailing, d), ("layers", None), "ones"),
        },
        "mamba_super": _stack(_stack(mamba, m_per), n_super, "super"),
        "mamba_trailing": _stack(mamba, trailing),
        "shared": shared,
    }


def _check_impl(cfg: ArchConfig, impl: str) -> None:
    """The shared attention's width against the flash kernels'."""
    if impl != "flash":
        return
    from repro_torch.kernels.flash_attention import HEAD_DIMS_TEXT, KERNEL_HEAD_DIMS

    hd = cfg.resolved_head_dim
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"{cfg.name}: the shared attention's heads are {hd} wide; the "
            f"flash kernels take {HEAD_DIMS_TEXT}: use impl='chunked' or "
            "'naive'")


def _shared_attn(sp, x, x0, cfg: ArchConfig, *, positions, impl, window,
                 cache=None, pos=None, cur=None, freqs=None, sh=None,
                 specs=None):
    """The weight-shared transformer block: x + attention + MLP of
    concat(x, x0)'s projection. Without ``cache`` over the sequence
    (``positions``); with ``cache`` ({"k", "v"} (B, T, KV, hd) of this
    site) one token at the Python int ``pos``, written in place at slot
    ``pos`` (``pos % T`` under a window), ``cur`` the valid length and
    ``freqs`` the rotary angles of ``pos``. Under a mesh (``sh``, ``specs``
    the block's specs) the attention and the MLP run on this rank's heads
    and ffn slice (``lm._attn_sharded``, ``lm._mlp_sharded``) and
    ``w_concat`` is FSDP-gathered."""
    w_concat = sp["w_concat"] if sh is None else sh.weight(sp["w_concat"],
                                                           specs["w_concat"])
    h = torch.cat([x, x0], dim=-1) @ w_concat
    hn = L.rms_norm(h, sp["ln1"], cfg.norm_eps)
    if sh is not None:
        attn = {k: sp[k] for k in _ATTN}
        a = lm._attn_sharded(attn, {k: specs[k] for k in _ATTN}, hn, cfg, sh,
                             positions=positions, impl=impl, window=window)
    elif cache is None:
        a = lm._attn_dense(sp, hn, cfg, positions=positions, impl=impl,
                           window=window)
    else:
        a = lm._attn_dense_decode(sp, hn, cfg, pos=pos, cur=cur, freqs=freqs,
                                  cache=cache, window=window)
    h2 = h + a
    h2n = L.rms_norm(h2, sp["ln2"], cfg.norm_eps)
    y = (L.mlp_apply(sp["mlp"], h2n, cfg.act) if sh is None else
         lm._mlp_sharded(sp["mlp"], specs["mlp"], h2n, cfg.act, sh))
    return x + a + y  # block delta re-joins the backbone stream


_ATTN = ("wq", "wk", "wv", "wo")   # the shared block's attention leaves


def _window_for(cfg: ArchConfig, seq_len: int):
    hy = cfg.hybrid
    return hy.window_at_long if seq_len >= hy.long_seq else None


def forward(params, tokens, cfg: ArchConfig, *, impl="chunked", remat=True,
            act_spec=None, mesh=None, param_specs=None):
    """tokens (B, S) int -> (logits (B, S, V), 0.0). ``remat`` recomputes
    each Mamba layer in the backward (``torch.utils.checkpoint``; JAX's
    ``jax.checkpoint`` of the layer); ``act_spec`` has no effect without a
    mesh, as in ``models.lm``.

    ``mesh`` and ``param_specs`` run the sharded forward (``models.lm``'s
    module docstring) on this rank's shards and slice of the batch: the
    shared block on its heads and ffn slice at every site (its weights'
    gradients add up over the sites), each Mamba layer whole on every rank
    of a "model" line with its weights gathered (``w_in``'s fused ``[z | x
    | B | C | dt]`` axis splits over "model" in pieces that do not line up
    with the SSM heads; the gradient is sliced back to the shard), and the
    logits this rank's slice of the vocabulary where "model" shards it."""
    if (mesh is None) != (param_specs is None):
        raise ValueError("a sharded forward takes both mesh= and param_specs=")
    _check_impl(cfg, impl)
    b, s = tokens.shape
    sh = None if mesh is None else lm._Sharded(mesh, param_specs)
    x0 = (params["embed"][tokens] if sh is None else
          lm.embed_sharded(params, param_specs, tokens, sh))
    x0 = x0.to(params["final_norm"].dtype)
    x = x0
    positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
    window = _window_for(cfg, s)

    def mamba(lp, lsp, norm, x):
        def body(x, lp=lp, norm=norm):
            w = lp if sh is None else sh.tree(lp, lsp)
            y, _ = L.mamba2_apply(w, L.rms_norm(x, norm, cfg.norm_eps), cfg.ssm)
            return y + x

        return lm.checkpointed(body, x, sh is not None) if remat else body(x)

    def layer_specs(name, strip):
        return None if sh is None else _tree.tree_map(
            lambda sp: tuple(sp[strip:]), param_specs[name])

    sup, trail = layer_specs("mamba_super", 2), layer_specs("mamba_trailing", 1)
    shared_sp = None if sh is None else param_specs["shared"]
    norms = params["mamba_norm"]
    for lps, ns in zip(_tree.unstack(params["mamba_super"]), norms["super"].unbind(0)):
        for lp, norm in zip(_tree.unstack(lps), ns.unbind(0)):
            x = mamba(lp, sup, norm, x)
        x = _shared_attn(params["shared"], x, x0, cfg, positions=positions,
                         impl=impl, window=window, sh=sh, specs=shared_sp)
    for lp, norm in zip(_tree.unstack(params["mamba_trailing"]),
                        norms["trailing"].unbind(0)):
        x = mamba(lp, trail, norm, x)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if sh is None:
        return x @ params["unembed"], 0.0
    return lm.logits_sharded(x, params, param_specs, cfg, sh), 0.0


def tally(t, cfg: ArchConfig, param_specs, batch: int, seq: int, *,
          remat: bool) -> None:
    """The sharded forward's and backward's collectives on one rank into
    ``t`` (``lm.Tally``): the top level's, each Mamba layer's whole
    gathers (twice forward under ``remat``) and each shared-attention
    site's FSDP gather of ``w_concat``, attention and MLP (the block is not
    recomputed)."""
    tpl = template(cfg)
    act = batch * seq * cfg.d_model * t.itemsize
    t.top(cfg, tpl, param_specs, act, batch * seq)
    n_super, m_per, trailing = _n_groups_trailing(cfg)
    fwd = 2 if remat else 1
    for _ in range(n_super * m_per):
        t.tree(tpl["mamba_super"], param_specs["mamba_super"], fwd, strip=2)
    for _ in range(trailing):
        t.tree(tpl["mamba_trailing"], param_specs["mamba_trailing"], fwd,
               strip=1)
    shared, ssp = tpl["shared"], param_specs["shared"]
    for _ in range(n_super):
        t.weight(shared["w_concat"].shape, ssp["w_concat"])
        t.attn({k: shared[k] for k in _ATTN}, ssp, act, 1, strip=0)
        t.mlp(shared["mlp"], ssp["mlp"], act, 1, strip=0)


def make_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, *, device=None):
    """Zeros on ``device`` (the card by default): each Mamba layer's conv
    window (``dtype``) and SSM state (float32), stacked as the parameters
    are, and the KV cache of each shared-attention site, a ring of
    ``window`` slots when ``max_len`` reaches ``long_seq``."""
    from repro_torch import _device

    dev = _device.resolve(device)
    n_super, m_per, trailing = _n_groups_trailing(cfg)
    ssm = cfg.ssm
    di = ssm.expand * cfg.d_model
    h = di // ssm.head_dim
    gn = ssm.n_groups * ssm.d_state
    window = _window_for(cfg, max_len)
    t = min(max_len, window) if window else max_len
    hd = cfg.resolved_head_dim

    def z(shape, dt):
        return torch.zeros(shape, dtype=dt, device=dev)

    f32 = torch.float32
    return {
        "conv_super": z((n_super, m_per, batch, ssm.d_conv, di + 2 * gn), dtype),
        "ssm_super": z((n_super, m_per, batch, h, ssm.d_state, ssm.head_dim), f32),
        "conv_trail": z((trailing, batch, ssm.d_conv, di + 2 * gn), dtype),
        "ssm_trail": z((trailing, batch, h, ssm.d_state, ssm.head_dim), f32),
        "k": z((n_super, batch, t, cfg.n_kv_heads, hd), dtype),
        "v": z((n_super, batch, t, cfg.n_kv_heads, hd), dtype),
    }


def decode_step(params, tokens, cache, pos, cfg: ArchConfig, *, max_len=None):
    """One token for the whole batch: tokens (B,) int, ``pos`` a Python int.
    Returns ``(logits (B, V), cache)`` with ``cache`` (:func:`make_cache`)
    updated in place. The shared attention is windowed when ``max_len``
    (the cache's length by default) reaches ``long_seq``, over at most the
    cache's slots: a ring cache needs ``max_len``, and a position past an
    unwindowed cache raises."""
    pos = operator.index(pos)
    b = tokens.shape[0]
    x0 = params["embed"][tokens][:, None].to(params["final_norm"].dtype)
    x = x0
    t = cache["k"].shape[2]
    window = _window_for(cfg, max_len or t)
    if window is not None and t < window:
        window = t
    if window is None and pos >= t:
        # JAX's update slice clamps such a write to the last slot
        raise ValueError(
            f"{cfg.name}: position {pos} is past the cache's {t} slots; a "
            "ring cache (max_len >= long_seq) decodes with max_len= given")
    where = torch.full((b, 1), pos, dtype=torch.int32, device=tokens.device)
    freqs = L.rope_frequencies(cfg.resolved_head_dim, cfg.rope_pct,
                               cfg.rope_theta, where)
    cur = torch.full((b,), pos + 1, dtype=torch.int32, device=tokens.device)

    def mamba(lp, norm, x, conv, ssm):
        y, (conv_new, ssm_new) = L.mamba2_apply(
            lp, L.rms_norm(x, norm, cfg.norm_eps), cfg.ssm, state=(conv, ssm))
        conv.copy_(conv_new)
        ssm.copy_(ssm_new)
        return x + y

    norms = params["mamba_norm"]
    for i, (lps, ns) in enumerate(zip(_tree.unstack(params["mamba_super"]),
                                      norms["super"].unbind(0))):
        for j, (lp, norm) in enumerate(zip(_tree.unstack(lps), ns.unbind(0))):
            x = mamba(lp, norm, x, cache["conv_super"][i, j],
                      cache["ssm_super"][i, j])
        x = _shared_attn(params["shared"], x, x0, cfg, positions=None,
                         impl=None, window=window,
                         cache={"k": cache["k"][i], "v": cache["v"][i]},
                         pos=pos, cur=cur, freqs=freqs)
    for j, (lp, norm) in enumerate(zip(_tree.unstack(params["mamba_trailing"]),
                                       norms["trailing"].unbind(0))):
        x = mamba(lp, norm, x, cache["conv_trail"][j], cache["ssm_trail"][j])
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x[:, 0] @ params["unembed"], cache
