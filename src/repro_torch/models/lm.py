"""Decoder-only LM, dense family (port of ``repro/models/lm.py:34-331``):
stablelm / danube / granite / qwen3 / chameleon (GQA, sliding window,
qk-norm, partial rotary).

Layers keep the JAX package's **stacked** layout — ``blocks/attn/wq`` is
(L, d, H, hd), ``blocks/mlp/w_up`` (L, d, f) — so a JAX parameter tree
crosses over with ``interop.from_numpy_tree`` unchanged. ``lax.scan`` over
the stack becomes a Python loop over the layer index.

    forward(params, tokens, cfg, *, impl, collect) -> logits, aux[, acts]

MLA, MoE, ``prefill``, ``decode_step`` and the caches wait for their slices.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import _tree
from repro_torch.configs.types import ArchConfig

from . import layers as L
from .params import ParamDef


def _check_dense(cfg: ArchConfig) -> None:
    if cfg.mla is not None or cfg.moe is not None:
        raise ValueError(
            f"{cfg.name}: the port's LM covers the dense family; MLA and MoE "
            "wait for their slice")


# ------------------------------------------------------------------ templates
def _attn_template(cfg: ArchConfig, n: int):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    t = {
        "wq": ParamDef((n, d, cfg.n_heads, hd), ("layers", "embed", "heads", None),
                       "scaled"),
        "wk": ParamDef((n, d, cfg.n_kv_heads, hd),
                       ("layers", "embed", "kv_heads", None), "scaled"),
        "wv": ParamDef((n, d, cfg.n_kv_heads, hd),
                       ("layers", "embed", "kv_heads", None), "scaled"),
        "wo": ParamDef((n, cfg.n_heads, hd, d), ("layers", "heads", None, "embed"),
                       "scaled"),
    }
    if cfg.qk_norm:
        t["qn"] = ParamDef((n, hd), ("layers", None), "ones")
        t["kn"] = ParamDef((n, hd), ("layers", None), "ones")
    return t


def _stack_mlp(cfg: ArchConfig, n: int):
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_up": ParamDef((n, d, f), ("layers", "embed", "ffn"), "scaled"),
        "w_gate": ParamDef((n, d, f), ("layers", "embed", "ffn"), "scaled"),
        "w_down": ParamDef((n, f, d), ("layers", "ffn", "embed"), "scaled"),
    }


def _block_template(cfg: ArchConfig, n: int):
    return {
        "ln1": ParamDef((n, cfg.d_model), ("layers", None), "ones"),
        "ln2": ParamDef((n, cfg.d_model), ("layers", None), "ones"),
        "attn": _attn_template(cfg, n),
        "mlp": _stack_mlp(cfg, n),
    }


def template(cfg: ArchConfig):
    _check_dense(cfg)
    d = cfg.d_model
    t = {
        "embed": ParamDef((cfg.vocab, d), ("vocab", "embed"), "normal", 0.02),
        "final_norm": ParamDef((d,), (None,), "ones"),
        "blocks": _block_template(cfg, cfg.n_layers),
    }
    if not cfg.tie_embeddings:
        t["unembed"] = ParamDef((d, cfg.vocab), ("embed", "vocab"), "scaled")
    return t


# ------------------------------------------------------------------ attention
def _attn_dense(lp, h, cfg: ArchConfig, *, positions, impl, window):
    """Standard (GQA) attention. h (B,S,D) -> (B,S,D)."""
    hd = cfg.resolved_head_dim
    q = torch.einsum("bsd,dhk->bshk", h, lp["wq"])
    k = torch.einsum("bsd,dhk->bshk", h, lp["wk"])
    v = torch.einsum("bsd,dhk->bshk", h, lp["wv"])
    if cfg.qk_norm:
        q = L.rms_norm(q, lp["qn"], cfg.norm_eps)
        k = L.rms_norm(k, lp["kn"], cfg.norm_eps)
    freqs = L.rope_frequencies(hd, cfg.rope_pct, cfg.rope_theta, positions)
    q = L.apply_rope(q, freqs)
    k = L.apply_rope(k, freqs)
    out = L.attention(q, k, v, causal=True, window=window, impl=impl)
    return torch.einsum("bshk,hkd->bsd", out, lp["wo"])


# --------------------------------------------------------------------- blocks
def _block(lp, x, cfg: ArchConfig, *, positions, impl, collect=None):
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    x = x + _attn_dense(lp["attn"], h, cfg, positions=positions, impl=impl,
                        window=cfg.window)
    y = L.mlp_apply(lp["mlp"], L.rms_norm(x, lp["ln2"], cfg.norm_eps), cfg.act)
    out = x + y
    # harvest sites (data/activations.py): the post-block residual stream or
    # the MLP branch output (pre-residual-add)
    cap = None if collect is None else (out if collect == "resid" else y)
    return out, cap


def forward(params, tokens, cfg: ArchConfig, *, impl="chunked", remat=True,
            collect=None):
    """tokens (B, S) int -> (logits (B, S, V), aux).

    ``collect``: None | "resid" | "mlp" — also return the per-layer
    activations stacked on a leading layer axis, shape (L, B, S, D): the
    post-block residual stream or the MLP branch output (the capture point
    of ``data/activations.py``). ``remat=True`` recomputes each block in the
    backward pass (``torch.utils.checkpoint``); harvesting passes
    ``remat=False``. ``aux`` is 0.0 (the MoE balance loss of the JAX
    package has no dense counterpart).
    """
    _check_dense(cfg)
    b, s = tokens.shape
    x = params["embed"][tokens].to(params["final_norm"].dtype)
    positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
    blocks = params["blocks"]
    # unbind each stacked leaf once: its backward stacks the layers'
    # gradients in one pass, where a[i] per layer would give every layer a
    # full-size zero gradient of the stack to sum
    per_layer = [a.unbind(0) for a in _tree.leaves(blocks)]
    caps = []
    for i in range(cfg.n_layers):
        lp = _tree.unflatten_like(blocks, [u[i] for u in per_layer])

        def body(x, lp=lp):
            return _block(lp, x, cfg, positions=positions, impl=impl,
                          collect=collect)

        x, cap = checkpoint(body, x, use_reentrant=False) if remat else body(x)
        caps.append(cap)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    un = params.get("unembed")
    logits = x @ un if un is not None else x @ params["embed"].T
    if collect is not None:
        return logits, 0.0, torch.stack(caps)
    return logits, 0.0
