"""Decoder-only LM (port of ``repro/models/lm.py``): the dense family,
stablelm / danube / granite / qwen3 / chameleon (GQA, sliding window,
qk-norm, partial rotary), and the MoE family, deepseek-v3 / kimi-k2 (MLA
attention and GShard mixture-of-experts layers).

Layers keep the JAX package's **stacked** layout — ``blocks/attn/wq`` is
(L, d, H, hd), ``blocks/mlp/w_up`` (L, d, f) — so a JAX parameter tree
crosses over with ``interop.from_numpy_tree`` unchanged. ``lax.scan`` over
the stack becomes a Python loop over the layer index. An MoE model has two
stacks, ``dense_blocks`` (its ``first_dense`` leading dense layers) and
``moe_blocks``, whose expert leaves carry an ``experts`` axis after the
layer axis (``moe_blocks/mlp/w_up`` is (L, E, d, f)).

    forward(params, tokens, cfg, *, impl, n_groups, remat, act_spec,
            collect, mesh, param_specs) -> logits, aux[, acts]

MLA (``cfg.mla``) trains and prefills with the full expansion
(:func:`_attn_mla`): q/k heads of ``qk_nope + qk_rope`` channels (the rope
part of k is one head, rotated and broadcast to all), v heads of
``v_head_dim``. Those widths differ, which the flash kernels do not take:
MLA runs ``impl="chunked"`` or ``"naive"``, and ``"flash"`` raises.

Under a mesh (``mesh=`` a ``parallel.mesh.Mesh``, ``param_specs=`` the
spec tree of ``models.params.param_specs``) ``params`` are this rank's
shards and ``tokens`` this rank's slice of the batch, and the forward is
the one GSPMD makes of the JAX package's under its shardings, with the
collectives written out (``parallel/collectives.py``). Here it covers the
dense and MoE families (the audio, hybrid and recurrent families' own
forwards build on :class:`_Sharded`):

* each weight's FSDP axis ('embed' over "data") is all-gathered where it
  is used — inside the checkpointed block body, so the recompute gathers
  again — and its gradient psummed back to the shard;
* attention runs on this rank's heads (q (B/D, S, H/M, hd) and the kv
  heads those q heads read: the local slice when ``kv_heads`` is sharded,
  else the replicated kv heads each local q head maps to, h // (H/KV)),
  the MLP on its ffn slice; each branch is entered with an identity whose
  gradient is psummed over "model" and left with a psum over "model"
  after ``wo`` and after ``w_down``. Weights the branch uses whole (a
  replicated ``wk``/``wv``, the qk-norm scales) are entered too, so their
  gradient is summed over the heads of every rank;
* MLA runs on this rank's heads: ``wq_b``, ``wkv_b`` and ``wo`` are split
  over "model" on their heads axis, and the low-rank ``wq_a``/``wkv_a``
  and their norms are used whole inside the branch (entered, so their
  gradient sums every rank's heads, as does the one rotated ``k_rope``
  head that all heads share);
* an MoE layer routes every token over all the experts on every rank
  (the router is replicated over "model"), then runs this rank's experts
  (``experts`` over "model") and its slice of the shared expert's ffn
  inside one branch left with one psum. The gates enter the branch too:
  each rank's experts give a part of their gradient, which the psum
  completes, and the routing's backward (the balance loss included) then
  runs alike on every rank, so the router's gradient counts the balance
  loss once. The dispatch's groups follow JAX's ``n_groups`` (the
  launcher's ``dp_shards``): this rank's tokens hold ``n_groups`` over the
  batch split of them, with the global ``tg`` and ``cap``; the balance
  loss is this rank's groups' mean, which the step averages over the
  batch axes with the loss;
* a vocabulary sharded over "model" gives a masked lookup plus psum, and
  logits of this rank's slice of the vocabulary (:func:`logits_spec`),
  which ``training.step`` turns into the loss with ``vocab_xent``.

A dimension that the mesh does not divide is replicated
(``param_specs``), and its part of the forward runs whole on every rank.

Serving (``repro/models/lm.py:149-241, 335-414``): :func:`make_cache`
allocates the stacked per-layer cache and :func:`decode_step` runs one
token for the whole batch, writing each layer's new entries into the
cache in place at a slot the caller's Python ``pos`` decides on the host.
A dense model caches k/v (a ring buffer of ``window`` slots when the model
is windowed); an MLA model caches only the compressed ``c_kv`` and the
rotated ``k_rope`` (``kv_lora_rank + qk_rope_dim`` values a token and
layer) and decodes with weight absorption (:func:`_attn_mla_decode`).
"""

from __future__ import annotations

import dataclasses
import math
import operator

import torch
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from repro_torch import _tree
from repro_torch.configs.types import ArchConfig
from repro_torch.parallel import collectives as C

from . import layers as L
from .params import ParamDef

RECURRENT = ("ssm", "hybrid")   # the families with a recurrent decode state


def _check_impl(cfg: ArchConfig, impl: str) -> None:
    """MLA's q/k and v heads differ in width, which no flash kernel takes."""
    if cfg.mla is not None and impl == "flash":
        from repro_torch.kernels.flash_attention import HEAD_DIMS_TEXT

        m = cfg.mla
        raise ValueError(
            f"{cfg.name}: MLA's q/k heads are {m.qk_nope_dim + m.qk_rope_dim} "
            f"wide ({m.qk_nope_dim} nope + {m.qk_rope_dim} rope) and its v "
            f"heads {m.v_head_dim}; the flash kernels take q, k and v of one "
            f"width, {HEAD_DIMS_TEXT}: use impl='chunked' or 'naive'")


def cut_depth(cfg: ArchConfig, n_layers: int) -> ArchConfig:
    """``cfg`` cut to its first ``n_layers`` layers at full width (the
    launchers' ``--layers``). An MoE model keeps its ``first_dense`` dense
    layers, so it needs more than that many, or no MoE layer is left. A
    hybrid (zamba) model takes any depth: ``attn_every`` layers make a
    super-group (Mamba layers and one shared-attention application), the
    rest trail. An xLSTM model counts whole super-blocks of
    ``slstm_every`` layers (the rest are dropped, as its template does), so
    it needs at least one. An encoder-decoder (whisper) is cut to
    ``n_layers`` encoder and ``n_layers`` decoder layers."""
    if n_layers < 1:
        raise ValueError(f"{cfg.name}: a model needs a layer, got {n_layers}")
    if cfg.moe is not None and n_layers <= cfg.moe.first_dense:
        raise ValueError(
            f"{cfg.name}: {n_layers} layers leave no MoE layer; its first "
            f"{cfg.moe.first_dense} layers are dense, so cut to more than "
            f"{cfg.moe.first_dense}")
    if cfg.xlstm is not None and n_layers < cfg.xlstm.slstm_every:
        raise ValueError(
            f"{cfg.name}: {n_layers} layers leave no xLSTM super-block; it "
            f"stacks blocks of {cfg.xlstm.slstm_every} layers "
            f"({cfg.xlstm.slstm_every - 1} mLSTM + 1 sLSTM), so cut to at "
            f"least {cfg.xlstm.slstm_every}")
    if cfg.n_enc_layers:
        return dataclasses.replace(cfg, n_layers=n_layers, n_enc_layers=n_layers)
    return dataclasses.replace(cfg, n_layers=n_layers)


def stacks(cfg: ArchConfig) -> list:
    """``[(name, moe, n_layers), ...]``: the model's layer stacks in order
    (an MoE model's dense stack first)."""
    if cfg.moe is None:
        return [("blocks", False, cfg.n_layers)]
    fd = cfg.moe.first_dense
    out = [("dense_blocks", False, fd)] if fd else []
    return out + [("moe_blocks", True, cfg.n_layers - fd)]


# ------------------------------------------------------------------ templates
def _attn_template(cfg: ArchConfig, n: int):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    if cfg.mla is not None:
        m = cfg.mla
        qk = m.qk_nope_dim + m.qk_rope_dim
        return {
            "wq_a": ParamDef((n, d, m.q_lora_rank), ("layers", "embed", None), "scaled"),
            "q_norm": ParamDef((n, m.q_lora_rank), ("layers", None), "ones"),
            "wq_b": ParamDef((n, m.q_lora_rank, cfg.n_heads, qk),
                             ("layers", None, "heads", None), "scaled"),
            "wkv_a": ParamDef((n, d, m.kv_lora_rank + m.qk_rope_dim),
                              ("layers", "embed", None), "scaled"),
            "kv_norm": ParamDef((n, m.kv_lora_rank), ("layers", None), "ones"),
            "wkv_b": ParamDef((n, m.kv_lora_rank, cfg.n_heads,
                               m.qk_nope_dim + m.v_head_dim),
                              ("layers", None, "heads", None), "scaled"),
            "wo": ParamDef((n, cfg.n_heads, m.v_head_dim, d),
                           ("layers", "heads", None, "embed"), "scaled"),
        }
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


def _stack_moe(cfg: ArchConfig, n: int):
    mo = cfg.moe
    d, e, f = cfg.d_model, mo.n_experts, mo.d_expert
    t = {
        "router": ParamDef((n, d, e), ("layers", "embed", None), "scaled"),
        "w_gate": ParamDef((n, e, d, f), ("layers", "experts", "embed", "expert_ff"),
                           "scaled"),
        "w_up": ParamDef((n, e, d, f), ("layers", "experts", "embed", "expert_ff"),
                         "scaled"),
        "w_down": ParamDef((n, e, f, d), ("layers", "experts", "expert_ff", "embed"),
                           "scaled"),
    }
    if mo.n_shared:
        ds = (mo.d_shared or mo.d_expert) * mo.n_shared
        t["shared"] = {
            "w_up": ParamDef((n, d, ds), ("layers", "embed", "ffn"), "scaled"),
            "w_gate": ParamDef((n, d, ds), ("layers", "embed", "ffn"), "scaled"),
            "w_down": ParamDef((n, ds, d), ("layers", "ffn", "embed"), "scaled"),
        }
    return t


def _block_template(cfg: ArchConfig, n: int, moe: bool = False):
    return {
        "ln1": ParamDef((n, cfg.d_model), ("layers", None), "ones"),
        "ln2": ParamDef((n, cfg.d_model), ("layers", None), "ones"),
        "attn": _attn_template(cfg, n),
        "mlp": _stack_moe(cfg, n) if moe else _stack_mlp(cfg, n),
    }


def template(cfg: ArchConfig):
    d = cfg.d_model
    t = {
        "embed": ParamDef((cfg.vocab, d), ("vocab", "embed"), "normal", 0.02),
        "final_norm": ParamDef((d,), (None,), "ones"),
    }
    for name, moe, n in stacks(cfg):
        t[name] = _block_template(cfg, n, moe)
    if not cfg.tie_embeddings:
        t["unembed"] = ParamDef((d, cfg.vocab), ("embed", "vocab"), "scaled")
    return t


# ------------------------------------------------------------------ attention
def _attn_dense(lp, h, cfg: ArchConfig, *, positions, impl, window,
                pick_kv=None):
    """Standard (GQA) attention. h (B,S,D) -> (B,S,D). ``pick_kv`` selects
    the kv heads the q heads read (a rank's own q heads, under a mesh)."""
    hd = cfg.resolved_head_dim
    q = torch.einsum("bsd,dhk->bshk", h, lp["wq"])
    k = torch.einsum("bsd,dhk->bshk", h, lp["wk"])
    v = torch.einsum("bsd,dhk->bshk", h, lp["wv"])
    if cfg.qk_norm:
        q = L.rms_norm(q, lp["qn"], cfg.norm_eps)
        k = L.rms_norm(k, lp["kn"], cfg.norm_eps)
    if pick_kv is not None:
        k, v = pick_kv(k), pick_kv(v)
    freqs = L.rope_frequencies(hd, cfg.rope_pct, cfg.rope_theta, positions)
    q = L.apply_rope(q, freqs)
    k = L.apply_rope(k, freqs)
    out = L.attention(q, k, v, causal=True, window=window, impl=impl)
    return torch.einsum("bshk,hkd->bsd", out, lp["wo"])


def _attn_dense_decode(lp, h, cfg: ArchConfig, *, pos: int, cur, freqs,
                       cache, window):
    """h (B,1,D); ``cache`` this layer's {"k", "v"} (B,T,KV,hd), written in
    place at slot ``pos`` (``pos % T`` for a windowed model's ring);
    ``cur`` (B,) the valid length ``pos + 1`` on the device; ``freqs`` the
    rotary angles of ``pos``."""
    hq = h[:, 0]
    q = torch.einsum("bd,dhk->bhk", hq, lp["wq"])
    k = torch.einsum("bd,dhk->bhk", hq, lp["wk"])
    v = torch.einsum("bd,dhk->bhk", hq, lp["wv"])
    if cfg.qk_norm:
        q = L.rms_norm(q, lp["qn"], cfg.norm_eps)
        k = L.rms_norm(k, lp["kn"], cfg.norm_eps)
    q = L.apply_rope(q[:, None], freqs)[:, 0]
    k = L.apply_rope(k[:, None], freqs)[:, 0]
    kc, vc = cache["k"], cache["v"]
    slot = pos % kc.shape[1] if window is not None else pos
    kc[:, slot].copy_(k)
    vc[:, slot].copy_(v)
    out = L.attention_decode(q, kc, vc, cur, window=window)
    return torch.einsum("bhk,hkd->bd", out, lp["wo"])[:, None]


def _attn_mla(lp, h, cfg: ArchConfig, *, positions, impl, window):
    """MLA training/prefill attention, the full expansion. h (B,S,D) ->
    (B,S,D). k's rope part is one head, rotated, then broadcast to every
    head (the heads ``wq_b`` holds: a rank's own under a mesh); the scale
    is (qk_nope + qk_rope)^-0.5, q's width."""
    m = cfg.mla
    b, s, _ = h.shape
    q_lat = L.rms_norm(torch.einsum("bsd,dr->bsr", h, lp["wq_a"]),
                       lp["q_norm"], cfg.norm_eps)
    q = torch.einsum("bsr,rhk->bshk", q_lat, lp["wq_b"])
    q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    kv_a = torch.einsum("bsd,dr->bsr", h, lp["wkv_a"])
    c_kv = L.rms_norm(kv_a[..., :m.kv_lora_rank], lp["kv_norm"], cfg.norm_eps)
    k_rope = kv_a[..., m.kv_lora_rank:]                       # (B,S,rope)
    kv = torch.einsum("bsr,rhk->bshk", c_kv, lp["wkv_b"])
    k_nope, v = kv[..., :m.qk_nope_dim], kv[..., m.qk_nope_dim:]

    freqs = L.rope_frequencies(m.qk_rope_dim, 1.0, cfg.rope_theta, positions)
    q_rope = L.apply_rope(q_rope, freqs)
    k_rope = L.apply_rope(k_rope[:, :, None, :], freqs)       # one kv head
    k_rope = k_rope.expand(b, s, q.shape[2], m.qk_rope_dim)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat([k_nope, k_rope], dim=-1)
    out = L.attention(q_full, k_full, v, causal=True, window=window, impl=impl)
    return torch.einsum("bshk,hkd->bsd", out, lp["wo"])


def _attn_mla_decode(lp, h, cfg: ArchConfig, *, pos: int, freqs, cache):
    """MLA decode with weight absorption. h (B,1,D); ``cache`` this layer's
    {"c_kv" (B,T,r), "k_rope" (B,T,rope)}, written in place at slot
    ``pos``; ``freqs`` the rotary angles of ``pos``.

    ``W_kv_b``'s k part folds into the query (``q_eff = q_nope·W_kᵀ``, in
    the latent space of ``c_kv``) and its v part into the output, so the
    logits and the softmax-weighted sum run over the cached latents
    themselves, in float32; the latent output is cast to the compute dtype
    before ``W_kv_b``."""
    m = cfg.mla
    hq = h[:, 0]
    q_lat = L.rms_norm(hq @ lp["wq_a"], lp["q_norm"], cfg.norm_eps)
    q = torch.einsum("br,rhk->bhk", q_lat, lp["wq_b"])
    q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    kv_a = hq @ lp["wkv_a"]
    c_kv = L.rms_norm(kv_a[..., :m.kv_lora_rank], lp["kv_norm"], cfg.norm_eps)
    q_rope = L.apply_rope(q_rope[:, None], freqs)[:, 0]
    k_rope = L.apply_rope(kv_a[:, None, None, m.kv_lora_rank:], freqs)[:, 0, 0]
    ck, kr = cache["c_kv"], cache["k_rope"]
    ck[:, pos].copy_(c_kv)
    kr[:, pos].copy_(k_rope)

    wk = lp["wkv_b"][..., :m.qk_nope_dim]                      # (r, H, nope)
    q_eff = torch.einsum("bhk,rhk->bhr", q_nope, wk)           # (B, H, r)
    scale = (m.qk_nope_dim + m.qk_rope_dim) ** -0.5
    ckf = ck.float()
    lat = torch.einsum("bhr,btr->bht", q_eff.float(), ckf)
    rop = torch.einsum("bhk,btk->bht", q_rope.float(), kr.float())
    logits = (lat + rop) * scale
    valid = torch.arange(ck.shape[1], device=h.device) <= pos
    logits = torch.where(valid, logits, torch.full((), L._NEG, device=h.device))
    w = torch.softmax(logits, dim=-1)
    lat_out = torch.einsum("bht,btr->bhr", w, ckf)             # (B, H, r)
    wv = lp["wkv_b"][..., m.qk_nope_dim:]                      # (r, H, v)
    out = torch.einsum("bhr,rhk->bhk", lat_out.to(h.dtype), wv)
    return torch.einsum("bhk,hkd->bd", out, lp["wo"])[:, None]


# -------------------------------------------------------------- under a mesh
class _Sharded:
    """A mesh and one layer's (or the top level's) specs: which axes are
    tensor parallel, and each weight made ready for use."""

    def __init__(self, mesh, specs):
        self.mesh, self.specs = mesh, specs

    def tp(self, entry) -> bool:
        """Is an axis with this spec entry split over a live "model" axis?"""
        return entry == "model" and self.mesh.shape["model"] > 1

    def weight(self, w, spec, whole: bool = False):
        """The FSDP-gathered weight; ``whole``: it is replicated over
        "model" but used inside a tensor-parallel branch, so its gradient
        is psummed over "model"."""
        w = C.gather_spec(w, spec, self.mesh)
        return C.enter(w, self.mesh) if whole else w

    def full(self, w, spec, split: bool = False):
        """The whole weight on every rank: FSDP-gathered, then gathered over
        "model" where that shards it (last, whatever the axis). Backward,
        the "model" gather only slices this rank's part out of the gradient
        (every rank ran the same computation on it), or psums it first when
        ``split``: each rank read other parts of it (its own heads' columns
        of a fused projection)."""
        w = C.gather_spec(w, spec, self.mesh)
        for axis, name in enumerate(spec):
            if name == "model":
                w = C.gather(w, self.mesh, "model", axis, sum_grad=split)
        return w

    def tree(self, p, sp):
        """:meth:`full` of every leaf of a block: the block runs whole."""
        return {k: self.tree(v, sp[k]) if isinstance(v, dict)
                else self.full(v, sp[k]) for k, v in p.items()}


def local_slice(n: int, sh: _Sharded) -> slice:
    """This rank's contiguous part of an axis of ``n`` split over "model"."""
    m, size = sh.mesh.axis_index("model"), sh.mesh.shape["model"]
    return slice(m * n // size, (m + 1) * n // size)


def batch_split(mesh, act_spec=None) -> int:
    """Over how many ranks the batch is split: the mesh size over the axes
    of ``act_spec``'s batch entry (None: not split), by default over the
    batch axes."""
    from repro_torch.parallel import sharding

    if act_spec is None:
        return sharding.dp_shards(mesh)
    return sharding.entry_size(act_spec[0], mesh.shape)


def checkpointed(body, x, sharded: bool):
    """``body(x)`` recomputed in the backward. Under a mesh the recompute
    runs the whole body, so every rank's collectives are the forward's
    twice whatever the checkpoint's early stop."""
    if not sharded:
        return checkpoint(body, x, use_reentrant=False)
    with set_checkpoint_early_stop(False):
        return checkpoint(body, x, use_reentrant=False)


def embed_sharded(params, param_specs, tokens, sh: _Sharded):
    """The embedding lookup of this rank's tokens: a masked lookup and a
    psum where "model" shards the vocabulary."""
    table = sh.weight(params["embed"], param_specs["embed"])
    if sh.tp(param_specs["embed"][0]):
        return C.vocab_embed(table, tokens, sh.mesh)
    return table[tokens]


def logits_sharded(x, params, param_specs, cfg: ArchConfig, sh: _Sharded):
    """The logits of the final activations: this rank's slice of the
    vocabulary (:func:`logits_spec`) through ``unembed``, or through the
    embedding's transpose where the model ties them."""
    if logits_spec(cfg, param_specs, sh.mesh)[-1] == "model":
        x = C.enter(x, sh.mesh)
    un = params.get("unembed")
    if un is not None:
        return x @ sh.weight(un, param_specs["unembed"])
    return x @ sh.weight(params["embed"], param_specs["embed"]).T


def _kv_for_local_heads(k, cfg: ArchConfig, sh: _Sharded):
    """The replicated kv heads (B, S, KV, hd) this rank's q heads read:
    global q head h reads kv head h // (H / KV). Returns GQA groups of the
    local heads where they form them, else one kv head per q head."""
    m, size = sh.mesh.axis_index("model"), sh.mesh.shape["model"]
    h_loc = cfg.n_heads // size
    group = cfg.n_heads // cfg.n_kv_heads
    idx = [(m * h_loc + i) // group for i in range(h_loc)]
    uniq = sorted(set(idx))
    per = h_loc // len(uniq)
    if h_loc % len(uniq) == 0 and idx == [uniq[i // per] for i in range(h_loc)]:
        return k[:, :, uniq]
    return k[:, :, idx]


def _attn_sharded(lp, sp, h, cfg: ArchConfig, sh: _Sharded, *, positions,
                  impl, window):
    """:func:`_attn_dense` on this rank's heads (module docstring)."""
    heads_tp, kv_tp = sh.tp(sp["wq"][-2]), sh.tp(sp["wk"][-2])
    # inside a tensor-parallel branch, weights used whole get their gradient
    # summed over the ranks' heads
    whole = {"qn", "kn"} | (set() if kv_tp else {"wk", "wv"})
    w = {k: sh.weight(x, sp[k], heads_tp and k in whole) for k, x in lp.items()}
    if not heads_tp:  # heads replicated: the whole attention on every rank
        return _attn_dense(w, h, cfg, positions=positions, impl=impl,
                           window=window)
    pick = None if kv_tp else (lambda t: _kv_for_local_heads(t, cfg, sh))
    out = _attn_dense(w, C.enter(h, sh.mesh), cfg, positions=positions,
                      impl=impl, window=window, pick_kv=pick)
    return C.leave(out, sh.mesh)


def _mlp_sharded(p, sp, x, act, sh: _Sharded):
    """``layers.mlp_apply`` on this rank's ffn slice (module docstring)."""
    full = {k: sh.weight(w, sp[k]) for k, w in p.items()}
    if not sh.tp(sp["w_up"][-1]):
        return L.mlp_apply(full, x, act)
    return C.leave(L.mlp_apply(full, C.enter(x, sh.mesh), act), sh.mesh)


# the MLA weights used whole inside the tensor-parallel branch
MLA_WHOLE = ("wq_a", "q_norm", "wkv_a", "kv_norm")


def _attn_mla_sharded(lp, sp, h, cfg: ArchConfig, sh: _Sharded, *, positions,
                      impl, window):
    """:func:`_attn_mla` on this rank's heads (module docstring)."""
    heads_tp = sh.tp(sp["wq_b"][-2])
    w = {k: sh.weight(x, sp[k], heads_tp and k in MLA_WHOLE)
         for k, x in lp.items()}
    if not heads_tp:
        return _attn_mla(w, h, cfg, positions=positions, impl=impl,
                         window=window)
    out = _attn_mla(w, C.enter(h, sh.mesh), cfg, positions=positions,
                    impl=impl, window=window)
    return C.leave(out, sh.mesh)


def local_groups(cfg: ArchConfig, n_groups: int, split: int) -> int:
    """The MoE dispatch's groups on a rank whose tokens are one of
    ``split`` slices of the batch: JAX's global ``n_groups`` make each
    slice ``n_groups // split`` whole groups, so ``tg`` and ``cap`` are the
    global ones."""
    if n_groups % split:
        raise ValueError(
            f"{cfg.name}: the MoE dispatch's {n_groups} token groups do not "
            f"split over the {split} slices of the batch: a group would span "
            f"ranks; give n_groups a multiple of {split} (the launcher's "
            "dp_shards)")
    return n_groups // split


def _moe_sharded(p, sp, x, cfg: ArchConfig, sh: _Sharded, n_groups: int):
    """:func:`layers.moe_apply` on this rank's experts and shared-expert ffn
    slice (module docstring): x (B, S, D) -> ((B, S, D), aux)."""
    b, s, d = x.shape
    mo, mesh = cfg.moe, sh.mesh
    xf = x.reshape(b * s, d)
    w = {k: sh.weight(v, sp[k]) for k, v in p.items() if k != "shared"}
    r = L.moe_route(w, xf, mo, n_groups=n_groups)
    gate = r["top_v"] * r["keep"]
    experts_tp = sh.tp(sp["w_up"][0])
    shared_tp = mo.n_shared and sh.tp(sp["shared"]["w_up"][-1])
    xin = C.enter(xf, mesh) if experts_tp or shared_tp else xf
    if experts_tp:
        inside = L.moe_experts(w, xin, r, C.enter(gate, mesh), mo, act=cfg.act,
                               experts=local_slice(mo.n_experts, sh))
        outside = 0.0
    else:
        inside, outside = 0.0, L.moe_experts(w, xf, r, gate, mo, act=cfg.act)
    if mo.n_shared:
        shared = {k: sh.weight(v, sp["shared"][k]) for k, v in p["shared"].items()}
        xs = (xin if shared_tp else xf).reshape(r["g"], r["tg"], d)
        y = L.mlp_apply(shared, xs, cfg.act)
        if shared_tp:
            inside = inside + y
        else:
            outside = outside + y
    if experts_tp or shared_tp:
        outside = outside + C.leave(inside, mesh)
    return outside.reshape(b, s, d), L.moe_aux(r, mo.n_experts)


# --------------------------------------------------------------------- blocks
def _block(lp, x, cfg: ArchConfig, *, positions, impl, collect=None, sh=None,
           moe=False, n_groups=1):
    """One layer: ``(out, aux, cap)``. ``aux`` is the MoE layer's balance
    loss (0.0 for a dense layer)."""
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    aux = 0.0
    if sh is not None:
        attn = _attn_mla_sharded if cfg.mla is not None else _attn_sharded
        x = x + attn(lp["attn"], sh.specs["attn"], h, cfg, sh,
                     positions=positions, impl=impl, window=cfg.window)
        h2 = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
        if moe:
            y, aux = _moe_sharded(lp["mlp"], sh.specs["mlp"], h2, cfg, sh,
                                  n_groups)
        else:
            y = _mlp_sharded(lp["mlp"], sh.specs["mlp"], h2, cfg.act, sh)
    else:
        attn = _attn_mla if cfg.mla is not None else _attn_dense
        x = x + attn(lp["attn"], h, cfg, positions=positions, impl=impl,
                     window=cfg.window)
        h2 = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
        if moe:
            b, s, d = h2.shape
            y, aux = L.moe_apply(lp["mlp"], h2.reshape(b * s, d), cfg.moe,
                                 n_groups=n_groups, act=cfg.act)
            y = y.reshape(b, s, d)
        else:
            y = L.mlp_apply(lp["mlp"], h2, cfg.act)
    out = x + y
    # harvest sites (data/activations.py): the post-block residual stream or
    # the MLP branch output (pre-residual-add)
    cap = None if collect is None else (out if collect == "resid" else y)
    return out, aux, cap


def logits_spec(cfg: ArchConfig, param_specs, mesh) -> tuple:
    """The spec of the forward's (B, S, V) logits under a mesh: the batch
    over the batch axes, the vocabulary over "model" where the output
    embedding shards it (``tie_embeddings``: the input embedding)."""
    from repro_torch.parallel import sharding

    un = param_specs.get("unembed")
    vocab = un[1] if un is not None else param_specs["embed"][0]
    b = sharding.batch_axes(mesh)
    size = sharding.mesh_shape_dict(mesh)["model"]
    return (b[0] if len(b) == 1 else b, None,
            "model" if vocab == "model" and size > 1 else None)


class Tally:
    """The collectives of one sharded forward and backward on a rank,
    counted from shapes and specs as the forward makes them (the mesh's
    ``counts()`` ops): ``shp`` the mesh's ``{name: size}``, weights and
    activations of ``itemsize`` bytes."""

    def __init__(self, shp, itemsize: int):
        self.shp, self.itemsize = dict(shp), itemsize
        self.live = {a for a, n in self.shp.items() if n > 1}
        self.calls = {"psum": 0, "pmax": 0, "all_gather": 0}
        self.nbytes = dict.fromkeys(self.calls, 0)

    def add(self, op, n, times=1):
        self.calls[op] += times
        self.nbytes[op] += n * times

    def tp(self, entry) -> bool:
        return entry == "model" and "model" in self.live

    def _fsdp(self, shape, spec, times):
        """:func:`collectives.gather_spec`'s gathers of the axes other than
        "model" (an entry over several axes, as the giants' ("pod", "data")
        'embed', gathers once): an all-gather forward (``times``), a psum
        backward."""
        from repro_torch.parallel import sharding

        loc = [d // sharding.entry_size(n, self.shp) for d, n in zip(shape, spec)]
        for i, (d, n) in enumerate(zip(shape, spec)):
            if n is not None and n != "model" and \
                    sharding.entry_size(n, self.shp) > 1:
                loc[i] = d
                full = math.prod(loc) * self.itemsize
                self.add("all_gather", full, times)
                self.add("psum", full)
        return loc

    def weight(self, shape, spec, times=1, whole=False):
        """:meth:`_Sharded.weight`: the FSDP gathers, and with ``whole``
        the psum over "model" of the gradient."""
        loc = self._fsdp(shape, spec, times)
        if whole and "model" in self.live:
            self.add("psum", math.prod(loc) * self.itemsize)

    def full(self, shape, spec, times=1, split=False):
        """:meth:`_Sharded.full`: the FSDP gathers, then the "model" one
        (and its gradient's psum when ``split``)."""
        loc = self._fsdp(shape, spec, times)
        for i, (d, n) in enumerate(zip(shape, spec)):
            if self.tp(n):
                loc[i] = d
                full = math.prod(loc) * self.itemsize
                self.add("all_gather", full, times)
                if split:
                    self.add("psum", full)

    def tree(self, tpl, sp, times=1, strip=0):
        """:meth:`_Sharded.tree` of a block of templates (``strip``
        leading stacked axes)."""
        for k in sorted(tpl):
            if isinstance(tpl[k], dict):
                self.tree(tpl[k], sp[k], times, strip)
            else:
                self.full(tpl[k].shape[strip:], sp[k][strip:], times)

    def top(self, cfg: ArchConfig, tpl, param_specs, act, tokens):
        """:func:`embed_sharded`, :func:`logits_sharded` and the loss
        (``vocab_xent``'s pmax and two psums of ``tokens`` float32 values,
        and the final activations' psum backward)."""
        self.weight(tpl["embed"].shape, param_specs["embed"])
        if self.tp(param_specs["embed"][0]):
            self.add("psum", act)
        if "unembed" in param_specs:
            self.weight(tpl["unembed"].shape, param_specs["unembed"])
        else:
            self.weight(tpl["embed"].shape, param_specs["embed"])
        if logits_spec(cfg, param_specs, self.shp)[-1] == "model":
            self.add("pmax", tokens * 4)
            self.add("psum", tokens * 4, 2)
            self.add("psum", act)

    def attn(self, a, asp, act, fwd, strip=1):
        """:func:`_attn_sharded` or :func:`_attn_mla_sharded`: the weights
        (replicated kv heads, the qk-norm scales and MLA's low-rank
        projections and norms psummed over "model" backward), one psum
        forward per run of the branch and one backward for its input."""
        mla = "wq_b" in a
        heads_tp = self.tp(asp["wq_b" if mla else "wq"][-2])
        kv_tp = not mla and self.tp(asp["wk"][-2])
        for name in sorted(a):
            whole = heads_tp and (name in MLA_WHOLE if mla else (
                name in ("qn", "kn") or (name in ("wk", "wv") and not kv_tp)))
            self.weight(a[name].shape[strip:], asp[name][strip:], fwd, whole)
        if heads_tp:
            self.add("psum", act, fwd + 1)

    def moe(self, m, msp, act, fwd, tokens, top_k, strip=1):
        """:func:`_moe_sharded` on ``tokens`` local tokens: the weights;
        where the experts or the shared expert's ffn split over "model",
        one psum forward per run of the branch and one backward for its
        input, and with the experts split one psum backward of the entered
        gates (``tokens`` × ``top_k`` float32 values)."""
        for name in sorted(m):
            if name == "shared":
                for k in sorted(m[name]):
                    self.weight(m[name][k].shape[strip:],
                                msp[name][k][strip:], fwd)
            else:
                self.weight(m[name].shape[strip:], msp[name][strip:], fwd)
        experts_tp = self.tp(msp["w_up"][strip])
        if experts_tp or ("shared" in m and self.tp(msp["shared"]["w_up"][-1])):
            self.add("psum", act, fwd + 1)
        if experts_tp:
            self.add("psum", tokens * top_k * 4)

    def mlp(self, m, msp, act, fwd, strip=1):
        """:func:`_mlp_sharded`."""
        for name in sorted(m):
            self.weight(m[name].shape[strip:], msp[name][strip:], fwd)
        if self.tp(msp["w_up"][-1]):
            self.add("psum", act, fwd + 1)

    def result(self) -> dict:
        return {"calls": self.calls, "bytes": self.nbytes}


def sharded_collectives(cfg: ArchConfig, param_specs, mesh, batch: int,
                        seq: int, *, remat: bool, itemsize: int) -> dict:
    """The collectives one forward and backward of the sharded forward make
    on each rank, ``{"calls": {op: n}, "bytes": {op: n}}`` (the mesh's
    ``counts()`` ops): ``batch`` × ``seq`` tokens on this rank, weights and
    activations of ``itemsize`` bytes (the compute dtype), the logits'
    reductions in float32. ``mesh`` is a mesh or a ``{name: size}``
    mapping. The model of the module docstring, counted (:class:`Tally`;
    the audio, hybrid and recurrent families count in their modules):

    * an FSDP gather: an all-gather of the weight's "model"-local shape
      forward (twice under ``remat`` inside a block: the recompute runs
      the whole body) and a psum of it backward;
    * a tensor-parallel attention, MLP or MoE layer: one psum forward
      (twice under ``remat``), one backward for its input, and one
      backward for each weight it uses whole (a replicated wk/wv, the
      qk-norm scales, MLA's low-rank projections and norms); an MoE
      layer's split experts also one backward for the entered gates;
    * a "model"-sharded vocabulary: a psum of the embedded rows; a pmax and
      two psums of (B, S) in the loss; one psum backward for the final
      activations.
    """
    shp = dict(mesh.shape) if hasattr(mesh, "shape") else dict(mesh)
    t = Tally(shp, itemsize)
    if cfg.family in ("audio", "hybrid", "ssm"):
        from . import whisper, xlstm, zamba

        fam = {"audio": whisper, "hybrid": zamba, "ssm": xlstm}[cfg.family]
        fam.tally(t, cfg, param_specs, batch, seq, remat=remat)
        return t.result()
    act = batch * seq * cfg.d_model * itemsize
    tpl = template(cfg)
    t.top(cfg, tpl, param_specs, act, batch * seq)
    fwd = 2 if remat else 1
    for name, moe, n in stacks(cfg):
        blocks, bspecs = tpl[name], param_specs[name]
        for _ in range(n):
            t.attn(blocks["attn"], bspecs["attn"], act, fwd)
            if moe:
                t.moe(blocks["mlp"], bspecs["mlp"], act, fwd, batch * seq,
                      cfg.moe.top_k)
            else:
                t.mlp(blocks["mlp"], bspecs["mlp"], act, fwd)
    return t.result()


def forward(params, tokens, cfg: ArchConfig, *, impl="chunked", n_groups=1,
            remat=True, act_spec=None, collect=None, mesh=None,
            param_specs=None):
    """tokens (B, S) int -> (logits (B, S, V), aux).

    ``n_groups`` is the MoE dispatch's number of token groups (the dense
    family takes and ignores it, as in the JAX package). ``act_spec`` is
    the (B, S, D) activations' layout: under a mesh the caller hands this
    rank its slice of the batch, the layout JAX's constraint pins (its
    first entry names the mesh axes the batch is split over, by default
    the batch axes), and without one it has no effect. ``mesh`` and
    ``param_specs`` run the sharded forward of the dense and MoE families
    (module docstring): ``params`` and ``tokens`` are this rank's shards,
    ``n_groups`` stays the global count, and the logits are this rank's
    shard under :func:`logits_spec`.

    ``collect``: None | "resid" | "mlp" — also return the per-layer
    activations stacked on a leading layer axis, shape (L, B, S, D): the
    post-block residual stream or the MLP branch output (the capture point
    of ``data/activations.py``), an MoE model's dense layers first.
    ``remat=True`` recomputes each block in the backward pass
    (``torch.utils.checkpoint``); harvesting passes ``remat=False``.
    ``aux`` is the sum of the MoE layers' balance losses, 0.0 for a dense
    model.
    """
    if (mesh is None) != (param_specs is None):
        raise ValueError("a sharded forward takes both mesh= and param_specs=")
    _check_impl(cfg, impl)
    b, s = tokens.shape
    top = None if mesh is None else _Sharded(mesh, param_specs)
    if top is not None and cfg.moe is not None:
        n_groups = local_groups(cfg, n_groups, batch_split(mesh, act_spec))
    x = (params["embed"][tokens] if top is None
         else embed_sharded(params, param_specs, tokens, top))
    x = x.to(params["final_norm"].dtype)
    positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
    aux = 0.0
    caps = []
    for name, moe, n in stacks(cfg):
        blocks = params[name]
        # each layer's specs: the stacked leaves' without the layer axis
        layer_sh = None if mesh is None else _Sharded(
            mesh, _tree.tree_map(lambda sp: tuple(sp[1:]), param_specs[name]))
        # unbind each stacked leaf once: its backward stacks the layers'
        # gradients in one pass, where a[i] per layer would give every layer
        # a full-size zero gradient of the stack to sum
        per_layer = [a.unbind(0) for a in _tree.leaves(blocks)]
        for i in range(n):
            lp = _tree.unflatten_like(blocks, [u[i] for u in per_layer])

            def body(x, lp=lp, moe=moe, sh=layer_sh):
                return _block(lp, x, cfg, positions=positions, impl=impl,
                              collect=collect, sh=sh, moe=moe,
                              n_groups=n_groups)

            x, a, cap = (checkpointed(body, x, layer_sh is not None) if remat
                         else body(x))
            aux = aux + a
            caps.append(cap)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    un = params.get("unembed")
    if top is None:
        logits = x @ un if un is not None else x @ params["embed"].T
    else:
        logits = logits_sharded(x, params, param_specs, cfg, top)
    if collect is not None:
        return logits, aux, torch.stack(caps)
    return logits, aux


# -------------------------------------------------------------------- serving
def make_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, *, device=None):
    """Stacked per-layer cache of zeros on ``device`` (the card by
    default), every layer of every stack in order: a dense model's
    ``{"k", "v"}`` of (L, B, T, KV, hd), an MLA model's ``{"c_kv" (L, B, T,
    kv_lora_rank), "k_rope" (L, B, T, qk_rope_dim)}``. Windowed archs get
    ring buffers of ``T = min(max_len, window)`` slots."""
    from repro_torch import _device

    dev = _device.resolve(device)
    t = min(max_len, cfg.window) if cfg.window else max_len
    n = cfg.n_layers
    if cfg.mla is not None:
        m = cfg.mla
        return {"c_kv": torch.zeros((n, batch, t, m.kv_lora_rank), dtype=dtype,
                                    device=dev),
                "k_rope": torch.zeros((n, batch, t, m.qk_rope_dim), dtype=dtype,
                                      device=dev)}
    shape = (n, batch, t, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def cache_specs(cfg: ArchConfig, rules, mesh_shape):
    """The cache's specs from the activation rules
    (``parallel.sharding.act_rules``): the batch over its "batch" axes, the
    cache's length over "cache_seq" (flash-decode), the layer stack and the
    heads replicated. ``mesh_shape`` is unused, as in the JAX package."""
    batch_ax, seq_ax = rules.get("batch"), rules.get("cache_seq")
    if cfg.mla is not None:
        return {"c_kv": (None, batch_ax, seq_ax, None),
                "k_rope": (None, batch_ax, seq_ax, None)}
    return {"k": (None, batch_ax, seq_ax, None, None),
            "v": (None, batch_ax, seq_ax, None, None)}


def decode_step(params, tokens, cache, pos, cfg: ArchConfig, *, n_groups=1):
    """One token for the whole batch: tokens (B,) int, ``pos`` a Python int
    (the position of ``tokens``; the caller counts it on the host, so no
    step reads it back from the device). Returns ``(logits (B, V), cache)``
    with ``cache`` updated in place. ``n_groups`` is the MoE dispatch's, as
    in ``forward``; its B tokens form one queue per group."""
    pos = operator.index(pos)
    b = tokens.shape[0]
    x = params["embed"][tokens][:, None].to(params["final_norm"].dtype)
    # the rotary angles of pos and the valid length, shared by every layer
    where = torch.full((b, 1), pos, dtype=torch.int32, device=tokens.device)
    if cfg.mla is not None:
        freqs = L.rope_frequencies(cfg.mla.qk_rope_dim, 1.0, cfg.rope_theta,
                                   where)
    else:
        freqs = L.rope_frequencies(cfg.resolved_head_dim, cfg.rope_pct,
                                   cfg.rope_theta, where)
        cur = torch.full((b,), pos + 1, dtype=torch.int32, device=tokens.device)
    layer = {k: c.unbind(0) for k, c in cache.items()}
    off = 0
    for name, moe, n in stacks(cfg):
        blocks = params[name]
        per_layer = [a.unbind(0) for a in _tree.leaves(blocks)]
        for i in range(n):
            lp = _tree.unflatten_like(blocks, [u[i] for u in per_layer])
            cl = {k: c[off + i] for k, c in layer.items()}
            h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
            if cfg.mla is not None:
                x = x + _attn_mla_decode(lp["attn"], h, cfg, pos=pos,
                                         freqs=freqs, cache=cl)
            else:
                x = x + _attn_dense_decode(lp["attn"], h, cfg, pos=pos,
                                           cur=cur, freqs=freqs, cache=cl,
                                           window=cfg.window)
            h2 = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
            if moe:
                y, _ = L.moe_apply(lp["mlp"], h2[:, 0], cfg.moe,
                                   n_groups=n_groups, act=cfg.act)
                x = x + y[:, None]
            else:
                x = x + L.mlp_apply(lp["mlp"], h2, cfg.act)
        off += n
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    un = params.get("unembed")
    logits = x[:, 0] @ un if un is not None else x[:, 0] @ params["embed"].T
    return logits, cache
