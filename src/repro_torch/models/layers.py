"""Neural-net building blocks of the LMs (port of ``repro/models/layers.py``,
lines 35-198 and 201-428).

Everything is a plain function of (params, inputs) on tensors. Attention
comes in three implementations selected by ``impl``:

  * "naive"   — materializes the S×S logits
  * "chunked" — online softmax over KV chunks in PyTorch ops (flash
                semantics, memory-bounded)
  * "flash"   — ``kernels/flash_attention.py``: the hand-written CUDA
                forward and backward kernels on a CUDA tensor (float32 or
                bf16), their plain versions on a CPU tensor; differentiable
                (the counterpart of the JAX package's ``"pallas"``)

All attention math accumulates in f32 regardless of compute dtype.
:func:`attention_decode` is the single-token step against a KV cache.
:func:`moe_apply` is the GShard capacity-dispatch mixture of experts, with
both of the JAX package's dispatches. :func:`mamba2_apply` is the Mamba2
block of the hybrid family: the chunked SSD (:func:`_ssd_chunked`) over a
sequence, or one step of the recurrence against a (conv, ssm) state.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .params import ParamDef

_NEG = -1e30

# the chunked attention's knobs (``launch/specs.py``'s ``apply_tuning`` sets
# them for a dry-run or hillclimb cell): the KV chunk, and the dtype the
# probabilities take before the P·V product (None: float32), which still
# accumulates in float32. The flash path ignores both.
ATTN_TUNE = {"chunk": 1024, "probs_dtype": None}


# ---------------------------------------------------------------------- norms
def rms_norm(x, scale, eps=1e-5):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def layer_norm(x, scale, bias, eps=1e-5):
    """LayerNorm over the last axis in float32, cast back to ``x.dtype``;
    the variance is the population variance (``jnp.var``), not torch's
    unbiased default."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    out = (xf - mu) * torch.rsqrt(var + eps) * scale + bias
    return out.to(x.dtype)


# ----------------------------------------------------------------------- rope
def rope_frequencies(head_dim: int, rope_pct: float, theta: float, positions):
    """positions (…,) int -> (cos, sin, rot) with cos/sin (…, rot//2)."""
    rot = int(head_dim * rope_pct)
    rot -= rot % 2
    if rot == 0:
        return None
    exps = torch.arange(0, rot, 2, dtype=torch.float32,
                        device=positions.device) / rot
    inv = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                       device=positions.device), exps)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang), rot


def apply_rope(x, freqs):
    """x (..., S, H, D); freqs from rope_frequencies with positions (..., S).
    Rotates the first ``rot`` channels in interleaved pairs (partial rotary);
    the rest pass through."""
    if freqs is None:
        return x
    cos, sin, rot = freqs
    xf = x.float()
    xr, xp = xf[..., :rot], xf[..., rot:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    c = cos[..., None, :]  # broadcast over heads
    s = sin[..., None, :]
    o1 = x1 * c - x2 * s
    o2 = x2 * c + x1 * s
    out = torch.stack([o1, o2], dim=-1).reshape(xr.shape)
    return torch.cat([out, xp], dim=-1).to(x.dtype)


# ------------------------------------------------------------------ attention
def _gqa_logits(q, k):
    """q (B,S,KV,G,D) × k (B,T,KV,D) -> (B,KV,G,S,T) in f32."""
    return torch.einsum("bskgd,btkd->bkgst", q.float(), k.float())


def _mask(qpos, kpos, causal, window):
    mask = torch.ones(qpos.shape[0], kpos.shape[1], dtype=torch.bool,
                      device=qpos.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def attention_naive(q, k, v, *, causal=True, window=None, q_offset=0):
    """q (B,S,H,Dqk), k (B,T,KV,Dqk), v (B,T,KV,Dv). Returns (B,S,H,Dv)."""
    b, s, h, d = q.shape
    t, kv, dv = k.shape[1], k.shape[2], v.shape[-1]
    g = h // kv
    qg = q.reshape(b, s, kv, g, d) * (d ** -0.5)
    logits = _gqa_logits(qg, k)
    qpos = torch.arange(s, device=q.device)[:, None] + q_offset
    kpos = torch.arange(t, device=q.device)[None, :]
    mask = _mask(qpos, kpos, causal, window)
    logits = torch.where(mask, logits, torch.full((), _NEG, device=q.device))
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", w, v.float())
    return out.reshape(b, s, h, dv).to(q.dtype)


def attention_chunked(q, k, v, *, causal=True, window=None, q_offset=0,
                      chunk=1024):
    """Online softmax over KV chunks (flash semantics in PyTorch ops)."""
    b, s, h, d = q.shape
    t, kv, dv = k.shape[1], k.shape[2], v.shape[-1]
    g = h // kv
    chunk = min(chunk, t)
    n_chunks = -(-t // chunk)
    t_pad = n_chunks * chunk
    if t_pad != t:
        k = F.pad(k, (0, 0, 0, 0, 0, t_pad - t))
        v = F.pad(v, (0, 0, 0, 0, 0, t_pad - t))

    qg = (q.float() * (d ** -0.5)).reshape(b, s, kv, g, d)
    qpos = (torch.arange(s, device=q.device) + q_offset)[:, None]
    neg = torch.full((), _NEG, device=q.device)

    m = torch.full((b, kv, g, s), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, kv, g, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, kv, g, s, dv), dtype=torch.float32, device=q.device)
    for idx in range(n_chunks):
        kb = k[:, idx * chunk:(idx + 1) * chunk]
        vb = v[:, idx * chunk:(idx + 1) * chunk]
        logits = _gqa_logits(qg, kb)  # (b,kv,g,s,chunk)
        kpos = (idx * chunk + torch.arange(chunk, device=q.device))[None, :]
        mask = _mask(qpos, kpos, causal, window) & (kpos < t)
        logits = torch.where(mask, logits, neg)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pd = ATTN_TUNE.get("probs_dtype")
        if pd is None:
            pv = torch.einsum("bkgst,btkd->bkgsd", p, vb.float())
        else:  # probabilities rounded to pd, the product accumulated in f32
            pv = torch.einsum("bkgst,btkd->bkgsd", p.to(pd).float(),
                              vb.to(pd).float())
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.where(l == 0, torch.ones_like(l), l)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, dv).to(q.dtype)


def attention(q, k, v, *, causal=True, window=None, q_offset=0,
              impl="chunked", chunk=None):
    if impl == "naive":
        return attention_naive(q, k, v, causal=causal, window=window,
                               q_offset=q_offset)
    if impl == "chunked":
        return attention_chunked(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset,
                                 chunk=chunk or ATTN_TUNE["chunk"])
    if impl == "flash":
        from repro_torch.kernels import ops

        # the kernel takes (B, H, S, D) contiguous; q is right-aligned to k,
        # which is q_offset = 0 for the forward's square attention
        qt = q.transpose(1, 2).contiguous()
        kt = k.transpose(1, 2).contiguous()
        vt = v.transpose(1, 2).contiguous()
        o = ops.attention(qt, kt, vt, causal=causal, window=window)
        return o.transpose(1, 2)
    raise ValueError(f"unknown attention impl {impl!r}")


def attention_decode(q, k_cache, v_cache, cur_len, *, window=None):
    """Single-token decode. q (B,H,D); caches (B,T,KV,D); ``cur_len`` (B,)
    int, the valid length of each request's cache.

    A GQA product in float32 over the whole cache, the slots past
    ``cur_len`` masked, then the softmax: every shape is fixed by the
    cache, whatever the position. ``window`` caches are ring buffers: every
    slot is valid once the ring wraps (``min(cur_len, T)``), and positions
    are the caller's.
    """
    b, h, d = q.shape
    t, kv, dv = k_cache.shape[1], k_cache.shape[2], v_cache.shape[-1]
    g = h // kv
    qg = (q.float() * (d ** -0.5)).reshape(b, kv, g, d)
    logits = torch.einsum("bkgd,btkd->bkgt", qg, k_cache.float())
    pos = torch.arange(t, device=q.device)[None, :]
    lim = cur_len if window is None else torch.clamp(cur_len, max=t)
    valid = pos < lim[:, None]                             # (B, T)
    logits = torch.where(valid[:, None, None], logits,
                         torch.full((), _NEG, device=q.device))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgt,btkd->bkgd", p / l, v_cache.float())
    return out.reshape(b, h, dv).to(q.dtype)


# ------------------------------------------------------------------------ mlp
def _act(x, kind):
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default
    if kind == "relu":
        return F.relu(x)
    raise ValueError(kind)


def mlp_template(d_model: int, d_ff: int, act: str = "silu"):
    t = {
        "w_up": ParamDef((d_model, d_ff), ("embed", "ffn"), "scaled"),
        "w_down": ParamDef((d_ff, d_model), ("ffn", "embed"), "scaled"),
    }
    if act != "gelu":  # gated (SwiGLU-style) for silu/relu families
        t["w_gate"] = ParamDef((d_model, d_ff), ("embed", "ffn"), "scaled")
    return t


def mlp_apply(p, x, act="silu"):
    up = x @ p["w_up"]
    if "w_gate" in p:
        up = _act(x @ p["w_gate"], act) * up
    else:
        up = _act(up, act)
    return up @ p["w_down"]


# ------------------------------------------------------------------------ moe
def moe_template(d_model: int, cfg):
    e, f = cfg.n_experts, cfg.d_expert
    t = {
        "router": ParamDef((d_model, e), ("embed", None), "scaled"),
        "w_gate": ParamDef((e, d_model, f), ("experts", "embed", "expert_ff"), "scaled"),
        "w_up": ParamDef((e, d_model, f), ("experts", "embed", "expert_ff"), "scaled"),
        "w_down": ParamDef((e, f, d_model), ("experts", "expert_ff", "embed"), "scaled"),
    }
    if cfg.n_shared:
        ds = cfg.d_shared or cfg.d_expert
        t["shared"] = mlp_template(d_model, ds * cfg.n_shared, "silu")
    return t


def moe_route(p, x, cfg, *, n_groups: int) -> dict:
    """The router of :func:`moe_apply` on x (T, M): ``{"g", "tg", "cap",
    "probs" (g, tg, e), "onehot" (g, tg, k, e), "top_v", "top_i", "pos",
    "keep" (g, tg, k)}``.

    Tokens split into ``gcd(n_groups, T)`` groups of ``tg``; each expert
    takes ``cap = max(1, ceil(tg·k/e·capacity_factor))`` per group. The
    router runs in float32; top-k is a stable descending sort, so equal
    probabilities go to the lower expert first, as ``jax.lax.top_k``
    orders them. A (token, slot)'s place in its expert's queue counts the
    slots before it in token-major, slot-minor order; it is kept when that
    place is under ``cap``."""
    tkns, m = x.shape
    e, k = cfg.n_experts, cfg.top_k
    g = math.gcd(n_groups, tkns)
    tg = tkns // g
    cap = int(max(1, math.ceil(tg * k / e * cfg.capacity_factor)))
    logits = x.reshape(g, tg, m).float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)                     # (g, tg, e)
    top_v, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_v, top_i = top_v[..., :k], top_i[..., :k]             # (g, tg, k)
    top_v = top_v / top_v.sum(dim=-1, keepdim=True)
    onehot = F.one_hot(top_i, e).float()                      # (g, tg, k, e)
    flat = onehot.reshape(g, tg * k, e)
    pos = torch.cumsum(flat, dim=1) - flat
    pos = (pos.reshape(g, tg, k, e) * onehot).sum(dim=-1)     # (g, tg, k)
    return {"g": g, "tg": tg, "cap": cap, "probs": probs, "onehot": onehot,
            "top_v": top_v, "top_i": top_i, "pos": pos, "keep": pos < cap}


def _experts(p, xe, act):
    """Every expert's gated MLP on its slots: xe (g, e, cap, m)."""
    h = torch.einsum("gecm,emf->gecf", xe, p["w_up"])
    hg = _act(torch.einsum("gecm,emf->gecf", xe, p["w_gate"]), act)
    return torch.einsum("gecf,efm->gecm", h * hg, p["w_down"])


def moe_apply(p, x, cfg, *, n_groups: int, act="silu"):
    """GShard-style capacity-dispatch MoE on x (T, M) flattened tokens;
    returns ``(out (T, M), aux)``, the Switch load-balance loss.

    Dispatch is per group (:func:`moe_route`), so the queue never crosses
    groups. ``cfg.dispatch == "einsum"`` builds one-hot dispatch and
    combine tensors (g, tg, e, cap) and runs every expert on its ``cap``
    slots; ``"scatter"`` adds each kept (token, slot) into row
    ``expert·cap + place`` of an (e·cap + 1)-row buffer with ``index_add``
    (the dropped go to the last row, which is thrown away) and gathers the
    experts' rows back. The two give the same output (:func:`moe_experts`)."""
    tkns, m = x.shape
    r = moe_route(p, x, cfg, n_groups=n_groups)
    out = moe_experts(p, x, r, r["top_v"] * r["keep"], cfg, act=act)
    if cfg.n_shared:
        out = out + mlp_apply(p["shared"], x.reshape(r["g"], r["tg"], m), act)
    return out.reshape(tkns, m), moe_aux(r, cfg.n_experts)


def moe_aux(r, n_experts: int):
    """The Switch load-balance loss of a route: the experts' mean fraction
    of slots times their mean probability, per group, averaged."""
    me = r["onehot"].sum(dim=2).mean(dim=1)                   # (g, e)
    pe = r["probs"].mean(dim=1)
    return n_experts * (me * pe).sum(dim=-1).mean()


def moe_experts(p, x, r, gate, cfg, *, act="silu", experts=None):
    """The routed experts' output (g, tg, M) on x (T, M) under the route
    ``r`` (:func:`moe_route`), each kept (token, slot) weighted by ``gate``
    (g, tg, k). ``experts`` is the slice of the experts whose weights ``p``
    holds (all of them by default): only their slots are dispatched and
    combined, so a rank that holds a slice of the experts gives its part of
    the sum (``models/lm.py``'s sharded MoE layer)."""
    tkns, m = x.shape
    e, k = cfg.n_experts, cfg.top_k
    lo, hi = (0, e) if experts is None else (experts.start, experts.stop)
    g, tg, cap = r["g"], r["tg"], r["cap"]
    xg = x.reshape(g, tg, m)
    pos, keep, expert_of = r["pos"], r["keep"], r["top_i"]
    if cfg.dispatch == "einsum":
        # collapse the k slots: a token holds at most one slot per expert
        oh_e = r["onehot"][..., lo:hi]
        mask_te = torch.einsum("gtke,gtk->gte", oh_e, keep.float())
        pos_te = torch.einsum("gtke,gtk->gte", oh_e, pos)
        gate_te = torch.einsum("gtke,gtk->gte", oh_e, gate)
        # a place at or past cap is no slot (jax.nn.one_hot gives zeros)
        oh_c = (pos_te.long()[..., None]
                == torch.arange(cap, device=x.device)).float()
        disp_te = (mask_te[..., None] * oh_c).to(x.dtype)    # (g, tg, e, cap)
        xe = torch.einsum("gtec,gtm->gecm", disp_te, xg)      # (g, e, cap, m)
        ye = _experts(p, xe, act)
        comb = gate_te[..., None].to(x.dtype) * disp_te
        return torch.einsum("gtec,gecm->gtm", comb, ye)
    if cfg.dispatch == "scatter":
        n = hi - lo
        mine = keep & (expert_of >= lo) & (expert_of < hi)
        slot = (expert_of - lo) * cap + pos.long()            # (g, tg, k)
        slot = torch.where(mine, slot, torch.full_like(slot, n * cap))
        rows = slot + (torch.arange(g, device=x.device)
                       * (n * cap + 1))[:, None, None]
        src = xg[:, :, None, :].expand(g, tg, k, m).reshape(-1, m)
        buf = torch.zeros(g * (n * cap + 1), m, dtype=x.dtype, device=x.device)
        buf = buf.index_add(0, rows.reshape(-1), src)
        xe = buf.reshape(g, n * cap + 1, m)[:, :n * cap].reshape(g, n, cap, m)
        ye = _experts(p, xe, act).reshape(g, n * cap, m)
        ye = torch.cat([ye, ye.new_zeros(g, 1, m)], dim=1).reshape(-1, m)
        gath = ye[rows.reshape(-1)].reshape(g, tg, k, m)
        return (gath * gate[..., None].to(x.dtype)).sum(dim=2)
    raise ValueError(f"unknown MoE dispatch {cfg.dispatch!r}")


# --------------------------------------------------------------------- mamba2
def mamba2_template(d_model: int, cfg):
    di = cfg.expand * d_model
    h = di // cfg.head_dim
    gn = cfg.n_groups * cfg.d_state
    return {
        # fused input projection: [z(di), x(di), B(gn), C(gn), dt(h)]
        "w_in": ParamDef((d_model, 2 * di + 2 * gn + h), ("embed", "ssm_in"), "scaled"),
        "conv_w": ParamDef((cfg.d_conv, di + 2 * gn), (None, None), "scaled", 0.1),
        "a_log": ParamDef((h,), (None,), "zeros"),
        "d_skip": ParamDef((h,), (None,), "ones"),
        "dt_bias": ParamDef((h,), (None,), "zeros"),
        "norm": ParamDef((di,), (None,), "ones"),
        "w_out": ParamDef((di, d_model), ("ssm_in", "embed"), "scaled"),
    }


def _ssd_chunked(x, dt, A, B, C, *, chunk: int):
    """Mamba2 SSD, chunked-parallel. x (b,s,h,p), dt (b,s,h), A (h,),
    B/C (b,s,g,n) with h % g == 0: head i reads group i // (h/g). Returns
    (b,s,h,p) in float32.

    The intra-chunk decay ``L[i,j] = exp(cum_i - cum_j)`` is masked to the
    causal triangle *before* the ``exp`` (``repro/models/layers.py:356``
    masks after it). Off the triangle ``cum_i - cum_j`` is positive, up to
    (chunk - 1)·max dt, and overflows float32's ``exp`` near 88.7: the
    forward is the same either way, but the backward of ``where(causal,
    exp(li), 0)`` multiplies that inf by 0, a NaN. Every other ``exp``
    here has an exponent <= 0."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    c = min(chunk, s)
    nc = -(-s // c)
    pad = nc * c - s
    if pad:  # dt pads with 0: no decay and no input through the pad
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    xc = x.reshape(b, nc, c, h, p).float()
    dtc = dt.reshape(b, nc, c, h).float()
    Bc = B.reshape(b, nc, c, g, n).repeat_interleave(rep, dim=3).float()
    Cc = C.reshape(b, nc, c, g, n).repeat_interleave(rep, dim=3).float()

    dA = dtc * (-torch.exp(A.float()))                          # <= 0
    cum = torch.cumsum(dA, dim=2)                               # (b,nc,c,h)
    li = cum[:, :, :, None, :] - cum[:, :, None, :, :]          # (b,nc,i,j,h)
    ii = torch.arange(c, device=x.device)
    causal = (ii[:, None] >= ii[None, :])[:, :, None]           # (i,j,1)
    decay = torch.exp(li.masked_fill(~causal, -math.inf))
    scores = torch.einsum("bzihn,bzjhn->bzijh", Cc, Bc) * decay
    y_diag = torch.einsum("bzijh,bzjhp->bzihp", scores, xc * dtc[..., None])
    # chunk end-states: S_z = sum_j exp(cum_end - cum_j) * B_j x_j dt_j
    decay_out = torch.exp(cum[:, :, -1:, :] - cum)              # (b,nc,c,h)
    S = torch.einsum("bzjhn,bzjhp->bzhnp", Bc * (decay_out * dtc)[..., None], xc)
    chunk_decay = torch.exp(cum[:, :, -1, :])                   # (b,nc,h)
    # the state entering each chunk, by the recurrence over chunks
    hz = torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
    h_in = []
    for z in range(nc):
        h_in.append(hz)
        hz = hz * chunk_decay[:, z, :, None, None] + S[:, z]
    h_in = torch.stack(h_in, dim=1)                             # (b,nc,h,n,p)
    y_off = torch.einsum("bzihn,bzhnp->bzihp", Cc * torch.exp(cum)[..., None], h_in)
    y = (y_diag + y_off).reshape(b, nc * c, h, p)
    return y[:, :s]


def mamba2_apply(p, x, cfg, *, state=None):
    """Mamba2 block on x (b, s, d) -> ``(y (b, s, d), new_state)``.

    Without ``state`` the sequence runs through the chunked SSD and
    ``new_state`` is None. With ``state = (conv_state (b, d_conv,
    di + 2gn), ssm_state (b, h, n, p) float32)`` s must be 1: one step of
    the recurrence ``h' = h·exp(dt·A) + dt·B⊗x, y = C·h'``, and
    ``new_state`` is the rolled conv window and ``h'``."""
    b, s, d = x.shape
    di = cfg.expand * d
    h = di // cfg.head_dim
    gn = cfg.n_groups * cfg.d_state
    proj = x @ p["w_in"]
    z, xs, Bf, Cf, dt = torch.split(proj, [di, di, gn, gn, h], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"].float())

    conv_in = torch.cat([xs, Bf, Cf], dim=-1)                  # (b, s, di+2gn)
    if state is None:
        # causal depthwise conv over time
        ci = F.pad(conv_in, (0, 0, cfg.d_conv - 1, 0))
        win = torch.stack([ci[:, i:i + s] for i in range(cfg.d_conv)], dim=-1)
        conv = torch.einsum("bsdk,kd->bsd", win, p["conv_w"])
        conv_state_new = None
    else:
        conv_state, ssm_state = state
        roll = torch.cat([conv_state[:, 1:], conv_in], dim=1)  # promotes
        conv = torch.einsum("bkd,kd->bd", roll,
                            p["conv_w"].to(roll.dtype))[:, None, :]
        conv_state_new = roll
    conv = F.silu(conv)
    xs2, Bf2, Cf2 = torch.split(conv, [di, gn, gn], dim=-1)
    xh = xs2.reshape(b, s, h, cfg.head_dim)
    Bm = Bf2.reshape(b, s, cfg.n_groups, cfg.d_state)
    Cm = Cf2.reshape(b, s, cfg.n_groups, cfg.d_state)

    if state is None:
        y = _ssd_chunked(xh, dt, p["a_log"], Bm, Cm, chunk=cfg.chunk)
        new_state = None
    else:
        rep = h // cfg.n_groups
        dA = torch.exp(dt[:, 0] * (-torch.exp(p["a_log"].float())))   # (b,h)
        Br = Bm[:, 0].repeat_interleave(rep, dim=1).float()            # (b,h,n)
        Cr = Cm[:, 0].repeat_interleave(rep, dim=1).float()
        xf = xh[:, 0].float()                                          # (b,h,p)
        upd = (dt[:, 0, :, None, None] * Br[..., None]) * xf[:, :, None, :]
        hnew = ssm_state * dA[..., None, None] + upd                   # (b,h,n,p)
        y = torch.einsum("bhn,bhnp->bhp", Cr, hnew)[:, None]
        new_state = (conv_state_new, hnew)

    y = y + xh.float() * p["d_skip"].float()[None, None, :, None]
    y = y.reshape(b, s, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"])
    return y @ p["w_out"], new_state
