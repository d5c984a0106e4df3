"""xLSTM (arXiv:2405.04517), port of ``repro/models/xlstm.py``: mLSTM
(matrix memory) and sLSTM (scalar memory) blocks.

Layout for xlstm-1.3b: 48 layers in super-blocks of (slstm_every - 1)
mLSTM followed by 1 sLSTM. The mLSTM parameters are double-stacked,
``mlstm/w_up`` (n_super, slstm_every - 1, d, 2·di), the sLSTM's stacked
once, ``slstm/w_in`` (n_super, d, 4d), as in the JAX package, so its trees
cross over with ``interop.from_numpy_tree``; ``lax.scan`` over a stack or
over time becomes a Python loop. The mLSTM has a *sequential* recurrence
(the paper's formulation and the decode path) and a *chunkwise-parallel*
one (the forward's); both use the exponential-gating stabiliser m_t.

Gates are exp(i)/exp(f) with running-max stabilisation; the normaliser is
max(|q·n|, exp(-m)) as in the paper's appendix. The stabilisers start at
``_NEG = -1e30``, not -inf: -inf - (-inf) is NaN.

The sLSTM's recurrence reads h_{t-1} at every step, so it runs as a time
loop of small operations (``lax.scan`` in the JAX package).

Serving keeps an O(1) recurrent state (:func:`make_state`): each mLSTM
layer's (C, n, m) and each sLSTM layer's (c, n, h, m), float32, which
:func:`decode_step` updates in place.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import _tree
from repro_torch.configs.types import ArchConfig

from . import layers as L
from .params import ParamDef

_NEG = -1e30


def _log_sigmoid(x):
    return -F.softplus(-x)


# -------------------------------------------------------------------- mLSTM
def mlstm_sequential(q, k, v, li, lf, state=None):
    """q,k,v (b,s,h,d); li/lf (b,s,h) log gates. Returns y, final state.

    state = (C (b,h,dk,dv), n (b,h,dk), m (b,h))."""
    b, s, h, d = q.shape
    qf = q.float() * (d ** -0.5)
    kf, vf = k.float(), v.float()
    li, lf = li.float(), lf.float()
    if state is None:
        C = torch.zeros((b, h, d, d), dtype=torch.float32, device=q.device)
        n = torch.zeros((b, h, d), dtype=torch.float32, device=q.device)
        m = torch.full((b, h), _NEG, dtype=torch.float32, device=q.device)
    else:
        C, n, m = state
    ys = []
    for t in range(s):
        qt, kt, vt, lit, lft = qf[:, t], kf[:, t], vf[:, t], li[:, t], lf[:, t]
        m_new = torch.maximum(lft + m, lit)
        fp = torch.exp(lft + m - m_new)[..., None]
        ip = torch.exp(lit - m_new)[..., None]
        C = C * fp[..., None] + ip[..., None] * (kt[..., :, None] * vt[..., None, :])
        n = n * fp + ip * kt
        num = torch.einsum("bhd,bhde->bhe", qt, C)
        qn = torch.einsum("bhd,bhd->bh", qt, n)
        denom = torch.maximum(qn.abs(), torch.exp(-m_new))[..., None]
        m = m_new
        ys.append(num / denom)
    return torch.stack(ys, dim=1).to(q.dtype), (C, n, m)


def mlstm_chunkwise(q, k, v, li, lf, *, chunk: int, state=None):
    """Chunkwise-parallel mLSTM: O(s·c) within chunks, the recurrence over
    the s/c chunks. A ragged tail pads ``li`` with ``_NEG`` (no input) and
    ``lf`` with 0 (no decay)."""
    b, s, h, d = q.shape
    c = min(chunk, s)
    nc = -(-s // c)
    pad = nc * c - s
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
        li = F.pad(li, (0, 0, 0, pad), value=_NEG)
        lf = F.pad(lf, (0, 0, 0, pad))
    qf = (q.float() * (d ** -0.5)).reshape(b, nc, c, h, d)
    kf = k.float().reshape(b, nc, c, h, d)
    vf = v.float().reshape(b, nc, c, h, d)
    lif = li.float().reshape(b, nc, c, h)
    lff = lf.float().reshape(b, nc, c, h)

    cumf = torch.cumsum(lff, dim=2)                              # inclusive
    # D[i,j] = cumf_i - cumf_j + li_j  (j <= i)
    D = cumf[:, :, :, None, :] - cumf[:, :, None, :, :] + lif[:, :, None, :, :]
    ii = torch.arange(c, device=q.device)
    causal = (ii[:, None] >= ii[None, :])[:, :, None]            # (i,j,1)
    D = torch.where(causal, D, torch.full((), _NEG, device=q.device))
    m_intra = D.amax(dim=3)                                      # (b,nc,c,h)
    sdot = torch.einsum("bzihd,bzjhd->bzijh", qf, kf)            # raw q·k

    if state is None:
        Cs = torch.zeros((b, h, d, d), dtype=torch.float32, device=q.device)
        ns = torch.zeros((b, h, d), dtype=torch.float32, device=q.device)
        ms = torch.full((b, h), _NEG, dtype=torch.float32, device=q.device)
    else:
        Cs, ns, ms = state
    ys = []
    for z in range(nc):
        qz, kz, vz = qf[:, z], kf[:, z], vf[:, z]
        cumf_z, li_z, D_z, sd_z = cumf[:, z], lif[:, z], D[:, z], sdot[:, z]
        m_i = torch.maximum(m_intra[:, z], cumf_z + ms[:, None])  # (b,c,h)
        w = torch.exp(D_z - m_i[:, :, None])                     # (b,i,j,h)
        num = torch.einsum("bijh,bijh,bjhe->bihe", sd_z, w, vz)
        qC = torch.einsum("bihd,bhde->bihe", qz, Cs)
        inter = torch.exp(cumf_z + ms[:, None] - m_i)            # (b,c,h)
        num = num + qC * inter[..., None]
        qn = torch.einsum("bijh,bijh->bih", sd_z, w)
        qn = qn + torch.einsum("bihd,bhd->bih", qz, ns) * inter
        denom = torch.maximum(qn.abs(), torch.exp(-m_i))
        ys.append(num / denom[..., None])
        # the carry to the end of the chunk
        f_end = cumf_z[:, -1]                                    # (b,h)
        g = f_end[:, None] - cumf_z + li_z                       # (b,c,h)
        m_out = torch.maximum(g.amax(dim=1), f_end + ms)
        wC = torch.exp(g - m_out[:, None])                       # (b,c,h)
        carry = torch.exp(f_end + ms - m_out)
        Cs = (Cs * carry[..., None, None]
              + torch.einsum("bch,bchd,bche->bhde", wC, kz, vz))
        ns = ns * carry[..., None] + torch.einsum("bch,bchd->bhd", wC, kz)
        ms = m_out
    y = torch.stack(ys, dim=1).reshape(b, nc * c, h, d)
    return y[:, :s].to(q.dtype), (Cs, ns, ms)


# ------------------------------------------------------------------ templates
def _mlstm_template(cfg: ArchConfig, n: int):
    d = cfg.d_model
    di = int(d * cfg.xlstm.proj_factor)
    h = cfg.n_heads
    return {
        "ln": ParamDef((n, d), ("layers", None), "ones"),
        "w_up": ParamDef((n, d, 2 * di), ("layers", "embed", "ffn"), "scaled"),
        # per-head block-diagonal q/k/v, as in the official mLSTM (di²/h each)
        "wq": ParamDef((n, h, di // h, di // h), ("layers", "heads", None, None),
                       "scaled"),
        "wk": ParamDef((n, h, di // h, di // h), ("layers", "heads", None, None),
                       "scaled"),
        "wv": ParamDef((n, h, di // h, di // h), ("layers", "heads", None, None),
                       "scaled"),
        "w_gates": ParamDef((n, di, 2 * h), ("layers", "ffn", None), "scaled"),
        "gn": ParamDef((n, di), ("layers", None), "ones"),
        "w_down": ParamDef((n, di, d), ("layers", "ffn", "embed"), "scaled"),
    }


def _slstm_template(cfg: ArchConfig, n: int):
    d = cfg.d_model
    h = cfg.n_heads
    dh = d // h
    f = int(d * 4 / 3)
    r_axes = ("layers", None, "heads", None, "ffn") if cfg.xlstm.shard_r \
        else ("layers", None, "heads", None, None)
    return {
        "ln": ParamDef((n, d), ("layers", None), "ones"),
        "w_in": ParamDef((n, d, 4 * d), ("layers", "embed", "ffn"), "scaled"),
        "r": ParamDef((n, 4, h, dh, dh), r_axes, "scaled"),
        "gn": ParamDef((n, d), ("layers", None), "ones"),
        "ln2": ParamDef((n, d), ("layers", None), "ones"),
        "w_up": ParamDef((n, d, 2 * f), ("layers", "embed", "ffn"), "scaled"),
        "w_down": ParamDef((n, f, d), ("layers", "ffn", "embed"), "scaled"),
    }


def template(cfg: ArchConfig):
    xl = cfg.xlstm
    n_super = cfg.n_layers // xl.slstm_every
    n_m_per = xl.slstm_every - 1
    return {
        "embed": ParamDef((cfg.vocab, cfg.d_model), ("vocab", "embed"), "normal", 0.02),
        "final_norm": ParamDef((cfg.d_model,), (None,), "ones"),
        "unembed": ParamDef((cfg.d_model, cfg.vocab), ("embed", "vocab"), "scaled"),
        # (n_super, n_m_per, ...) double-stacked mLSTM params
        "mlstm": {k: ParamDef((n_super,) + pd.shape, ("super",) + pd.axes,
                              pd.init, pd.scale)
                  for k, pd in _mlstm_template(cfg, n_m_per).items()},
        "slstm": _slstm_template(cfg, n_super),
    }


# -------------------------------------------------------------------- applies
def _mlstm_block(lp, x, cfg: ArchConfig, *, seq_mode: str, state=None):
    d = cfg.d_model
    di = int(d * cfg.xlstm.proj_factor)
    h = cfg.n_heads
    dh = di // h
    b, s, _ = x.shape
    hin = L.rms_norm(x, lp["ln"], cfg.norm_eps)
    up = hin @ lp["w_up"]
    xm, z = up[..., :di], up[..., di:]
    xh = xm.reshape(b, s, h, dh)
    q = torch.einsum("bshd,hde->bshe", xh, lp["wq"])
    k = torch.einsum("bshd,hde->bshe", xh, lp["wk"])
    v = torch.einsum("bshd,hde->bshe", xh, lp["wv"])
    gates = (xm @ lp["w_gates"]).float()
    li, lf = gates[..., :h], _log_sigmoid(gates[..., h:])
    if seq_mode == "chunkwise":
        y, st = mlstm_chunkwise(q, k, v, li, lf, chunk=cfg.xlstm.chunk,
                                state=state)
    elif seq_mode == "sequential":
        y, st = mlstm_sequential(q, k, v, li, lf, state=state)
    else:
        raise ValueError(f"unknown mLSTM seq_mode {seq_mode!r}")
    y = y.reshape(b, s, di)
    y = L.rms_norm(y, lp["gn"], cfg.norm_eps) * F.silu(z)
    return x + y @ lp["w_down"], st


def _slstm_block(lp, x, cfg: ArchConfig, *, state=None):
    d = cfg.d_model
    h = cfg.n_heads
    dh = d // h
    b, s, _ = x.shape
    hin = L.rms_norm(x, lp["ln"], cfg.norm_eps)
    gi = (hin @ lp["w_in"]).float().reshape(b, s, 4, h, dh)
    if state is None:
        c = torch.zeros((b, h, dh), dtype=torch.float32, device=x.device)
        n = torch.zeros_like(c)
        hprev = torch.zeros_like(c)
        m = torch.full((b, h, dh), _NEG, dtype=torch.float32, device=x.device)
    else:
        c, n, hprev, m = state
    # the four gates' recurrent matrices side by side per head, (h, dh,
    # 4·dh), laid out once: each step's product reads them in place (an
    # einsum would copy them into its layout every step, and autograd would
    # keep every copy)
    r = lp["r"].float().permute(1, 2, 0, 3).reshape(h, dh, 4 * dh)
    ys = []
    for t in range(s):
        g = gi[:, t]
        rec = torch.bmm(hprev.transpose(0, 1), r).reshape(h, b, 4, dh) \
            .permute(2, 1, 0, 3)                                   # (4,b,h,dh)
        zt = torch.tanh(g[:, 0] + rec[0])
        it = g[:, 1] + rec[1]
        ft = _log_sigmoid(g[:, 2] + rec[2])
        ot = torch.sigmoid(g[:, 3] + rec[3])
        m_new = torch.maximum(ft + m, it)
        ip = torch.exp(it - m_new)
        fp = torch.exp(ft + m - m_new)
        c = fp * c + ip * zt
        n = fp * n + ip
        hprev = ot * c / torch.clamp(n, min=1e-6)
        m = m_new
        ys.append(hprev)
    y = torch.stack(ys, dim=1).reshape(b, s, d).to(x.dtype)
    x = x + L.rms_norm(y, lp["gn"], cfg.norm_eps)
    # gated FFN (paper: proj factor 4/3)
    h2 = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    up = h2 @ lp["w_up"]
    f = lp["w_down"].shape[0]
    y2 = (F.silu(up[..., :f]) * up[..., f:]) @ lp["w_down"]
    return x + y2, (c, n, hprev, m)


def forward(params, tokens, cfg: ArchConfig, *, seq_mode="chunkwise",
            remat=True, act_spec=None):
    """tokens (B, S) int -> (logits (B, S, V), 0.0). ``remat`` recomputes
    each mLSTM block in the backward (``torch.utils.checkpoint``; JAX's
    ``jax.checkpoint``); the sLSTM runs once. ``act_spec`` has no effect
    without a mesh."""
    x = params["embed"][tokens].to(params["final_norm"].dtype)

    def m_block(lp, x):
        def body(x, lp=lp):
            return _mlstm_block(lp, x, cfg, seq_mode=seq_mode)[0]

        return checkpoint(body, x, use_reentrant=False) if remat else body(x)

    for lps, sp in zip(_tree.unstack(params["mlstm"]), _tree.unstack(params["slstm"])):
        for lp in _tree.unstack(lps):
            x = m_block(lp, x)
        x, _ = _slstm_block(sp, x, cfg)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ params["unembed"], 0.0


def make_state(cfg: ArchConfig, batch: int, *, device=None):
    """The recurrent decode state (the xLSTM's 'cache'), O(1) in the
    sequence length, float32 on ``device`` (the card by default)."""
    from repro_torch import _device

    dev = _device.resolve(device)
    xl = cfg.xlstm
    n_super = cfg.n_layers // xl.slstm_every
    n_m = xl.slstm_every - 1
    d = cfg.d_model
    di = int(d * xl.proj_factor)
    h = cfg.n_heads
    dh, dhs = di // h, d // h

    def full(shape, value=0.0):
        return torch.full(shape, value, dtype=torch.float32, device=dev)

    return {
        "mlstm_C": full((n_super, n_m, batch, h, dh, dh)),
        "mlstm_n": full((n_super, n_m, batch, h, dh)),
        "mlstm_m": full((n_super, n_m, batch, h), _NEG),
        "slstm_c": full((n_super, batch, h, dhs)),
        "slstm_n": full((n_super, batch, h, dhs)),
        "slstm_h": full((n_super, batch, h, dhs)),
        "slstm_m": full((n_super, batch, h, dhs), _NEG),
    }


def decode_step(params, tokens, state, pos, cfg: ArchConfig):
    """One token (B,) int; ``state`` as from :func:`make_state`, updated in
    place (``pos`` is not needed: the state carries the sequence). Returns
    ``(logits (B, V), state)``."""
    del pos
    x = params["embed"][tokens][:, None].to(params["final_norm"].dtype)
    mlstm = ("mlstm_C", "mlstm_n", "mlstm_m")
    slstm = ("slstm_c", "slstm_n", "slstm_h", "slstm_m")
    for i, (lps, sp) in enumerate(zip(_tree.unstack(params["mlstm"]),
                                      _tree.unstack(params["slstm"]))):
        for j, lp in enumerate(_tree.unstack(lps)):
            own = tuple(state[k][i, j] for k in mlstm)
            x, new = _mlstm_block(lp, x, cfg, seq_mode="sequential", state=own)
            for dst, src in zip(own, new):
                dst.copy_(src)
        own = tuple(state[k][i] for k in slstm)
        x, new = _slstm_block(sp, x, cfg, state=own)
        for dst, src in zip(own, new):
            dst.copy_(src)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x[:, 0] @ params["unembed"], state
