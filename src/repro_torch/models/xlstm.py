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

from repro_torch import _tree
from repro_torch.configs.types import ArchConfig
from repro_torch.parallel import collectives as C
from repro_torch.roofline import costs

from . import layers as L
from . import lm
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
    steps = costs.walked_steps(nc, qf)
    # each input unbound once into its chunks: the backward stacks the
    # chunks' gradients in one pass, where indexing chunk z would give each
    # chunk a zero gradient of the whole input to sum
    parts = (qf, kf, vf, cumf, lif, D, sdot, m_intra)
    chunks = list(zip(*(a.unbind(1) for a in parts))) if steps == nc \
        else [tuple(a[:, 0] for a in parts)]
    for chunk in chunks:
        y_z, Cs, ns, ms = _mlstm_chunk(*chunk, Cs, ns, ms)
        ys.append(y_z)
    y = torch.stack(ys, dim=1)
    if steps < nc:  # a walk on meta tensors: the other chunks counted
        y = costs.count_steps(_mlstm_chunk, chunks[0] + (Cs, ns, ms),
                              nc - steps, y)
        y = y[:, -1:].expand(b, nc, c, h, d).contiguous()
    y = y.reshape(b, nc * c, h, d)
    return y[:, :s].to(q.dtype), (Cs, ns, ms)


def _mlstm_chunk(qz, kz, vz, cumf_z, li_z, D_z, sd_z, m_intra_z, Cs, ns, ms):
    """One chunk of :func:`mlstm_chunkwise`: its outputs (b, c, h, d) from
    the carry (C, n, m) entering it, and the carry to its end."""
    m_i = torch.maximum(m_intra_z, cumf_z + ms[:, None])          # (b,c,h)
    w = torch.exp(D_z - m_i[:, :, None])                         # (b,i,j,h)
    num = torch.einsum("bijh,bijh,bjhe->bihe", sd_z, w, vz)
    qC = torch.einsum("bihd,bhde->bihe", qz, Cs)
    inter = torch.exp(cumf_z + ms[:, None] - m_i)                # (b,c,h)
    num = num + qC * inter[..., None]
    qn = torch.einsum("bijh,bijh->bih", sd_z, w)
    qn = qn + torch.einsum("bihd,bhd->bih", qz, ns) * inter
    denom = torch.maximum(qn.abs(), torch.exp(-m_i))
    y = num / denom[..., None]
    # the carry to the end of the chunk
    f_end = cumf_z[:, -1]                                        # (b,h)
    g = f_end[:, None] - cumf_z + li_z                           # (b,c,h)
    m_out = torch.maximum(g.amax(dim=1), f_end + ms)
    wC = torch.exp(g - m_out[:, None])                           # (b,c,h)
    carry = torch.exp(f_end + ms - m_out)
    Cs = (Cs * carry[..., None, None]
          + torch.einsum("bch,bchd,bche->bhde", wC, kz, vz))
    ns = ns * carry[..., None] + torch.einsum("bch,bchd->bhd", wC, kz)
    return y, Cs, ns, m_out


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


def _slstm_scan(gi, r, state=None):
    """The sLSTM's recurrence over time: gi (b, s, 4, h, dh) float32 input
    gates, r (4, h, dh, dh) the heads' recurrent matrices. Returns h_t
    (b, s, h, dh) float32 and the final (c, n, h, m)."""
    b, s, _, h, dh = gi.shape
    if state is None:
        c = torch.zeros((b, h, dh), dtype=torch.float32, device=gi.device)
        n = torch.zeros_like(c)
        hprev = torch.zeros_like(c)
        m = torch.full((b, h, dh), _NEG, dtype=torch.float32, device=gi.device)
    else:
        c, n, hprev, m = state
    # the four gates' recurrent matrices side by side per head, (h, dh,
    # 4·dh), laid out once: each step's product reads them in place (an
    # einsum would copy them into its layout every step, and autograd would
    # keep every copy)
    r = r.float().permute(1, 2, 0, 3).reshape(h, dh, 4 * dh)
    ys = []
    steps = costs.walked_steps(s, gi)
    # unbound once into its steps: the backward stacks the steps' gradients
    # in one pass (indexing step t would give each a zero gradient of all
    # of gi to sum)
    for g in gi.unbind(1) if steps == s else (gi[:, 0],):
        c, n, hprev, m = _slstm_step(g, r, c, n, hprev, m)
        ys.append(hprev)
    y = torch.stack(ys, dim=1)
    if steps < s:  # a walk on meta tensors: the other steps counted
        y = costs.count_steps(_slstm_step, (gi[:, 0], r, c, n, hprev, m),
                              s - steps, y, shared=(1,))
        y = y.expand(b, s, h, dh).contiguous()
    return y, (c, n, hprev, m)


def _slstm_step(g, r, c, n, hprev, m):
    """One time step of the sLSTM: g (b, 4, h, dh) input gates, r (h, dh,
    4·dh); returns the new (c, n, h, m)."""
    h, dh = r.shape[0], r.shape[1]
    b = g.shape[0]
    rec = torch.bmm(hprev.transpose(0, 1), r).reshape(h, b, 4, dh) \
        .permute(2, 1, 0, 3)                                       # (4,b,h,dh)
    zt = torch.tanh(g[:, 0] + rec[0])
    it = g[:, 1] + rec[1]
    ft = _log_sigmoid(g[:, 2] + rec[2])
    ot = torch.sigmoid(g[:, 3] + rec[3])
    m_new = torch.maximum(ft + m, it)
    ip = torch.exp(it - m_new)
    fp = torch.exp(ft + m - m_new)
    c = fp * c + ip * zt
    n = fp * n + ip
    return c, n, ot * c / torch.clamp(n, min=1e-6), m_new


def _slstm_ffn(lp, x, cfg: ArchConfig):
    """The sLSTM block's gated FFN (paper: proj factor 4/3) and its
    residual."""
    h2 = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    up = h2 @ lp["w_up"]
    f = lp["w_down"].shape[0]
    return x + (F.silu(up[..., :f]) * up[..., f:]) @ lp["w_down"]


def _slstm_block(lp, x, cfg: ArchConfig, *, state=None):
    d = cfg.d_model
    h = cfg.n_heads
    dh = d // h
    b, s, _ = x.shape
    hin = L.rms_norm(x, lp["ln"], cfg.norm_eps)
    gi = (hin @ lp["w_in"]).float().reshape(b, s, 4, h, dh)
    ys, st = _slstm_scan(gi, lp["r"], state)
    y = ys.reshape(b, s, d).to(x.dtype)
    x = x + L.rms_norm(y, lp["gn"], cfg.norm_eps)
    return _slstm_ffn(lp, x, cfg), st


# -------------------------------------------------------------- under a mesh
def _heads_tp(sp, sh) -> bool:
    """Are the block's heads split over a live "model" axis?"""
    return sh.tp(sp["wq" if "wq" in sp else "r"][-3])


def _rms_norm_split(y, scale, n: int, eps, sh):
    """``layers.rms_norm`` over an axis of ``n`` of which ``y`` holds this
    rank's contiguous part (its heads): the sum of squares all-reduced over
    "model" both ways (each rank normalises its own part with it), the
    replicated ``scale`` entered and sliced."""
    yf = y.float()
    ss = yf.square().sum(dim=-1, keepdim=True)
    ss = C.enter(C.leave(ss, sh.mesh), sh.mesh)
    out = yf * torch.rsqrt(ss / n + eps)
    part = C.enter(scale, sh.mesh)[lm.local_slice(n, sh)]
    return (out * part.float()).to(y.dtype)


def _mlstm_sharded(lp, sp, x, cfg: ArchConfig, sh, *, seq_mode: str):
    """:func:`_mlstm_block` under a mesh. On this rank's heads where "model"
    splits them: ``w_up``'s fused ``[x | z]`` gathered whole and this
    rank's heads' columns of each half taken (each rank reads other
    columns, so the gradient is psummed before it is sliced back), the
    gates' partial product over the local ``di`` rows all-reduced, the
    group norm's sum of squares all-reduced, ``w_down`` row-parallel with a
    psum. Otherwise the block runs whole on every rank."""
    if not _heads_tp(sp, sh):
        return _mlstm_block(sh.tree(lp, sp), x, cfg, seq_mode=seq_mode)[0]
    d = cfg.d_model
    di = int(d * cfg.xlstm.proj_factor)
    h = cfg.n_heads
    dh = di // h
    b, s, _ = x.shape
    mine = lm.local_slice(di, sh)
    heads = lm.local_slice(h, sh)
    hin = C.enter(L.rms_norm(x, lp["ln"], cfg.norm_eps), sh.mesh)
    w_up = sh.full(lp["w_up"], sp["w_up"], split=True)
    xm = hin @ w_up[:, mine]
    z = hin @ w_up[:, di + mine.start:di + mine.stop]
    xh = xm.reshape(b, s, -1, dh)
    q = torch.einsum("bshd,hde->bshe", xh, lp["wq"])
    k = torch.einsum("bshd,hde->bshe", xh, lp["wk"])
    v = torch.einsum("bshd,hde->bshe", xh, lp["wv"])
    part = (xm @ lp["w_gates"]).float()            # the local di rows' share
    gates = C.enter(C.leave(part, sh.mesh), sh.mesh)
    li = gates[..., heads]
    lf = _log_sigmoid(gates[..., h + heads.start:h + heads.stop])
    fn = mlstm_chunkwise if seq_mode == "chunkwise" else mlstm_sequential
    kw = {"chunk": cfg.xlstm.chunk} if seq_mode == "chunkwise" else {}
    y, _ = fn(q, k, v, li, lf, **kw)
    y = y.reshape(b, s, -1)
    y = _rms_norm_split(y, lp["gn"], di, cfg.norm_eps, sh) * F.silu(z)
    out = y @ sh.weight(lp["w_down"], sp["w_down"])
    return x + C.leave(out, sh.mesh)


def _slstm_sharded(lp, sp, x, cfg: ArchConfig, sh):
    """:func:`_slstm_block` under a mesh. Where "model" splits the heads of
    ``r``: ``w_in`` gathered whole and this rank's heads' columns of each
    gate taken, the recurrence on the local heads, their outputs gathered
    over "model"; the group norm and the FFN then run whole on every rank.
    Otherwise (heads replicated, or ``shard_r`` splitting r's output axis)
    the block runs whole, its weights gathered once, not at every step."""
    if not _heads_tp(sp, sh):
        return _slstm_block(sh.tree(lp, sp), x, cfg)[0]
    d = cfg.d_model
    h = cfg.n_heads
    dh = d // h
    b, s, _ = x.shape
    hin = C.enter(L.rms_norm(x, lp["ln"], cfg.norm_eps), sh.mesh)
    w_in = sh.full(lp["w_in"], sp["w_in"], split=True)
    w_in = w_in.reshape(d, 4, h, dh)[:, :, lm.local_slice(h, sh)]
    gi = (hin @ w_in.reshape(d, -1)).float().reshape(b, s, 4, -1, dh)
    ys, _ = _slstm_scan(gi, lp["r"])
    ys = C.gather(ys.to(x.dtype), sh.mesh, "model", 2, sum_grad=False)
    x = x + L.rms_norm(ys.reshape(b, s, d), lp["gn"], cfg.norm_eps)
    rest = {k: sh.full(lp[k], sp[k]) for k in ("ln2", "w_up", "w_down")}
    return _slstm_ffn(rest, x, cfg)


def forward(params, tokens, cfg: ArchConfig, *, seq_mode="chunkwise",
            remat=True, act_spec=None, mesh=None, param_specs=None):
    """tokens (B, S) int -> (logits (B, S, V), 0.0). ``remat`` recomputes
    each mLSTM block in the backward (``torch.utils.checkpoint``; JAX's
    ``jax.checkpoint``); the sLSTM runs once. ``act_spec`` has no effect
    without a mesh.

    ``mesh`` and ``param_specs`` run the sharded forward (``models.lm``'s
    module docstring) on this rank's shards and slice of the batch: each
    block on this rank's heads where "model" splits them
    (:func:`_mlstm_sharded`, :func:`_slstm_sharded`), and the logits this
    rank's slice of the vocabulary where "model" shards it."""
    if (mesh is None) != (param_specs is None):
        raise ValueError("a sharded forward takes both mesh= and param_specs=")
    sh = None if mesh is None else lm._Sharded(mesh, param_specs)
    x = (params["embed"][tokens] if sh is None else
         lm.embed_sharded(params, param_specs, tokens, sh))
    x = x.to(params["final_norm"].dtype)
    if sh is not None:
        msp = _tree.tree_map(lambda sp: tuple(sp[2:]), param_specs["mlstm"])
        ssp = _tree.tree_map(lambda sp: tuple(sp[1:]), param_specs["slstm"])

    def m_block(lp, x):
        def body(x, lp=lp):
            if sh is None:
                return _mlstm_block(lp, x, cfg, seq_mode=seq_mode)[0]
            return _mlstm_sharded(lp, msp, x, cfg, sh, seq_mode=seq_mode)

        return lm.checkpointed(body, x, sh is not None) if remat else body(x)

    for lps, sp in zip(_tree.unstack(params["mlstm"]), _tree.unstack(params["slstm"])):
        for lp in _tree.unstack(lps):
            x = m_block(lp, x)
        x = (_slstm_block(sp, x, cfg)[0] if sh is None
             else _slstm_sharded(sp, ssp, x, cfg, sh))
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if sh is None:
        return x @ params["unembed"], 0.0
    return lm.logits_sharded(x, params, param_specs, cfg, sh), 0.0


def tally(t, cfg: ArchConfig, param_specs, batch: int, seq: int, *,
          remat: bool) -> None:
    """The sharded forward's and backward's collectives on one rank into
    ``t`` (``lm.Tally``), block by block as :func:`_mlstm_sharded` and
    :func:`_slstm_sharded` make them (an mLSTM block twice forward under
    ``remat``)."""
    tpl = template(cfg)
    d, item = cfg.d_model, t.itemsize
    di = int(d * cfg.xlstm.proj_factor)
    act = batch * seq * d * item
    t.top(cfg, tpl, param_specs, act, batch * seq)
    n_super = cfg.n_layers // cfg.xlstm.slstm_every
    fwd = 2 if remat else 1
    mt, mp = tpl["mlstm"], param_specs["mlstm"]
    st, spp = tpl["slstm"], param_specs["slstm"]
    for _ in range(n_super * (cfg.xlstm.slstm_every - 1)):
        if not t.tp(mp["wq"][-3]):
            t.tree(mt, mp, fwd, strip=2)
            continue
        t.full(mt["w_up"].shape[2:], mp["w_up"][2:], fwd, split=True)
        t.weight(mt["w_down"].shape[2:], mp["w_down"][2:], fwd)
        t.add("psum", act)                        # hin entered
        t.add("psum", batch * seq * 2 * cfg.n_heads * 4, fwd + 1)   # gates
        t.add("psum", batch * seq * 4, fwd + 1)   # the group norm's squares
        t.add("psum", di * item)                  # gn entered
        t.add("psum", act, fwd)                   # w_down's output
    for _ in range(n_super):
        if not t.tp(spp["r"][-3]):
            t.tree(st, spp, 1, strip=1)
            continue
        t.full(st["w_in"].shape[1:], spp["w_in"][1:], 1, split=True)
        t.add("psum", act)                        # hin entered
        t.add("all_gather", act)                  # the heads' outputs
        for k in ("ln2", "w_up", "w_down"):
            t.full(st[k].shape[1:], spp[k][1:], 1)


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
