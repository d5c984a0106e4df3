"""Autoencoders of the paper (port of ``repro/models/sae.py``).

* The supervised autoencoder of §7.3: encoder d → h → k (latent dim == number
  of classes, used directly as logits), symmetric decoder k → h → d; loss
  α·Huber(x, x̂) + CE(y, z), trained under the hard constraint ‖W‖ ≤ η.
* The activation-dictionary SAE of the factory (``training/sae_factory.py``):
  one hidden layer trained on harvested LM activations, sparsified by the
  paper's HARD constraint — the encoder weight is projected onto the ℓ1,∞
  (or, head-structured, tri-level) ball every optimizer step. The decoder
  weight is the learned dictionary compared across runs with MMCS.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.types import ArchConfig

from .params import ParamDef


def template(cfg: ArchConfig):
    d, h, k = cfg.d_model, cfg.d_ff, cfg.vocab  # vocab doubles as n_classes
    return {
        "enc1": {"w": ParamDef((d, h), ("embed", "ffn"), "scaled"),
                 "b": ParamDef((h,), (None,), "zeros")},
        "enc2": {"w": ParamDef((h, k), ("ffn", None), "scaled"),
                 "b": ParamDef((k,), (None,), "zeros")},
        "dec1": {"w": ParamDef((k, h), (None, "ffn"), "scaled"),
                 "b": ParamDef((h,), (None,), "zeros")},
        "dec2": {"w": ParamDef((h, d), ("ffn", "embed"), "scaled"),
                 "b": ParamDef((d,), (None,), "zeros")},
    }


def _act(x, kind):
    return F.silu(x) if kind == "silu" else F.relu(x)


def forward(params, x, cfg: ArchConfig, *, act: str = "silu", **_):
    """x (B, d) -> (latent logits (B, k), reconstruction (B, d))."""
    h = _act(x @ params["enc1"]["w"] + params["enc1"]["b"], act)
    z = h @ params["enc2"]["w"] + params["enc2"]["b"]
    h2 = _act(z @ params["dec1"]["w"] + params["dec1"]["b"], act)
    xr = h2 @ params["dec2"]["w"] + params["dec2"]["b"]
    return z, xr


def huber(x, y, delta: float = 1.0):
    r = (x - y).abs()
    return torch.where(r < delta, 0.5 * r * r, delta * (r - 0.5 * delta)).mean()


def loss_fn(params, batch, cfg: ArchConfig, *, alpha: float = 1.0,
            act: str = "silu"):
    """Paper eq. (18): α·ψ(X, X̂) + H(Y, Z)."""
    x, y = batch["x"], batch["y"]
    z, xr = forward(params, x, cfg, act=act)
    rec = huber(x, xr)
    logp = torch.log_softmax(z.float(), dim=-1)
    ce = -logp.gather(1, y[:, None].long()).mean()
    return alpha * rec + ce, {"rec": rec, "ce": ce}


# ------------------------------------------------------- activation-dictionary
def dict_template(d_in: int, d_dict: int, heads: int = 1):
    """Params for the activation SAE: encode d_in -> d_dict, decode back.

    ``heads > 1`` is the head-structured variant (paper §6): ``enc/w`` is
    (d_in, heads, d_dict//heads) and ``dec/w`` (heads, d_dict//heads, d_in),
    so a tri-level ν can aggregate per head. The forward math is identical:
    the head axes flatten back to d_dict inside :func:`dict_forward`.
    """
    if d_dict % heads:
        raise ValueError(f"d_dict={d_dict} not divisible by heads={heads}")
    if heads == 1:
        enc_w = ParamDef((d_in, d_dict), ("embed", "ffn"), "scaled")
        dec_w = ParamDef((d_dict, d_in), ("ffn", "embed"), "scaled")
    else:
        enc_w = ParamDef((d_in, heads, d_dict // heads),
                         ("embed", None, "ffn"), "scaled")
        dec_w = ParamDef((heads, d_dict // heads, d_in),
                         (None, "ffn", "embed"), "scaled")
    return {
        "enc": {"w": enc_w,
                "b": ParamDef((d_dict,), (None,), "zeros")},
        "dec": {"w": dec_w,
                "b": ParamDef((d_in,), (None,), "zeros")},
    }


def dict_forward(params, x):
    """x (B, d_in) -> (features (B, d_dict), reconstruction (B, d_in)).

    Pre-bias form (x is decoder-bias-centred before encoding), ReLU features.
    """
    we, wd = params["enc"]["w"], params["dec"]["w"]
    we = we.reshape(we.shape[0], -1)
    wd = wd.reshape(-1, wd.shape[-1])
    xc = x - params["dec"]["b"]
    f = F.relu(xc @ we + params["enc"]["b"])
    xr = f @ wd + params["dec"]["b"]
    return f, xr


def dict_loss(params, x, *, l1: float = 0.0):
    """Scalar reconstruction loss (+ optional L1 on features, default OFF —
    the paper's projection constraint replaces the penalty)."""
    f, xr = dict_forward(params, x)
    mse = (x - xr).square().mean()
    if l1:
        mse = mse + l1 * f.abs().mean()
    return mse


def dict_metrics(params, x):
    """Diagnostics: reconstruction MSE, mean feature L0, fraction dead."""
    f, xr = dict_forward(params, x)
    active = (f > 0).float()
    return {
        "mse": (x - xr).square().mean(),
        "l0": active.sum(dim=-1).mean(),
        "dead_frac": (active.amax(dim=0) == 0).float().mean(),
    }
