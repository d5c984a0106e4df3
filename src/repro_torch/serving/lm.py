"""LM serving helpers: the single-token decode step, the batched prefill
and eager greedy generation (port of ``repro/serving/lm.py``). The
projection engine, the async continuous-batching tier, lives in
``serving/engine.py``.

Decode state per family, each written in place by its ``decode_step``,
whose position is a Python int the caller counts on the host:

  dense / moe : a KV cache (a ring buffer when the model is windowed), or
                an MLA model's latent cache (``c_kv`` and ``k_rope``)
  hybrid      : zamba's O(1) Mamba states and its shared attention's KV
  ssm         : xLSTM's O(1) recurrent state
  audio       : whisper's decoder self-cache and the encoder's cross K/V
                (zero unless the caller fills them, as in the JAX package)

``n_groups`` reaches the MoE dispatch of every decode step (the batch's
tokens queue for the experts in that many groups); as in the JAX package
only the dense, MoE and VLM families take it, and the recurrent families'
forwards take no ``impl``.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import models
from repro_torch.configs.types import ArchConfig
from repro_torch.models.lm import RECURRENT


def make_decode_step(cfg: ArchConfig, api, *, n_groups: int = 1,
                     max_len: Optional[int] = None):
    """``step(params, tokens (B,), cache, pos) -> (next_tokens, logits,
    cache)``: greedy argmax as int32; ``pos`` a Python int. ``max_len``,
    the length the cache was made for, reaches the hybrid family's decode
    step, whose shared attention is windowed over a ring cache from
    ``long_seq`` on (a position past the ring's slots needs it)."""

    kw = {"n_groups": n_groups} if cfg.family in ("dense", "moe", "vlm") else {}
    if cfg.family == "hybrid" and max_len is not None:
        kw["max_len"] = max_len

    def step(params, tokens, cache, pos):
        logits, cache = api.decode_step(params, tokens, cache, pos, cfg, **kw)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        return nxt, logits, cache

    return step


def make_prefill(cfg: ArchConfig, api, *, impl="chunked", act_spec=None):
    """``prefill(params, tokens (B, S)) -> logits (B, V)``: the
    teacher-forced pass's last-position logits."""

    kw = {"remat": True, "act_spec": act_spec}
    if cfg.family not in RECURRENT:
        kw["impl"] = impl

    def prefill(params, tokens):
        with torch.inference_mode():
            logits, _ = api.forward(params, tokens, cfg, **kw)
        return logits[:, -1]

    return prefill


def generate(params, cfg: ArchConfig, prompt, max_new: int, *,
             n_groups: int = 1, max_len: Optional[int] = None):
    """Eager greedy generation: the prompt replayed through ``decode_step``
    (simple and exact), then greedy continuation. ``prompt`` (B, S) int on
    the parameters' device; returns the (B, max_new) int32 new tokens."""
    api = models.get(cfg)
    b, s = prompt.shape
    max_len = max_len or (s + max_new)
    dev = params["embed"].device
    cache = api.make_cache(cfg, b, max_len, dtype=torch.float32, device=dev)
    step = make_decode_step(cfg, api, n_groups=n_groups, max_len=max_len)
    with torch.inference_mode():
        toks = prompt.to(dev)
        nxt = None
        for i in range(s):
            nxt, _, cache = step(params, toks[:, i], cache, i)
        out = [nxt]
        for j in range(max_new - 1):
            nxt, _, cache = step(params, out[-1], cache, s + j)
            out.append(nxt)
        return torch.stack(out, dim=1)
