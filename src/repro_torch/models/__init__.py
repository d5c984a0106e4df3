"""repro_torch.models — the model API of the port (``repro/models`` counterpart).

    api = models.get(cfg)        # family-dispatched function bundle
    params = params.init_params(api.template(cfg), seed, device="cuda")
    logits, aux = api.forward(params, tokens, cfg, ...)
    cache = api.make_cache(cfg, batch, max_len, device="cuda")  (None for the SAE)
    logits, cache = api.decode_step(params, toks, cache, pos, cfg)

The port covers the LM families of ``lm`` (dense, and the MoE family with
MLA attention, each with its cache decode), the recurrent families, hybrid
(``zamba``: Mamba2 with a shared attention block) and SSM (``xlstm``),
each with an O(1) recurrent decode state, the audio family (``whisper``:
an encoder-decoder with cross-attention, decoding against a self-attention
cache and the encoder's cross K/V), and the paper's SAE (``sae``,
train-only).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.configs.types import ArchConfig

from . import layers, lm, params, sae, whisper, xlstm, zamba  # noqa: F401


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    template: Callable
    forward: Callable
    make_cache: Optional[Callable] = None
    decode_step: Optional[Callable] = None


def get(cfg: ArchConfig) -> ModelAPI:
    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        return ModelAPI(lm.template, lm.forward, lm.make_cache, lm.decode_step)
    if fam == "audio":
        return ModelAPI(whisper.template, whisper.forward, whisper.make_cache,
                        whisper.decode_step)
    if fam == "ssm":
        return ModelAPI(xlstm.template, xlstm.forward, _xlstm_cache,
                        xlstm.decode_step)
    if fam == "hybrid":
        return ModelAPI(zamba.template, zamba.forward, zamba.make_cache,
                        zamba.decode_step)
    if fam == "sae":
        return ModelAPI(sae.template, sae.forward)
    raise ValueError(f"unknown family {fam!r}")


def _xlstm_cache(cfg: ArchConfig, batch: int, _max_len: int, dtype=None, *,
                 device=None):
    """``make_cache`` of the SSM family: the recurrent state, whose size
    does not depend on the length (its dtype is float32 whatever ``dtype``
    asks, as in the JAX package)."""
    return xlstm.make_state(cfg, batch, device=device)
