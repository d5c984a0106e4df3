"""repro_torch.models — the model API of the port (``repro/models`` counterpart).

    api = models.get(cfg)        # family-dispatched function bundle
    params = params.init_params(api.template(cfg), seed, device="cuda")
    logits, aux = api.forward(params, tokens, cfg, ...)
    cache = api.make_cache(cfg, batch, max_len, device="cuda")  (None for the SAE)
    logits, cache = api.decode_step(params, toks, cache, pos, cfg)

The port covers the LM families of ``lm`` (dense, and the MoE family with
MLA attention, each with its cache decode) and the paper's SAE (``sae``,
train-only). The audio (whisper), SSM (xLSTM) and hybrid (zamba) models
wait for their slices.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.configs.types import ArchConfig

from . import layers, lm, params, sae  # noqa: F401


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
    if fam == "sae":
        return ModelAPI(sae.template, sae.forward)
    waiting = {"audio": "whisper", "ssm": "xLSTM", "hybrid": "zamba"}
    if fam in waiting:
        raise ValueError(f"{cfg.name}: family {fam!r} ({waiting[fam]}) is not "
                         "ported yet; the port covers the dense and MoE LMs "
                         "and the SAE")
    raise ValueError(f"unknown family {fam!r}")
