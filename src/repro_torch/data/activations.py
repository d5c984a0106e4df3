"""Activation harvesting: stream per-layer LM activations into disk shards
(port of ``repro/data/activations.py``).

The factory's first stage (``training/sae_factory.py``) runs a configured LM
over the deterministic token stream and captures the residual-stream or
MLP-branch activations of every requested layer
(``models.lm.forward(collect=...)``). Each harvest step appends one shard per
layer:

    out_dir/
      meta.json                    — d_model, layers, site, dtype,
                                     rows_per_shard, n_shards, arch, seq_len
      layer03_shard00004.npy       — (rows_per_shard, d_model) array

The format on disk is the JAX package's, byte for byte in layout: a harvest
directory written by either package is readable by the other. Shards are
plain ``np.save`` files so the reader memory-maps them.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class HarvestConfig:
    """What to capture and how to lay it out on disk."""
    site: str = "resid"              # "resid" (post-block) | "mlp" (branch out)
    layers: Optional[Sequence[int]] = None   # None -> every layer
    dtype: str = "float32"
    n_steps: int = 4                 # harvest steps (shards per layer)

    def __post_init__(self):
        if self.site not in ("resid", "mlp"):
            raise ValueError(f"unknown harvest site {self.site!r}")


def check_family(cfg) -> None:
    """Harvesting reads per-layer activations through ``forward(collect=)``,
    which the dense and MoE LMs have. The recurrent and audio families'
    forwards have none (the JAX package's harvest unpacks three values from
    their two-valued forward and fails), so they are refused by name."""
    from repro_torch.models.lm import RECURRENT

    if cfg.family in RECURRENT + ("audio",):
        raise ValueError(
            f"{cfg.name}: harvesting captures the per-layer activations of the "
            f"dense and MoE LMs; the {cfg.family} family's forward collects "
            "none")


def _shard_name(layer: int, step: int) -> str:
    return f"layer{layer:03d}_shard{step:05d}.npy"


def harvest(params, cfg, pipe, out_dir, *, hcfg: HarvestConfig = None,
            forward=None, impl: str = "naive") -> dict:
    """Run the LM over ``pipe``'s token stream and shard activations to disk.

    ``pipe`` is a ``DataPipeline`` over tokens; each step's
    ``(n_micro, mb, S)`` batch is flattened to ``(B, S)``, moved to the
    device of ``params["embed"]`` and pushed through ``forward(collect=site)``
    (defaults to ``models.lm.forward``) without autograd. Activations come
    back stacked ``(L, B, S, D)``; each selected layer's rows are flattened
    to ``(B*S, D)`` and appended as one shard. Returns the manifest dict
    (also written to ``meta.json``).
    """
    from repro_torch.models import lm

    check_family(cfg)
    hcfg = hcfg or HarvestConfig()
    fwd = forward or lm.forward
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    device = params["embed"].device

    layers = None
    rows_per_shard = None
    np_dtype = np.dtype(hcfg.dtype)
    for step in range(hcfg.n_steps):
        toks = np.asarray(pipe.batch(step))
        toks = toks.reshape(-1, toks.shape[-1])          # (B, S)
        with torch.no_grad():
            _, _, acts = fwd(params, torch.from_numpy(toks).to(device), cfg,
                             impl=impl, remat=False, collect=hcfg.site)
        if layers is None:
            layers = list(hcfg.layers) if hcfg.layers is not None \
                else list(range(acts.shape[0]))
            bad = [l for l in layers if not 0 <= l < acts.shape[0]]
            if bad:
                raise ValueError(f"layers {bad} out of range for "
                                 f"{acts.shape[0]}-layer model")
            rows_per_shard = acts.shape[1] * acts.shape[2]
        for l in layers:
            rows = acts[l].reshape(rows_per_shard, -1).cpu().numpy()
            np.save(out / _shard_name(l, step), rows.astype(np_dtype))
        del acts
    meta = {
        "d_model": int(cfg.d_model), "layers": layers, "site": hcfg.site,
        "dtype": np_dtype.name, "rows_per_shard": int(rows_per_shard),
        "n_shards": int(hcfg.n_steps), "arch": cfg.name,
        "seq_len": int(np.asarray(pipe.batch(0)).shape[-1]),
    }
    (out / "meta.json").write_text(json.dumps(meta, indent=1) + "\n")
    return meta


def read_meta(harvest_dir) -> dict:
    return json.loads((pathlib.Path(harvest_dir) / "meta.json").read_text())


class ActivationReader:
    """Memory-mapped reader over one layer's shards (DataPipeline plug-in).

    ``batch(step)`` returns ``global_batch`` rows, strided by step with
    stateless wrap-around — the step index IS the cursor. Rows come back
    ``(global_batch, d_model)`` numpy in the harvest dtype.
    """

    def __init__(self, harvest_dir, cfg):
        self.cfg = cfg
        self.meta = read_meta(harvest_dir)
        layer = cfg.activation_layer
        if layer not in self.meta["layers"]:
            raise ValueError(f"layer {layer} not harvested; have "
                             f"{self.meta['layers']}")
        root = pathlib.Path(harvest_dir)
        self.shards = [np.load(root / _shard_name(layer, s), mmap_mode="r")
                       for s in range(self.meta["n_shards"])]
        self.rows_per_shard = self.meta["rows_per_shard"]
        self.n_rows = self.rows_per_shard * len(self.shards)
        if cfg.global_batch > self.n_rows:
            raise ValueError(f"global_batch {cfg.global_batch} exceeds "
                             f"harvested rows {self.n_rows}")

    def batch(self, step: int) -> np.ndarray:
        gb = self.cfg.global_batch
        idx = (np.uint64(step) * np.uint64(gb)
               + np.arange(gb, dtype=np.uint64)) % np.uint64(self.n_rows)
        shard = (idx // self.rows_per_shard).astype(np.int64)
        row = (idx % np.uint64(self.rows_per_shard)).astype(np.int64)
        out = np.empty((gb, self.meta["d_model"]),
                       dtype=np.dtype(self.meta["dtype"]))
        for s in np.unique(shard):
            sel = shard == s
            out[sel] = self.shards[s][row[sel]]
        return out
