"""Deterministic, shardable data pipeline (port of ``repro/data/pipeline.py``).

Synthetic token streams are generated by a counter-based hash (no stored
state beyond the step index) so that (a) every host can produce exactly its
own shard without coordination, and (b) checkpoint-restart resumes the stream
bit-exactly from the step counter alone — the data cursor IS the step.
A memory-mapped binary token-file reader provides the real-data path.

Everything here is numpy on the host, as in the JAX package, so the port's
token stream is bit-identical to the reference's; callers move a batch to
their device.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    microbatch: int          # micro-batch size (global across data shards)
    seed: int = 0
    token_file: Optional[str] = None
    # harvested-activation consumption (data/activations.py): point at a
    # harvest directory and pick a layer, and batch(step) yields
    # (n_micro, microbatch, d_model) float rows instead of token ids
    activation_dir: Optional[str] = None
    activation_layer: int = 0


def _hash_tokens(step: int, cfg: DataConfig) -> np.ndarray:
    """Counter-based generator: tokens = splitmix-ish hash of (seed, step, i)."""
    n = cfg.global_batch * cfg.seq_len
    idx = (np.arange(n, dtype=np.uint64)
           + np.uint64(step) * np.uint64(n)
           + np.uint64(cfg.seed) * np.uint64(0x9E3779B97F4A7C15))
    z = idx + np.uint64(0x9E3779B97F4A7C15)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    z = z ^ (z >> np.uint64(31))
    return (z % np.uint64(cfg.vocab)).astype(np.int32)


class TokenFileReader:
    """Memory-mapped int32 token file, strided by step (host-shardable)."""

    def __init__(self, path: str, cfg: DataConfig):
        self.cfg = cfg
        self.arr = np.memmap(path, dtype=np.int32, mode="r")
        self.tokens_per_step = cfg.global_batch * cfg.seq_len

    def batch(self, step: int) -> np.ndarray:
        n = self.tokens_per_step
        start = (step * n) % max(len(self.arr) - n, 1)
        return np.asarray(self.arr[start:start + n], np.int32)


class DataPipeline:
    """batch(step) -> (n_micro, microbatch, seq_len) int32 (numpy, host).

    With ``cfg.activation_dir`` set, the pipeline reads harvested activation
    shards instead (data/activations.py) and ``batch(step)`` returns
    ``(n_micro, microbatch, d_model)`` float rows — same stateless step-cursor
    contract either way.
    """

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        if cfg.global_batch % cfg.microbatch:
            raise ValueError("global_batch must be a multiple of microbatch")
        self.n_micro = cfg.global_batch // cfg.microbatch
        if cfg.activation_dir:
            from .activations import ActivationReader
            self.reader = ActivationReader(cfg.activation_dir, cfg)
        elif cfg.token_file:
            self.reader = TokenFileReader(cfg.token_file, cfg)
        else:
            self.reader = None

    def batch(self, step: int) -> np.ndarray:
        flat = (self.reader.batch(step) if self.reader
                else _hash_tokens(step, self.cfg))
        return flat.reshape(self.n_micro, self.cfg.microbatch, -1)

    def iterate(self, start_step: int = 0) -> Iterator[np.ndarray]:
        step = start_step
        while True:
            yield self.batch(step)
            step += 1


def classification_synthetic(n_samples=1000, n_features=2000, n_informative=64,
                             class_sep=0.8, n_classes=2, seed=0):
    """numpy clone of sklearn.make_classification as used in paper §7.3.2:
    informative features are class-dependent Gaussian clusters (one cluster
    per class at ±class_sep on a random subset), the rest pure noise."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, n_classes, n_samples)
    x = rng.normal(size=(n_samples, n_features)).astype(np.float32)
    info = rng.choice(n_features, n_informative, replace=False)
    centers = rng.normal(size=(n_classes, n_informative))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True) / np.sqrt(8.0)
    x[:, info] += class_sep * centers[y]
    # flip_y: sklearn's default label noise
    flip = rng.random(n_samples) < 0.02
    y = np.where(flip, rng.integers(0, n_classes, n_samples), y)
    return x, y.astype(np.int32), info


def lung_like(n_samples=1005, n_features=2944, n_informative=96, seed=1):
    """LUNG-dataset stand-in (metabolomics are unavailable offline):
    log-normal heteroscedastic intensities + log-transform, 2 classes
    (469 NSCLC / 536 control proportions), class signal on a sparse subset."""
    rng = np.random.default_rng(seed)
    n_informative = min(n_informative, n_features // 2)
    n_pos = int(n_samples * 469 / 1005)
    y = np.concatenate([np.ones(n_pos), np.zeros(n_samples - n_pos)])
    rng.shuffle(y)
    base = rng.lognormal(mean=2.0, sigma=1.0, size=(n_samples, n_features))
    info = rng.choice(n_features, n_informative, replace=False)
    effect = rng.normal(0.3, 0.1, n_informative) * rng.choice([-1, 1], n_informative)
    base[:, info] *= np.exp(effect[None, :] * y[:, None])
    x = np.log1p(base).astype(np.float32)   # the paper's log-transform
    x = (x - x.mean(0)) / (x.std(0) + 1e-6)
    return x, y.astype(np.int32), info
