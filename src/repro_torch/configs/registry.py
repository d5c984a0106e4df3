"""Assigned architectures + the paper's SAE (copy of
``repro/configs/registry.py``).

Every entry has a reduced smoke variant (``smoke_config``) used by the CPU
tests; the full entries are what the port runs on the card.
"""

from __future__ import annotations

import dataclasses

from .types import (ArchConfig, HybridConfig, MLAConfig, MoEConfig, SSMConfig,
                    XLSTMConfig)

_ARCHS = {}


def _register(cfg: ArchConfig) -> ArchConfig:
    _ARCHS[cfg.name] = cfg
    return cfg


STABLELM_1_6B = _register(ArchConfig(
    name="stablelm-1.6b", family="dense", n_layers=24, d_model=2048,
    n_heads=32, n_kv_heads=32, d_ff=5632, vocab=100352, rope_pct=0.25,
    notes="[hf:stabilityai/stablelm-2-1_6b] MHA (kv=heads), partial rotary",
))

H2O_DANUBE_1_8B = _register(ArchConfig(
    name="h2o-danube-1.8b", family="dense", n_layers=24, d_model=2560,
    n_heads=32, n_kv_heads=8, d_ff=6912, vocab=32000, window=4096,
    notes="[arXiv:2401.16818] llama+mistral mix, sliding-window attention",
))

GRANITE_3_2B = _register(ArchConfig(
    name="granite-3-2b", family="dense", n_layers=40, d_model=2048,
    n_heads=32, n_kv_heads=8, d_ff=8192, vocab=49155,
    notes="[hf:ibm-granite/granite-3.0-2b-base] GQA",
))

QWEN3_32B = _register(ArchConfig(
    name="qwen3-32b", family="dense", n_layers=64, d_model=5120,
    n_heads=64, n_kv_heads=8, d_ff=25600, vocab=151936, qk_norm=True,
    head_dim=128,
    notes="[hf:Qwen/Qwen3] qk_norm, GQA",
))

WHISPER_LARGE_V3 = _register(ArchConfig(
    name="whisper-large-v3", family="audio", n_layers=32, d_model=1280,
    n_heads=20, n_kv_heads=20, d_ff=5120, vocab=51866, n_enc_layers=32,
    enc_frames=1500, act="gelu", rope_pct=0.0,
    notes="[arXiv:2212.04356] enc-dec; conv frontend is a STUB "
          "(input_specs provides frame embeddings); learned abs positions",
))

DEEPSEEK_V3_671B = _register(ArchConfig(
    name="deepseek-v3-671b", family="moe", n_layers=61, d_model=7168,
    n_heads=128, n_kv_heads=128, d_ff=18432, vocab=129280,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, qk_nope_dim=128,
                  qk_rope_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=256, top_k=8, d_expert=2048, n_shared=1,
                  d_shared=2048, first_dense=3),
    notes="[arXiv:2412.19437] MLA, 1 shared + 256 routed top-8. MTP head "
          "omitted (training-objective add-on, see DESIGN.md).",
))

KIMI_K2_1T = _register(ArchConfig(
    name="kimi-k2-1t-a32b", family="moe", n_layers=61, d_model=7168,
    n_heads=64, n_kv_heads=8, d_ff=18432, vocab=163840,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, qk_nope_dim=128,
                  qk_rope_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=384, top_k=8, d_expert=2048, n_shared=1,
                  d_shared=2048, first_dense=1),
    notes="[Kimi K2 paper table] trillion-param MoE, 384 routed top-8",
))

CHAMELEON_34B = _register(ArchConfig(
    name="chameleon-34b", family="vlm", n_layers=48, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=22016, vocab=65536, qk_norm=True,
    notes="[arXiv:2405.09818] early-fusion; VQ image tokens share the vocab, "
          "image frontend is a STUB (tokens arrive pre-quantized)",
))

XLSTM_1_3B = _register(ArchConfig(
    name="xlstm-1.3b", family="ssm", n_layers=48, d_model=2048,
    n_heads=4, n_kv_heads=4, d_ff=0, vocab=50304,
    xlstm=XLSTMConfig(slstm_every=8, chunk=64, proj_factor=2.0),
    notes="[arXiv:2405.04517] sLSTM + mLSTM blocks (7:1), no FFN (d_ff=0)",
))

ZAMBA2_7B = _register(ArchConfig(
    name="zamba2-7b", family="hybrid", n_layers=81, d_model=3584,
    n_heads=32, n_kv_heads=32, d_ff=14336, vocab=32000,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=128,
                  n_groups=2),
    hybrid=HybridConfig(attn_every=6, shared_attn=True, window_at_long=4096,
                        long_seq=131072),
    notes="[arXiv:2411.15242] Mamba2 backbone + ONE weight-shared attn+MLP "
          "block applied every 6 layers (LoRA per-application omitted)",
))

SAE_PAPER = _register(ArchConfig(
    name="sae-paper", family="sae", n_layers=1, d_model=2000, n_heads=1,
    n_kv_heads=1, d_ff=128, vocab=2,
    notes="paper §7.3 supervised autoencoder: d→h→k=classes, symmetric",
))

ARCHS = dict(_ARCHS)
ASSIGNED = [n for n in ARCHS if n != "sae-paper"]


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def smoke_config(name: str) -> ArchConfig:
    """Tiny same-family config for CPU smoke tests (shapes only, not capacity)."""
    cfg = get_arch(name)
    kw = dict(
        n_layers=min(cfg.n_layers, 4) if cfg.family != "hybrid" else 7,
        d_model=64, n_heads=4, n_kv_heads=min(4, max(1, cfg.n_kv_heads // 8)),
        d_ff=128 if cfg.d_ff else 0, vocab=256, head_dim=16,
    )
    if cfg.family == "dense" and cfg.n_kv_heads == cfg.n_heads:
        kw["n_kv_heads"] = 4
    if cfg.window:
        kw["window"] = 16
    if cfg.moe:
        kw["moe"] = dataclasses.replace(
            cfg.moe, n_experts=8, top_k=2, d_expert=32, d_shared=32,
            first_dense=min(cfg.moe.first_dense, 1))
    if cfg.mla:
        kw["mla"] = MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16,
                              qk_rope_dim=8, v_head_dim=16)
    if cfg.ssm:
        kw["ssm"] = dataclasses.replace(cfg.ssm, d_state=16, head_dim=16, chunk=16)
    if cfg.xlstm:
        kw["xlstm"] = dataclasses.replace(cfg.xlstm, slstm_every=4, chunk=8)
        kw["n_layers"] = 8
    if cfg.hybrid:
        kw["hybrid"] = dataclasses.replace(cfg.hybrid, attn_every=3)
        kw["n_layers"] = 7
    if cfg.n_enc_layers:
        kw["n_enc_layers"] = 2
        kw["enc_frames"] = 32
    if cfg.family == "sae":
        kw = dict(n_layers=1, d_model=64, n_heads=1, n_kv_heads=1, d_ff=16,
                  vocab=2, head_dim=0)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **kw)
