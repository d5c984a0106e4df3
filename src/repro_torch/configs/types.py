"""Config dataclasses: architectures, shapes, projection specs, training
(copy of ``repro/configs/types.py``; the port keeps its own copy so it never
imports the JAX package)."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN hidden size
    n_shared: int = 0             # shared (always-on) experts
    d_shared: int = 0             # shared expert hidden size (0 -> d_expert)
    first_dense: int = 0          # leading dense layers before MoE starts
    capacity_factor: float = 1.25
    router_dtype: str = "float32"
    dispatch: str = "einsum"      # "einsum" (GShard) | "scatter" (gather-based)


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64             # N (mamba2 state size)
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64            # mamba2 P
    chunk: int = 128              # SSD chunk length
    n_groups: int = 1             # B/C groups


@dataclass(frozen=True)
class XLSTMConfig:
    slstm_every: int = 8          # one sLSTM per this many layers (rest mLSTM)
    chunk: int = 64               # chunkwise-parallel mLSTM chunk length
    proj_factor: float = 2.0      # up-projection in the mLSTM block
    shard_r: bool = False         # TP-shard the sLSTM recurrent matrices
                                  # (output dh over 'model'; §Perf cell B)


@dataclass(frozen=True)
class HybridConfig:
    attn_every: int = 6           # one shared attention block per N layers
    shared_attn: bool = True      # Zamba2: ONE weight-shared transformer block
    window_at_long: int = 4096    # window applied to shared attn at >=long_seq
    long_seq: int = 131072


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | moe | encdec | ssm | hybrid | vlm | audio | sae
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    qk_norm: bool = False
    window: Optional[int] = None  # sliding-window attention
    rope_pct: float = 1.0
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    act: str = "silu"             # mlp activation
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    hybrid: Optional[HybridConfig] = None
    n_enc_layers: int = 0         # encoder-decoder only
    enc_frames: int = 1500        # stub audio frontend sequence length
    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def params_count(self) -> int:
        """Analytic parameter count (used for roofline MODEL_FLOPS = 6·N·D)."""
        d, f, L, V = self.d_model, self.d_ff, self.n_layers, self.vocab
        hd = self.resolved_head_dim
        emb = V * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.mla is not None:
            m = self.mla
            per_layer += d * m.q_lora_rank + m.q_lora_rank * self.n_heads * (
                m.qk_nope_dim + m.qk_rope_dim)
            per_layer += d * (m.kv_lora_rank + m.qk_rope_dim)
            per_layer += m.kv_lora_rank * self.n_heads * (m.qk_nope_dim + m.v_head_dim)
            per_layer += self.n_heads * m.v_head_dim * d
        elif self.family in ("ssm",):
            pass  # handled below (xlstm)
        else:
            per_layer += d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
            per_layer += self.n_heads * hd * d
        if self.family == "ssm" and self.xlstm is not None:
            di = int(d * self.xlstm.proj_factor)
            per_layer = 2 * d * di + 4 * di * di // 4 + di * d  # rough mLSTM block
        if self.family == "hybrid" and self.ssm is not None:
            di = self.ssm.expand * d
            per_layer = d * (2 * di + 2 * self.ssm.n_groups * self.ssm.d_state) + di * d
        # mlp / moe
        mlp = 3 * d * f if f else 0
        n_moe_layers = 0
        if self.moe is not None:
            n_moe_layers = self.n_layers - self.moe.first_dense
            moe_per_layer = self.moe.n_experts * 3 * d * self.moe.d_expert
            moe_per_layer += self.moe.n_shared * 3 * d * (self.moe.d_shared or self.moe.d_expert)
            moe_per_layer += d * self.moe.n_experts  # router
        total = emb + L * per_layer
        if self.moe is not None:
            total += self.moe.first_dense * mlp + n_moe_layers * moe_per_layer
        else:
            total += L * mlp
        if self.n_enc_layers:
            # encoder stack (self-attn + mlp) and decoder cross-attention
            total += self.n_enc_layers * (per_layer + mlp)
            total += L * per_layer
        return int(total)

    def active_params_count(self) -> int:
        """Active (per-token) params — MoE uses top_k + shared experts only."""
        if self.moe is None:
            return self.params_count()
        d = self.d_model
        dense_like = dataclasses.replace(self, moe=None, d_ff=0)
        base = dense_like.params_count()
        n_moe_layers = self.n_layers - self.moe.first_dense
        act_ffn = (self.moe.top_k * 3 * d * self.moe.d_expert
                   + self.moe.n_shared * 3 * d * (self.moe.d_shared or self.moe.d_expert)
                   + d * self.moe.n_experts)
        return int(base + self.moe.first_dense * 3 * d * self.d_ff
                   + n_moe_layers * act_ffn)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class ProjectionSpec:
    """The paper's technique attached to training: which params, which norm."""
    pattern: str = r"(w_up|w_gate|w_in)"   # regex over param path
    levels: Tuple[Tuple[object, int], ...] = (("inf", 1), (1, 1))  # bi-level l1inf
    radius: float = 1.0
    every: int = 1                # apply cadence (steps)
    method: str = "bisect"        # l1 solver backend (core.ball registry:
                                  # "sort" | "bisect" | "filter"; bisect =
                                  # kernel/TPU friendly + differentiable,
                                  # filter = linear-time CPU/throughput pick;
                                  # "auto" = autotuned per leaf workload by
                                  # core.plan at hook build time)
    transpose: bool = False       # project the transposed trailing axes
                                  # (groups = rows, e.g. SAE feature selection)
    enabled: bool = True


@dataclass(frozen=True)
class TrainConfig:
    microbatch: int = 0           # 0 -> auto (one per data shard)
    lr: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup: int = 100
    total_steps: int = 1000
    seed: int = 0
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    master_dtype: str = "float32"   # "" -> no master copy (params updated in-place)
    moment_dtype: str = "float32"   # "int8" -> block-quantized moments
    grad_allreduce_dtype: str = ""  # "bfloat16" -> compressed cross-replica grads
    remat: bool = True
    projection: Optional[ProjectionSpec] = None
    checkpoint_every: int = 100
    keep_checkpoints: int = 3
