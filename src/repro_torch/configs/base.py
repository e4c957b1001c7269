"""Config dataclasses for the repro framework.

Everything is a frozen dataclass so configs hash/compare cleanly and can be used
as jit static args. ``ModelConfig`` describes an architecture; ``DBConfig``
describes the DiffusionBlocks conversion (the paper's technique);
``ShapeConfig`` describes an assigned input shape; ``MeshConfig`` the target mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Architecture families
# ---------------------------------------------------------------------------
DENSE = "dense"
MOE = "moe"
HYBRID = "hybrid"   # mamba2 + shared attention (zamba2)
SSM = "ssm"         # xlstm
AUDIO = "audio"     # whisper enc-dec
VLM = "vlm"         # llama-3.2-vision style cross-attn decoder

ARCH_FAMILIES = (DENSE, MOE, HYBRID, SSM, AUDIO, VLM)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2-style SSD parameters (used by hybrid family)."""
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk_size: int = 128


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM block pattern: alternating sLSTM / mLSTM."""
    slstm_every: int = 2          # layer i is sLSTM if i % slstm_every == 0
    mlstm_qk_dim_factor: float = 0.5
    proj_factor: float = 2.0      # up-projection factor inside mLSTM/sLSTM blocks


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # one of ARCH_FAMILIES
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    source: str = ""              # citation: paper / model card

    # attention details
    head_dim: Optional[int] = None           # default d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None     # SWA window (h2o-danube / variants)
    norm: str = "rmsnorm"                    # rmsnorm | layernorm | nonparam_ln (olmo)
    mlp: str = "swiglu"                      # swiglu | gelu
    tie_embeddings: bool = False

    # family-specific
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    # hybrid (zamba2): attention super-block period: every `attn_every` mamba
    # layers one shared attention block is applied.
    attn_every: int = 0
    # vlm: one cross-attention layer every `cross_attn_every` layers
    cross_attn_every: int = 0
    n_image_tokens: int = 0
    # audio (whisper): encoder stack
    n_encoder_layers: int = 0
    n_audio_frames: int = 0

    # shape lowering policy
    supports_long_context: bool = False      # sub-quadratic / bounded-state decode
    is_encoder_decoder: bool = False

    def __post_init__(self):
        assert self.family in ARCH_FAMILIES, self.family
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        assert self.n_heads % max(self.n_kv_heads, 1) == 0, (
            f"{self.name}: n_heads {self.n_heads} not divisible by "
            f"kv {self.n_kv_heads}")

    # ---- derived quantities -------------------------------------------------
    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    def param_count(self) -> int:
        """Analytic parameter count (approximate; matches init to ~1%)."""
        d, h, kv, hd, ff, V, L = (self.d_model, self.n_heads, self.n_kv_heads,
                                  self.head_dim, self.d_ff, self.vocab_size,
                                  self.n_layers)
        emb = V * d * (1 if self.tie_embeddings else 2)
        attn = d * h * hd + 2 * d * kv * hd + h * hd * d
        if self.mlp == "swiglu":
            mlp = 3 * d * ff
        else:
            mlp = 2 * d * ff
        if self.family == MOE:
            assert self.moe is not None
            mlp = mlp * self.moe.num_experts + d * self.moe.num_experts
        per_layer = attn + mlp + 2 * d
        if self.family == SSM:
            # xlstm blocks: rough count via projections
            assert self.xlstm is not None
            d_in = int(d * self.xlstm.proj_factor)
            per_layer = 2 * d * d_in + 4 * d_in * d_in // 4 + 2 * d
            return emb + L * per_layer
        if self.family == HYBRID:
            assert self.ssm is not None
            d_in = self.ssm.expand * d
            n_h = d_in // self.ssm.head_dim
            mamba = (d * (2 * d_in + 2 * n_h * self.ssm.d_state + n_h)
                     + d_in * d)
            return emb + L * (mamba + 2 * d) + (attn + mlp + 2 * d)  # + shared attn
        total = emb + L * per_layer
        if self.family == AUDIO:
            total += self.n_encoder_layers * (2 * attn + mlp + 3 * d)
        if self.family == VLM and self.cross_attn_every:
            n_cross = self.n_layers // self.cross_attn_every
            total += n_cross * (attn + 2 * d)
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top_k experts active)."""
        if self.family != MOE:
            return self.param_count()
        assert self.moe is not None
        d, ff, L = self.d_model, self.d_ff, self.n_layers
        n_mats = 3 if self.mlp == "swiglu" else 2
        dense_like = self.param_count()
        all_experts = L * n_mats * d * ff * self.moe.num_experts
        active = L * n_mats * d * ff * self.moe.top_k
        return dense_like - all_experts + active


# ---------------------------------------------------------------------------
# DiffusionBlocks configuration (the paper's technique)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DBConfig:
    """Paper §3 + App. C/E defaults (EDM, Karras et al. 2022)."""
    num_blocks: int = 3
    p_mean: float = -1.2
    p_std: float = 1.2
    sigma_min: float = 0.002
    sigma_max: float = 80.0
    sigma_data: float = 0.5
    overlap_gamma: float = 0.05          # 0.1 for text per App. C
    partition: str = "equiprob"          # equiprob | uniform (ablation, Table 7)
    causal_mode: str = "concat"          # concat | two_pass (App. E.4)
    cond_dim: int = 256                  # sigma-embedding fourier dim
    num_sampling_steps: int = 50         # Euler steps at inference (App. E)
    embed_l2_normalize: bool = True      # App. C (anti embedding-collapse)
    loss: str = "ce"                     # ce (discrete targets) | l2 (continuous)

    def __post_init__(self):
        assert self.partition in ("equiprob", "uniform")
        assert self.causal_mode in ("concat", "two_pass")
        assert self.loss in ("ce", "l2")
        assert self.num_blocks >= 1


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    multi_pod: bool = False

    @property
    def shape(self) -> Tuple[int, ...]:
        return (2, 16, 16) if self.multi_pod else (16, 16)

    @property
    def axes(self) -> Tuple[str, ...]:
        return ("pod", "data", "model") if self.multi_pod else ("data", "model")

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


# ---------------------------------------------------------------------------
# Training configuration (drivers / examples)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 200
    batch_size: int = 16
    seq_len: int = 128
    lr: float = 3e-4
    warmup_steps: int = 20
    weight_decay: float = 0.03
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    seed: int = 0
    log_every: int = 20
    ckpt_every: int = 0                 # 0 = disabled
    ckpt_dir: str = "/tmp/repro_ckpt"
    remat: bool = False
