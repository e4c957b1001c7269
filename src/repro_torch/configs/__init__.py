"""Config registry: ``get_config(name)``, ``reduced(cfg)`` smoke variants, shapes.

A verbatim copy of ``repro.configs`` (pure dataclasses): the port keeps its
own copy so that it imports nothing of the JAX package."""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.configs.base import (ARCH_FAMILIES, AUDIO, DENSE, HYBRID,
                                      MOE, SSM, VLM, DBConfig, MeshConfig,
                                      ModelConfig, MoEConfig, SSMConfig,
                                      ShapeConfig, TrainConfig, XLSTMConfig,
                                      INPUT_SHAPES)

from repro_torch.configs.qwen1_5_32b import CONFIG as _QWEN
from repro_torch.configs.h2o_danube3_4b import CONFIG as _DANUBE
from repro_torch.configs.zamba2_7b import CONFIG as _ZAMBA
from repro_torch.configs.phi3_5_moe import CONFIG as _PHI
from repro_torch.configs.grok1_314b import CONFIG as _GROK
from repro_torch.configs.whisper_small import CONFIG as _WHISPER
from repro_torch.configs.stablelm_1_6b import CONFIG as _STABLELM
from repro_torch.configs.xlstm_125m import CONFIG as _XLSTM
from repro_torch.configs.olmo_1b import CONFIG as _OLMO
from repro_torch.configs.llama32_vision_11b import CONFIG as _LLAMA_V

ARCH_CONFIGS: Dict[str, ModelConfig] = {
    c.name: c for c in
    [_QWEN, _DANUBE, _ZAMBA, _PHI, _GROK, _WHISPER, _STABLELM, _XLSTM, _OLMO,
     _LLAMA_V]
}

# Default DiffusionBlocks config per assigned arch (text domain: gamma=0.1, CE).
DEFAULT_DB = DBConfig(num_blocks=4, overlap_gamma=0.1, loss="ce")


def list_archs() -> List[str]:
    return sorted(ARCH_CONFIGS)


def get_config(name: str) -> ModelConfig:
    if name not in ARCH_CONFIGS:
        raise KeyError(f"unknown arch {name!r}; available: {list_archs()}")
    return ARCH_CONFIGS[name]


def get_shape(name: str) -> ShapeConfig:
    if name not in INPUT_SHAPES:
        raise KeyError(f"unknown shape {name!r}; available: {sorted(INPUT_SHAPES)}")
    return INPUT_SHAPES[name]


def reduced(cfg: ModelConfig, *, n_layers: int = 2, d_model: int = 256,
            n_heads: int = 4, vocab: int = 512) -> ModelConfig:
    """Smoke-test variant of the same family: <=2 layers, d_model<=512, <=4 experts.

    Preserves every structural trait (GQA ratio, SWA, MoE, hybrid interleave,
    enc-dec, cross-attn, norm type) while shrinking dims for CPU execution.
    """
    kv = max(1, n_heads // max(1, cfg.q_per_kv))
    changes = dict(
        n_layers=n_layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=kv,
        head_dim=d_model // n_heads,
        d_ff=0 if cfg.d_ff == 0 else d_model * 4,
        vocab_size=min(cfg.vocab_size, vocab) if cfg.vocab_size else 0,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else None,
    )
    if cfg.moe is not None:
        changes["moe"] = dataclasses.replace(cfg.moe, num_experts=4, top_k=2)
    if cfg.ssm is not None:
        changes["ssm"] = dataclasses.replace(
            cfg.ssm, d_state=16, head_dim=32, chunk_size=16)
    if cfg.attn_every:
        changes["attn_every"] = 1
        changes["n_layers"] = 2
    if cfg.cross_attn_every:
        changes["cross_attn_every"] = 2
        changes["n_layers"] = 2
        changes["n_image_tokens"] = 16
    if cfg.is_encoder_decoder:
        changes["n_encoder_layers"] = 2
        changes["n_audio_frames"] = 32
    return dataclasses.replace(cfg, **changes)


__all__ = [
    "ARCH_CONFIGS", "ARCH_FAMILIES", "AUDIO", "DENSE", "HYBRID", "MOE", "SSM",
    "VLM", "DBConfig", "DEFAULT_DB", "INPUT_SHAPES", "MeshConfig",
    "ModelConfig", "MoEConfig", "SSMConfig", "ShapeConfig", "TrainConfig",
    "XLSTMConfig", "get_config", "get_shape", "list_archs", "reduced",
]
