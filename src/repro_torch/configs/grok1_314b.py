"""grok-1-314b [moe] — 8 experts top-2. [hf:xai-org/grok-1]"""
from repro_torch.configs.base import ModelConfig, MoEConfig, MOE

CONFIG = ModelConfig(
    name="grok-1-314b",
    family=MOE,
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    moe=MoEConfig(num_experts=8, top_k=2, capacity_factor=1.25),
    norm="rmsnorm",
    mlp="swiglu",                 # grok experts are GeGLU-style (3 matrices)
    source="hf:xai-org/grok-1",
    supports_long_context=False,
)
