"""stablelm-1.6b [dense]. [hf:stabilityai/stablelm-2-1_6b]"""
from repro_torch.configs.base import ModelConfig, DENSE

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    family=DENSE,
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=5632,
    vocab_size=100352,
    norm="layernorm",
    mlp="swiglu",
    source="hf:stabilityai/stablelm-2-1_6b",
    supports_long_context=False,
)
