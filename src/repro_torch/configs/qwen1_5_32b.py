"""qwen1.5-32b [dense] — QKV bias. [hf:Qwen/Qwen1.5-0.5B family scaled
per assignment]"""
from repro_torch.configs.base import ModelConfig, DENSE

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family=DENSE,
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27392,
    vocab_size=152064,
    qkv_bias=True,
    norm="rmsnorm",
    mlp="swiglu",
    source="hf:Qwen/Qwen1.5-0.5B (family; dims per assignment)",
    supports_long_context=False,
)
