"""h2o-danube-3-4b [dense] — llama+mistral mix, sliding-window
attention. [arXiv:2401.16818]"""
from repro_torch.configs.base import ModelConfig, DENSE

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family=DENSE,
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_ff=10240,
    vocab_size=32000,
    sliding_window=4096,          # mistral-style SWA -> bounded KV cache
    norm="rmsnorm",
    mlp="swiglu",
    source="arXiv:2401.16818 (H2O-Danube3)",
    supports_long_context=True,   # SWA bounds decode state -> long_500k runs
)
