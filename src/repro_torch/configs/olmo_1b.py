"""olmo-1b [dense] — non-parametric LayerNorm. [arXiv:2402.00838]"""
from repro_torch.configs.base import ModelConfig, DENSE

CONFIG = ModelConfig(
    name="olmo-1b",
    family=DENSE,
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=50304,
    norm="nonparam_ln",           # OLMo: LayerNorm without affine params
    mlp="swiglu",
    tie_embeddings=True,
    source="arXiv:2402.00838 (OLMo-1B)",
    supports_long_context=False,
)
