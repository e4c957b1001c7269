"""llama-3.2-vision-11b [vlm] — cross-attn image layers every 5th layer; vision
encoder STUBBED (input_specs provides patch embeddings).
[hf:meta-llama/Llama-3.2-11B-Vision]"""
from repro_torch.configs.base import ModelConfig, VLM

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family=VLM,
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    cross_attn_every=5,           # 8 cross-attn layers in 40
    n_image_tokens=1601,          # ViT-H/14 @ 560px + cls, per model card
    norm="rmsnorm",
    mlp="swiglu",
    source="hf:meta-llama/Llama-3.2-11B-Vision",
    supports_long_context=False,
)
