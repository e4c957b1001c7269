"""zamba2-7b [hybrid] — Mamba2 backbone + shared attention blocks. [arXiv:2411.15242]

81 Mamba2 layers; one *shared-weight* attention+MLP block applied every 3 mamba
layers (27 applications of the same params), following the Zamba2 shared-block
design. Attention inside the shared block uses a bounded window so decode state
stays sub-quadratic-friendly for long_500k.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, HYBRID

CONFIG = ModelConfig(
    name="zamba2-7b",
    family=HYBRID,
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk_size=128),
    attn_every=3,                 # 81 = 27 super-blocks x 3 mamba layers
    sliding_window=4096,          # shared attn block uses a window (bounded state)
    norm="rmsnorm",
    mlp="swiglu",
    source="arXiv:2411.15242 (Zamba2-7B)",
    supports_long_context=True,
)
