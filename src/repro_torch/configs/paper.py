"""The paper's own experimental architectures (Section 5 / Appendix E).

These drive the benchmarks (one per paper table) and the examples. Dims follow
Appendix E; the data is synthetic (no external datasets offline), so the sizes
used by benchmarks are reduced via ``reduced()`` in the registry.
"""
from repro_torch.configs.base import ModelConfig, DBConfig, DENSE

# §5.1 / E.1: 12-layer ViT, patch 4, hidden 128, 4 heads, B=3
VIT_CIFAR = ModelConfig(
    name="vit-cifar",
    family=DENSE,
    n_layers=12,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=512,
    vocab_size=100,               # classes
    norm="layernorm",
    mlp="gelu",
    rope_theta=0.0,
    source="paper §5.1 (ViT CIFAR-100)",
)
VIT_DB = DBConfig(num_blocks=3, overlap_gamma=0.05, loss="ce")

# §5.2 / E.2: DiT-S/2 (12 layers, d=384, 6 heads)
DIT_S2 = ModelConfig(
    name="dit-s2",
    family=DENSE,
    n_layers=12,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=0,                 # continuous targets
    norm="layernorm",
    mlp="gelu",
    rope_theta=0.0,
    source="paper §5.2 (DiT-S/2)",
)
DIT_DB = DBConfig(num_blocks=3, overlap_gamma=0.05, loss="l2")

# §5.4 / E.4: 12-layer Llama-2-style AR transformer, d=768, 12 heads, B=4
AR_LM = ModelConfig(
    name="ar-lm",
    family=DENSE,
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=2048,
    vocab_size=32000,
    norm="rmsnorm",
    mlp="swiglu",
    source="paper §5.4 (Llama-2-style AR)",
)
AR_DB = DBConfig(num_blocks=4, overlap_gamma=0.1, loss="ce")

# §5.3 / E.3: 12-layer DiT-based MDM transformer, d=768, 12 heads, B=3
MDM = ModelConfig(
    name="mdm-text8",
    family=DENSE,
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=32,                # text8: a-z + specials + [MASK]
    norm="layernorm",
    mlp="gelu",
    source="paper §5.3 (MD4 / text8)",
)
MDM_DB = DBConfig(num_blocks=3, overlap_gamma=0.05, loss="ce")

# §5.5 / E.5: Huginn recurrent-depth: 2 prelude + 4 recurrent + 2 coda, d=512, 8H
HUGINN = ModelConfig(
    name="huginn",
    family=DENSE,
    n_layers=4,                   # the recurrent core
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=32000,
    norm="rmsnorm",
    mlp="swiglu",
    source="paper §5.5 (Huginn / Pythia-70M dims)",
)
HUGINN_DB = DBConfig(num_blocks=1, overlap_gamma=0.0, loss="ce")
HUGINN_PRELUDE_LAYERS = 2
HUGINN_CODA_LAYERS = 2
HUGINN_RECURRENCE = 32            # mean recurrence depth at inference
