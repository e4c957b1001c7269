"""xlstm-125m [ssm] — alternating sLSTM + mLSTM blocks. [arXiv:2405.04517]"""
from repro_torch.configs.base import ModelConfig, XLSTMConfig, SSM

CONFIG = ModelConfig(
    name="xlstm-125m",
    family=SSM,
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,                       # xLSTM blocks carry their own up-projection
    vocab_size=50304,
    xlstm=XLSTMConfig(slstm_every=2, proj_factor=2.0),
    norm="layernorm",
    mlp="gelu",
    source="arXiv:2405.04517 (xLSTM)",
    supports_long_context=True,   # O(1) recurrent state
)
