"""whisper-small [audio] — enc-dec; conv/mel frontend STUBBED (input_specs
provides precomputed frame embeddings). [arXiv:2212.04356]"""
from repro_torch.configs.base import ModelConfig, AUDIO

CONFIG = ModelConfig(
    name="whisper-small",
    family=AUDIO,
    n_layers=12,                  # decoder layers
    n_encoder_layers=12,
    n_audio_frames=1500,          # 30s audio at 50 Hz post-conv
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    norm="layernorm",
    mlp="gelu",
    rope_theta=0.0,               # whisper uses learned/sinusoidal pos, not rope
    is_encoder_decoder=True,
    source="arXiv:2212.04356 (Whisper small)",
    supports_long_context=False,
)
