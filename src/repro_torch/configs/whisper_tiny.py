"""whisper-tiny [audio]: encoder-decoder, conv frontend stubbed (the caller
provides precomputed frame embeddings).  [arXiv:2212.04356; unverified]
(counterpart of repro/configs/whisper_tiny.py)"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="encdec",
    num_layers=4,            # decoder layers
    encoder_layers=4,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
    block_pattern=("encdec_attn",),
    norm_kind="layernorm",
    mlp_kind="gelu",
    frontend="audio",
    frontend_tokens=1500,    # 30 s of audio at 50 Hz after the conv
    sub_quadratic=False,
)
