"""mixtral-8x22b [moe]: 8 experts top-2, GQA kv=8, sliding window 4096.
[arXiv:2401.04088; hf:mistralai/Mixtral-8x22B-v0.1] (counterpart of
repro/configs/mixtral_8x22b.py)"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    num_experts=8,
    experts_per_token=2,
    sliding_window=4096,
    rope_theta=1e6,
    sub_quadratic=True,  # the window bounds the KV cache
)
