"""grok-1-314b [moe]: 8 experts top-2, GQA kv=8, full attention.
[hf:xai-org/grok-1] (counterpart of repro/configs/grok_1_314b.py)"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131072,
    num_experts=8,
    experts_per_token=2,
    rope_theta=1e4,
    sub_quadratic=False,  # full attention: the KV cache grows with the context
)
