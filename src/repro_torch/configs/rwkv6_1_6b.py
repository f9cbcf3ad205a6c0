"""rwkv6-1.6b [rwkv]: Finch, data-dependent decay, attention-free.
[arXiv:2404.05892] (counterpart of repro/configs/rwkv6_1_6b.py)"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="rwkv",
    num_layers=24,
    d_model=2048,
    num_heads=32,            # d_model / rwkv_head_dim
    num_kv_heads=32,
    head_dim=64,
    d_ff=7168,
    vocab_size=65536,
    block_pattern=("rwkv",),
    rwkv_head_dim=64,
    norm_kind="layernorm",
    sub_quadratic=True,      # O(1) state a decode step
)
