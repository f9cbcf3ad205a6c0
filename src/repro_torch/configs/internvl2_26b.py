"""internvl2-26b [vlm]: InternViT frontend stubbed (the caller provides
precomputed patch embeddings) + the InternLM2-20B language backbone.
[arXiv:2404.16821; hf] (counterpart of repro/configs/internvl2_26b.py)"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92553,
    rope_theta=1e6,
    frontend="vision",
    frontend_tokens=256,     # one tile of InternViT patches after pixel shuffle
    frontend_dim=3200,       # InternViT-6B width
    sub_quadratic=False,
)
