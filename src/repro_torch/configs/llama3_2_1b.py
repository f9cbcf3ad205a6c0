"""llama-3.2-1b: the paper's own evaluation model (Llama-3.2-1B-Instruct).
[hf:meta-llama/Llama-3.2-1B-Instruct]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=128256,
    rope_theta=5e5,
    tie_embeddings=True,
    sub_quadratic=False,
)
