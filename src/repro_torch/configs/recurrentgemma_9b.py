"""recurrentgemma-9b [hybrid]: RG-LRU + local attention, 1 attn : 2 rec.
[arXiv:2402.19427] (counterpart of repro/configs/recurrentgemma_9b.py)"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,          # MQA on the local-attention layers
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    block_pattern=("rec", "rec", "attn"),
    sliding_window=2048,     # local attention window
    rnn_width=4096,
    conv_width=4,
    tie_embeddings=True,
    sub_quadratic=True,      # bounded state: the window and the recurrences
)
