"""Model configuration (counterpart of repro/configs/base.py).

The same `ModelConfig` fields and the same `reduced()` rule as the JAX
package, with `dtype` named as a string and mapped to a torch dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | rwkv | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    # MoE.
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    # Attention.
    qkv_bias: bool = False
    sliding_window: int = 0           # 0 = full attention
    rope_theta: float = 1e4
    # Hybrid/RWKV.
    block_pattern: tuple[str, ...] = ("attn",)  # e.g. ("rec","rec","attn")
    rnn_width: int = 0                # RG-LRU recurrent width (0 = d_model)
    conv_width: int = 4               # RG-LRU temporal conv
    rwkv_head_dim: int = 64
    # Enc-dec / multimodal frontends (stubs provide precomputed embeddings).
    encoder_layers: int = 0
    frontend: str = "none"            # none | audio | vision
    frontend_tokens: int = 0          # encoder frames / image patches
    frontend_dim: int = 0             # raw frontend embedding dim
    max_pos_embed: int = 32768        # learned-pos table size (enc-dec only)
    # Numerics.
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    norm_kind: str = "rmsnorm"        # rmsnorm | layernorm
    mlp_kind: str = "swiglu"          # swiglu | gelu
    # Long-context capability (True for SSM/hybrid/SWA archs; gates long_500k).
    sub_quadratic: bool = False
    # Chunk sizes for memory-efficient attention / recurrent scan.
    q_chunk: int = 1024
    kv_chunk: int = 1024
    # --- beyond-paper perf levers (EXPERIMENTS.md §Perf) ---
    # Expand KV heads to the query-head count inside attention so score/value
    # contractions shard over the full TP axis (GQA kv_heads < TP degree
    # otherwise forces partial replication).
    tp_attn_expand_kv: bool = False
    # With expand_kv: zero-pad the flat head axis up to a multiple of this so
    # it divides the TP axis (e.g. qwen's 40 heads -> 48); padded-head outputs
    # are sliced off before W_o.  0 = off.
    pad_attn_heads_to: int = 0
    # MoE dispatch in G independent token groups (set to the DP degree):
    # ranking/scatter become group-local, so SPMD never reshards the (T, k, D)
    # dispatch tensors across the mesh.  Capacity is enforced per group.
    # 0 = global dispatch (paper-faithful single queue).
    moe_dispatch_groups: int = 0
    # Dispatch+combine under shard_map over the DP axes: scatter/gather are
    # guaranteed shard-local (GSPMD cannot misplace them), expert FFNs stay in
    # auto-SPMD so TP weight sharding is preserved.  Falls back to the plain
    # path when no mesh is ambient (CPU tests) or tokens don't divide.
    moe_shard_map: bool = False
    # Decode-phase MoE without dispatch: run every expert on the (few) live
    # tokens and combine with gate weights.  At decode T is tiny, so the extra
    # FLOPs are negligible while all dispatch collectives disappear.
    moe_dense_decode: bool = False
    # Split causal attention into static bands; band b only scans KV chunks
    # up to its own end, skipping the always-masked upper triangle.
    # 1 = off (full rectangle); 4 cuts causal-attn FLOPs to ~0.625x.
    causal_bands: int = 1

    @property
    def activation_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    @property
    def gqa_groups(self) -> int:
        return max(1, self.num_heads // max(self.num_kv_heads, 1))

    def param_count(self) -> int:
        """Analytic parameter count (unpadded) for 6ND roofline accounting."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        h, kv, hd = self.num_heads, self.num_kv_heads, self.head_dim
        per_layer = 0
        n_attn, n_rec, n_rwkv = 0, 0, 0
        pat = self.block_pattern
        for i in range(self.num_layers):
            t = pat[i % len(pat)]
            if t == "attn":
                n_attn += 1
            elif t == "rec":
                n_rec += 1
            elif t == "rwkv":
                n_rwkv += 1
        attn_p = d * hd * (h + 2 * kv) + h * hd * d
        if self.num_experts:
            ffn_p = self.num_experts * 3 * d * f + d * self.num_experts
        elif self.mlp_kind == "swiglu":
            ffn_p = 3 * d * f
        else:
            ffn_p = 2 * d * f
        rnn_w = self.rnn_width or d
        rec_p = 2 * d * rnn_w + rnn_w * d + self.conv_width * rnn_w + 2 * rnn_w
        rwkv_p = 6 * d * d + 2 * d * f  # r,k,v,g,o,w-lora + channel-mix
        per_layer = n_attn * (attn_p + ffn_p) + n_rec * (rec_p + ffn_p) + n_rwkv * rwkv_p
        emb = v * d * (1 if self.tie_embeddings else 2)
        enc = self.encoder_layers * (attn_p + ffn_p)
        return per_layer + emb + enc

    def active_param_count(self) -> int:
        """MoE: params touched per token (for 6*N_active*D roofline)."""
        if not self.num_experts:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        total = self.param_count()
        moe_all = self.num_layers * self.num_experts * 3 * d * f
        moe_active = self.num_layers * self.experts_per_token * 3 * d * f
        return total - moe_all + moe_active


def reduced(cfg: ModelConfig, **overrides: Any) -> ModelConfig:
    """CPU smoke-test variant: same family/topology, tiny dims."""
    pat_len = len(cfg.block_pattern)
    small = dict(
        # Keep the layer-count remainder so the partial tail group (e.g.
        # recurrentgemma's 38 = 12*3 + 2) is exercised by smoke tests too.
        num_layers=max(2, 2 * pat_len) + cfg.num_layers % pat_len,
        d_model=64,
        num_heads=4,
        num_kv_heads=max(1, 4 // max(1, cfg.gqa_groups)),
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        num_experts=min(cfg.num_experts, 4),
        experts_per_token=min(cfg.experts_per_token, 2),
        sliding_window=min(cfg.sliding_window, 16) if cfg.sliding_window else 0,
        rnn_width=64 if cfg.rnn_width else 0,
        rwkv_head_dim=16,
        encoder_layers=2 if cfg.encoder_layers else 0,
        frontend_tokens=8 if cfg.frontend_tokens else 0,
        frontend_dim=32 if cfg.frontend_dim else 0,
        dtype="float32",
        q_chunk=8,
        kv_chunk=8,
        name=cfg.name + "-reduced",
    )
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
