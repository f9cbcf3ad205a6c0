#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is non-zero:

  1. build   every csrc/*.cu kernel with nvcc for sm_90a (one process per
             source, all started together) and print the card's name and
             power limit;
  2. kernels each of the fourteen kernels against its plain PyTorch version
             at the full-width Llama-3.2-1B shapes the serving runs give it
             (the packed mmt4d GEMM at verify/mixed/many-slot decode rows
             and prefill slabs, the packed GEMV at 1-8 rows, paged decode
             at windows of 1, 4, 5, 16 and 256), in bf16 and f32, with its
             time, the plain version's time, a library yardstick timed only
             (torch.matmul on the unpacked weight, SDPA with the causal mask,
             and beside it at q_offset 0 SDPA's own is_causal prefill over
             the grouped heads), and the roofline
             bound computed from the shapes; the packed GEMMs' plain-row
             entries (mmt4d_rows, mmt4d_gemv_rows; mmt4d_q8_rows and
             mmt4d_q4_rows below), which the packed routes call, at their
             packed twins' shapes, each equal to the packed route (pack ->
             packed kernel -> unpack, each a kernel) bit for bit and timed
             beside it; then the four quantized-weight
             kernels (w8a8: fused_gemv_q8, mmt4d_q8; w4a8 at group 16 and
             32: fused_gemv_q4, mmt4d_q4; each equal to its plain version
             bit for bit, the GEMVs under each plan their rule picks,
             forced, too) at GEMV rows 1, 4,
             8 and GEMM rows 16, 20, 256 (M0 = 8) and 2048 (M0 = 128), the
             yardstick torch._int_mm plus the scale epilogue for int8 (rows
             padded to 32 where it needs more than 16) and none for int4
             (bf16 torch.matmul on the dequantized weight is timed as an
             aside); then the decode kernels on every KV layout: paged
             decode on kv8 and kv4 pools (L = 1, 4, 5, 16, 256), dense decode on
             bf16, f32, kv8 and kv4 caches (S_c = 1024, L = 1 and 16) and on
             a wrapped 256-slot ring, SDPA on the dequantized view as the
             yardstick, and the paged kernel through an identity table
             against the dense kernel and against itself called again, bit
             for bit; then pack and unpack at
             the weight packs of load and at activation and output shapes
             (which no serving path packs or unpacks any more: the
             plain-row entries do it in their loads and stores), bit for
             bit, permute().contiguous() as the yardstick; batch_mmt4d (no serving path calls it) at an
             attention scores and a context shape and at 64 x 64 output
             tiles (M0 = N0 = 64) in f32 and bf16, einsum as
             the yardstick; and the sampler: its (4, 128256) bits, uniforms
             and sampled rows on the card equal to the CPU's for three keys,
             a chi-square test of its frequencies, its launches and
             device busy time; then the dense family's shapes: paged decode
             (bf16, kv8, kv4 pools), dense decode and flash prefill at head
             dim 128 with G = 5, 6 and 8 (Qwen2.5 40/8, Qwen2-1.5B 12/2,
             Yi-9B 32/4 heads; L = 1, 3, 5, 16, 256) and the identity-table
             paged == dense check there, and the projection kernels at
             Qwen2-1.5B's K x N and the untied heads' (4096 x 64000, 5120 x
             152064) in bf16, w8a8 and w4a8 g16 at rows 1, 4, 8, 20, 2048;
             then Mixtral-8x22B's shapes:
             its projections (6144 x 6144, 6144 x 1024, 6144 x 16384,
             16384 x 6144) in bf16 and w8a8 at rows 1, 4 and the 1406-row
             expert buffer of a 4500-token prefill, the router (6144 x 8)
             in f32 and int8 at rows 1, 4 and 4500, windowed flash prefill
             at Sq = Sk = 4608, window 4096, G = 6, and the ring dense
             decode at S_c = 4096 with rows wrapped; then the recurrent
             families' shapes: RecurrentGemma-9B's local attention at head
             dim 256 (G = 16, window 2048: windowed flash prefill at Sq =
             Sk = 2560, the ring dense decode at S_c = 2048 with rows before
             and past the wrap) and the projections at RecurrentGemma's and
             RWKV6-1.6B's K x N (and RWKV's untied head) at rows 1, 4 and
             2048; then Whisper-tiny's and InternVL2-26B's shapes: flash
             prefill with causal=False at the encoder's Sq = Sk = 1500
             (G = 1, a partial last key tile) and as cross attention (Sq =
             64, 448 over Sk = 1500), the dense decode over a 1500-row cross
             cache at pos 1499 and InternVL's (D = 128, G = 6, S_c = 1024),
             and the projections at both models' K x N (K = 384, 1536, 3200,
             6144, 16384; the untied heads N = 51865, 92553) at rows 1, 4
             and their prefill rows; then the tensor-parallel shard shapes
             (TP_SHAPES; phase 15).  Every bf16 attention row, at every
             shape, is held element by element to bf16_attn_limit (kv8/kv4
             rows against the dequantized K/V), every f32 one to 1e-4;
  3. forward a depth-2, full-width f32 model served through the kernels and
             through the plain backends on the card: identical tokens, for
             the phase-split engine and for speculative decode (registry
             routing and backend "pallas"), the token budget (with and
             without spec decode) and 12 slots, each against the plain
             phase-split engine; then the same model with int8 and with
             int4 weights, phase-split and spec decode, through the
             quantized kernels and through their plain ("xla") versions;
             then kv8 pools (phase-split, spec, budget) against the same
             engines on the plain attention, the dense cache (vectorized,
             grouped, spec, budget) against the plain phase-split engine,
             and kv4 pools on the card against the same engine on the CPU;
             then temperature sampling (0.7 on half the requests, 0 on the
             others; paged vectorized and dense grouped): kernel tokens ==
             plain tokens, and temperature-0 requests == the greedy engine;
             then each of Qwen2-1.5B, Qwen2.5-14B/32B and Yi-9B at depth 2,
             full width, f32, nonzero QKV biases: the kernels (phase-split
             and spec decode) emit the plain backends' tokens; then
             Mixtral-8x22B at depth 2, full width, f32, on its 4096-slot
             ring (max_seq 8192), 9 requests, one of 4500 tokens: the
             kernels phase-split, on `pallas`, grouped and with 12 slots
             against the plain backends in the same configuration (MoE
             capacity drops depend on the batch), and int8 and int4
             weights against the plain quantized projections; then
             RWKV6-1.6B at depth 2 and RecurrentGemma-9B at depth 3 (one
             rec, rec, attn group), full width, f32, 4 slots, phase 12's 9
             requests (a 2500-token prompt past the 2048 window; every slot
             reused), and Grok-1-314B at depth 1 on the paged cache and
             with spec decode: kernel tokens == plain tokens in each; then
             Whisper-tiny at full width and depth and InternVL2-26B at
             depth 2 of 48, f32, through models/transformer.greedy_generate
             (4 requests, frames or patches from --seed, 8 new): kernel
             tokens == plain tokens;
  4. serve   the full-depth, full-width bf16 Llama-3.2-1B (random weights from
             --seed): 8 requests, half sharing a 256-token prefix so the second
             wave runs the suffix prefill;
  5. windows the same model through the paths of more than 8 rows and the
             packed kernels: speculative decode (4 slots, tiled prompts), a
             token budget of 256 admitting a 900-token prompt beside 3
             decoding requests (zero decode stalls), 16 slots over 32
             requests, and backend "pallas" (packed GEMV decode, packed GEMM
             prefill);
  6. quant   the same model with w8a8 and with w4a8 weights (quantized on the
             card): phase 4's 8 requests and phase 5's speculative decode,
             with tokens/s, step p50/p99 by kind, peak memory and the weight
             bytes a decode step streams;
  7. kv      the same bf16 model on kv8 and kv4 pools (phase 4's trace, and
             kv8 speculative decode on phase 5's tiled prompts) and on the
             dense cache (phase 4's trace, vectorized and grouped decode),
             with tokens/s, step p50/p99 by kind, prefix write-skip hits,
             pool bytes per cached token and peak memory;
  8. sampled the same bf16 model on phase 4's trace, greedy and with
             sample="temperature" (0.8 on half the requests, 0 on the
             others) in turns: tokens/s, decode p50/p99 and p50 as a
             multiple of the greedy run's; the temperature-0 requests must
             emit the greedy run's tokens;
  9. dense   Qwen2-1.5B at full width and depth (28 layers, bf16, nonzero
             QKV biases): phase 4's trace, phase 5's speculative decode and
             phase 4's trace with w8a8 weights;
 10. chaos   the committed fault schedules on the card: Qwen2-1.5B at depth
             2, full width, f32, random_7.json on a bf16 pool and
             kv_quant_mix.json on a kv8 pool; every request ends in a
             terminal status, survivors emit the fault-free card run's
             tokens, no page leaks, every injected kernel fault is in
             stats["degraded"] and only those are caught;
 11. moe     Mixtral-8x22B at full width and depth 8 of 56 (the cut: one
             card holds 80 GB, 56 layers are 282 GB in bf16), 4 slots,
             max_seq 8192: 8 requests of 100-500 tokens and one of 4500,
             32 new each, in bf16 and in w8a8, with tokens/s, step p50/p99
             by kind, peak memory and the weight bytes a decode step
             streams (the router and all 8 experts of every layer);
 12. recurrent RWKV6-1.6B (24 layers) and RecurrentGemma-9B (38 layers) at
             full width and depth in bf16, 4 slots, max_seq 4096 (dense
             cache, grouped decode): 8 requests of 100-500 tokens and one
             of 2500, 32 new each; Grok-1-314B at depth 4 of 64 in bf16,
             paged, phase 4's trace and spec decode on phase 5's prompts;
             with tokens/s, step p50/p99 by kind, the weight bytes a
             decode step streams, the cache bytes a slot holds and the
             launches by layer type;
 13. encdec-vlm Whisper-tiny (4 encoder + 4 decoder layers, 1500 frames)
             and InternVL2-26B (48 layers, 256 patches, ~40 GB) at full
             width and depth in bf16 through greedy_generate (the engine
             takes tokens only, as the JAX engine does): 4 requests, 4-64
             / 100-500 text tokens, 32 new; tokens/s, prefill ms (and the
             Whisper encoder's own), decode-step p50/p99, peak memory, the
             weight bytes a decode step streams, the cache bytes a slot;
             launches == forward_tally by layer type (an encoder layer 6
             projections and a non-causal flash, a decoder layer 10 at
             prefill and 8 at decode, a causal and a non-causal flash at
             prefill, two dense decodes a step: self and cross);
 14. train   (a) Llama at full width, depth 2, f32, TF32 off, batch 2 x 128:
             one train step on the card against the same step on the CPU
             from the same params (made on the CPU) and batch (loss 1e-5
             relative, grad norm 1e-4, every param 1e-6 abs outside the
             elements where Adam's first step follows gradient noise:
             |g| < 1e-6 max|g|, or the clipped |g| under 10 eps); the
             trained weights served through the kernels ("auto") and the
             plain path ("xla"): identical tokens, the kernels launched;
             the state through AsyncCheckpointer under build/ and back, bit
             for bit, and the next step's loss equal to the uninterrupted
             run's; (b) Llama-3.2-1B at full width and depth, bf16 params,
             f32 moments, SyntheticPacked(seed=0), batch 8 x 1024, 20 steps
             at lr 1e-3: every loss and grad norm finite, the last 5
             losses' mean below the first 5's; step p50, tokens/s, peak
             memory, 6N tokens/s as a share of the bf16 peak, one step
             under the profiler; (c) no hand-written kernel launched inside
             (b)'s steps: training runs the plain projections, as in JAX.
 15. tp      tensor-parallel serving, the ranks spawned by
             launch/mesh.launch_ranks after the kernels are built and
             sharing this one card (gloo between them, card tensors staged
             through the host: NCCL refuses two ranks on one device; the
             times are a rehearsal, not tensor-parallel speed): (a)
             Llama-3.2-1B at full width, depth 2 of 16, f32, phase 4's
             trace (spec: phase 5's tiled prompts) at tp = 1, 2 and 4 in 8
             configurations (auto, pallas, spec, budget 64, kv8, kv4, w8a8,
             w4a8): every rank's tokens equal tp = 1's in the first five,
             and in kv4, w8a8 and w4a8, fed tp = 1's tokens (teacher
             forced), every logit within TP_LOGIT_LIMIT of tp = 1's and the
             argmax tp = 1's wherever its top-2 gap exceeds TP_GAP, a gate
             that w8a8 and w4a8 with the absmax all-reduce skipped must
             fail; its launches equal the dispatch tally at its shard's
             shapes, its collectives 2 a layer plus the embedding's and the
             head's a dispatch (and 2 a layer of absmax reduces with
             int8/int4 weights), each staged; wo and w_down row-parallel at
             Llama's widths, and 8 experts' w_down at Mixtral's (K =
             16384, N = 6144) in one stacked reduction, against one card's
             product, w8a8 bit for bit; (d) Mixtral-8x22B and Grok-1-314B
             at full width, depth 2, f32, phase 11's trace (8 new) at tp =
             1, 2 and 4, every expert's FFN columns split and the router
             whole: "auto" served twice at tp = 1 with the same tokens
             both times, and its tokens equal tp = 1's on every rank, w8a8 fed
             tp = 1's tokens within the same gate, which w8a8 with the
             experts' stacked absmax all-reduce skipped must fail; launches
             equal the tally at the shard's widths (5 projections at the
             dispatch's rows and 3 an expert at its capacity rows),
             collectives 2 a layer (wo and the experts' stacked w_down)
             plus 2 a dispatch; (b) Llama-3.2-1B at tp = 2, (c) Yi-9B at
             tp = 4 and (e) Mixtral-8x22B at depth 8 at tp = 2, full width,
             bf16 (Llama and Yi at full depth, phase 4's trace; Mixtral
             phase 11's run), every request ok: tokens/s, decode p50,
             launches and collectives a step, peak memory a rank and the
             share of tokens equal to the tp = 1 run of the same call
             (Mixtral's: phase 11's); then a world of one on NCCL runs a
             decode step and each collective on its logits.  Phase 2
             checks the kernels at the shard shapes too (TP_SHAPES: the
             Llama and Yi shards' projections and heads, the MoE experts'
             projections at tp = 2 and 4).

In phases 4 to 9, 11, 12 and 15 every kernel's launch count (per KV layout
for the decode kernels), set to 0 before each run and read after it, must
equal the dispatches that resolved to it (tallied here from each dispatch's
rows, weight format, cache and KV layout, and the registry) x layers x (7
projections, or for an MoE layer 5 at the dispatch's rows and 3 a expert at
its capacity buffer's rows, or 1 attention; 8 projections and no attention
for an RG-LRU or RWKV layer), plus an untied head's one projection a
dispatch; at tp > 1 the same tally holds on every rank, each projection at
the shard's widths (an MoE expert's w_gate/w_up 16384 / tp or 32768 / tp
rows, its w_down as many columns); pack and unpack must not launch at all
(the packed projections run their GEMMs' plain-row entries), and every other
kernel of the table but batch_mmt4d must have launched in these runs. Every
model made on the card must launch one weight pack per projection weight
(two for int4: codes and scales); the table's pack launches are those of the
models of phases 4-9 and 11-13.

The third line from the end is the kernel table as JSON, the next the card's
name and power limit, and the last {"ok": true, "device": {...}}.  Details go
to chiprun_out/chip_smoke.json.
The script needs torch with CUDA and the repository's src/ beside it.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")

# file:line of the Pallas kernel each CUDA kernel replaces; the decode
# kernels have a row per KV layout the serving paths run (the dense cache is
# bf16 there, as in the JAX engine).
REPLACES = {
    "fused_gemv": "src/repro/kernels/fused_gemv.py:56",
    "fused_pack_mmt4d": "src/repro/kernels/fused_pack_mmt4d.py:59",
    "flash_prefill_attention": "src/repro/kernels/attn.py:465",
    "paged_decode_attention": "src/repro/kernels/attn.py:163",
    "mmt4d": "src/repro/kernels/mmt4d.py:61",
    "mmt4d_gemv": "src/repro/kernels/mmt4d_gemv.py:42",
    "fused_gemv_q8": "src/repro/kernels/fused_gemv.py:112",
    "mmt4d_q8": "src/repro/kernels/mmt4d_q8.py:62",
    "fused_gemv_q4": "src/repro/kernels/mmt4d_q4.py:71",
    "mmt4d_q4": "src/repro/kernels/mmt4d_q4.py:146",
    "paged_decode_attention_kv8": "src/repro/kernels/attn.py:163",
    "paged_decode_attention_kv4": "src/repro/kernels/attn.py:163",
    "dense_decode_attention": "src/repro/kernels/attn.py:321",
    "pack": "src/repro/kernels/pack.py:36",
    "unpack": "src/repro/kernels/pack.py:66",
    "batch_mmt4d": "src/repro/kernels/batch_mmt4d.py:58",
}
SOURCES = {
    "fused_gemv": "src/repro_torch/csrc/fused_gemv.cu",
    "fused_pack_mmt4d": "src/repro_torch/csrc/fused_pack_mmt4d.cu",
    "flash_prefill_attention": "src/repro_torch/csrc/flash_prefill.cu",
    "paged_decode_attention": "src/repro_torch/csrc/paged_decode.cu",
    "mmt4d": "src/repro_torch/csrc/mmt4d.cu",
    "mmt4d_gemv": "src/repro_torch/csrc/mmt4d_gemv.cu",
    "fused_gemv_q8": "src/repro_torch/csrc/fused_gemv_q8.cu",
    "mmt4d_q8": "src/repro_torch/csrc/mmt4d_q8.cu",
    "fused_gemv_q4": "src/repro_torch/csrc/mmt4d_q4.cu",
    "mmt4d_q4": "src/repro_torch/csrc/mmt4d_q4.cu",
    "paged_decode_attention_kv8": "src/repro_torch/csrc/paged_decode.cu",
    "paged_decode_attention_kv4": "src/repro_torch/csrc/paged_decode.cu",
    "dense_decode_attention": "src/repro_torch/csrc/dense_decode.cu",
    "pack": "src/repro_torch/csrc/pack.cu",
    "unpack": "src/repro_torch/csrc/pack.cu",
    "batch_mmt4d": "src/repro_torch/csrc/batch_mmt4d.cu",
}
# Table name -> (decode kernel, KV layout) of the per-layout launch counts.
LAYOUT_ROWS = {
    "paged_decode_attention": ("paged", "bf16"),
    "paged_decode_attention_kv8": ("paged", "kv8"),
    "paged_decode_attention_kv4": ("paged", "kv4"),
    "dense_decode_attention": ("dense", "bf16"),
}
LAYOUT_NAMES = {v: k for k, v in LAYOUT_ROWS.items()}
# The shape whose numbers stand for each kernel in the JSON line: the one the
# serving runs (phases 4 and 5) give it most often, in bf16 (the packed
# GEMMs: their plain-row entries, which the serving runs call; pack: the
# weight pack at load; unpack, which no serving path runs: its output
# unpack of 4 decode rows).
HEADLINE = {
    "fused_gemv": "bf16 M=4 K=2048 N=8192",
    "fused_pack_mmt4d": "bf16 M=2048 K=2048 N=8192",
    "flash_prefill_attention": "bf16 B=4 Sq=512 Sk=512 q_offset=0",
    "paged_decode_attention": "bf16 B=4 L=1",
    "mmt4d": "bf16 rows M=20 K=2048 N=8192",
    "mmt4d_gemv": "bf16 rows M=4 K=2048 N=8192",
    "fused_gemv_q8": "w8a8 M=4 K=2048 N=8192",
    "mmt4d_q8": "w8a8 rows M=20 K=2048 N=8192",
    "fused_gemv_q4": "w4a8 g16 M=4 K=2048 N=8192",
    "mmt4d_q4": "w4a8 g16 rows M=20 K=2048 N=8192",
    "paged_decode_attention_kv8": "kv8 bf16 B=4 L=1",
    "paged_decode_attention_kv4": "kv4 bf16 B=4 L=1",
    "dense_decode_attention": "bf16 B=4 S_c=1024 L=1",
    "pack": "bf16 (8192, 2048) tile (128, 128)",
    "unpack": "f32 (1, 64, 4, 128) -> (4, 8192)",
    "batch_mmt4d": "f32 scores (128, 8, 1, 16, 64) x (128, 8, 1, 16, 64)",
}
# Kernels no serving run launches.  batch_mmt4d: as in the JAX package it
# completes the microkernel library (IREE's short-sequence attention
# products); the model's attention runs the flash and decode kernels.
# unpack: the packed projections store plain rows from their GEMMs'
# epilogues.  (pack runs at load, each model's weight packs, counted by
# init_model.)  Phase 2 checks all three against their plain versions.
NOT_ON_SERVING_PATHS = ("batch_mmt4d", "unpack")
# Weight-pack launches of each model init_model made, in order.
WEIGHT_PACKS: list[int] = []
# The projection kernel each matmul backend resolves to, per weight format
# (registry quant name): (at decode with at most GEMV_MAX_ROWS rows, else).
MATMUL_KERNELS = {
    "none": {"fused": ("fused_gemv", "fused_pack_mmt4d"), "pallas": ("mmt4d_gemv", "mmt4d")},
    "w8a8": {"fused": ("fused_gemv_q8", "mmt4d_q8"), "pallas": ("mmt4d_q8", "mmt4d_q8")},
    "w4a8": {"fused": ("fused_gemv_q4", "mmt4d_q4"), "pallas": ("mmt4d_q4", "mmt4d_q4")},
}


def log(msg: str) -> None:
    print(msg, flush=True)


class Timer:
    """Device time of one call by CUDA events, the median of `iters` launches.
    With `flush`, a 256 MB buffer is written before every launch (outside
    the timed window) so the call finds the 50 MB L2 cold, as the serving
    step does: each layer's weights are read once per step."""

    def __init__(self, torch, dev):
        self.torch = torch
        self.flush_buf = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)

    def ms(self, fn, *, iters: int = 10, warmup: int = 2, flush: bool = True) -> float:
        """Median device ms of one call over `iters` launches."""
        torch = self.torch
        for _ in range(warmup):
            fn()
        starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
        ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
        for i in range(iters):
            if flush:
                self.flush_buf.zero_()
            starts[i].record()
            fn()
            ends[i].record()
        torch.cuda.synchronize()
        times = sorted(s.elapsed_time(e) for s, e in zip(starts, ends))
        mid = iters // 2
        return times[mid] if iters % 2 else 0.5 * (times[mid - 1] + times[mid])


def bound(target, *, bytes_moved: float, flops: float, dtype_name: str) -> tuple[float, str]:
    """Least time (ms) the card could take: max(bytes / memory rate, operations
    / peak rate for the inputs' type: bf16 or int8 tensor cores, or f32 CUDA
    cores)."""
    peak = {"bf16": target.peak_flops_bf16, "int8": target.peak_ops_int8}.get(
        dtype_name, target.peak_flops_f32)
    t_bytes = bytes_moved / target.hbm_bytes_per_s
    t_ops = flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def add_row(results: dict, target, name: str, key: str, *, err, tol, ms, plain_ms, library_ms,
            bytes_moved, flops, dname, **extra) -> None:
    """Record one kernel shape's numbers (bound computed here) and fail if
    the kernel's error against its plain version exceeds `tol`."""
    b_ms, b_by = bound(target, bytes_moved=bytes_moved, flops=flops, dtype_name=dname)
    row = dict(max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=b_ms, bound_by=b_by, **extra)
    results.setdefault(name, {})[key] = row
    lib = "-" if library_ms is None else f"{library_ms:.4f}"
    aside = "".join(f" {k}={v:.4f}" for k, v in extra.items() if isinstance(v, float))
    log(f"[kernel] {name:24s} {key:38s} err={err:.3e} (tol {tol:.1e}) ms={ms:.4f} "
        f"plain={plain_ms:.4f} library={lib}{aside} bound={b_ms:.4f} ({b_by})")
    if not err <= tol:
        raise AssertionError(f"{name} {key}: max abs error {err} exceeds {tol}")


def bf16_attn_limit(torch, q, k, v, valid, want):
    """Per-element limit of a bf16 attention kernel's output against its
    plain (f32) version.  The kernel rounds each softmax weight to bf16 for
    the tensor cores' P.V product (relative error within bf16's unit
    roundoff 2^-8, sd at most 2^-8/sqrt(3)), so an output element moves by
    a sum whose sd is at most 2^-8/sqrt(3) x sqrt(sum_j p_j^2 v_j^2); both
    outputs are then rounded to bf16.  The limit is 6 such sd, plus 2 bf16
    ulps of the plain value, plus 1e-5 for f32 summation order.  Where a
    row attends to ~4096 keys that is ~6e-4 at outputs of ~0.03, so a
    dropped 64-key tile or a band edge moved by one key, each of which
    shifts outputs by 1e-3 or more, fails it.  q (B, Sq, H, D); k, v (B,
    Sk, KV, D); valid (B, Sq, Sk)."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    sd = torch.empty(b, sq, h, d, dtype=torch.float32, device=q.device)
    for j in range(kvh):
        qg = q[:, :, j * g:(j + 1) * g].float() * d**-0.5
        sc = torch.einsum("bqgd,bsd->bgqs", qg, k[:, :, j].float())
        p = torch.nan_to_num(torch.softmax(sc.masked_fill(~valid[:, None], float("-inf")), -1))
        del sc
        sd[:, :, j * g:(j + 1) * g] = torch.einsum("bgqs,bsd->bqgd", p * p,
                                                   v[:, :, j].float() ** 2).sqrt()
        del p
    sd *= 2.0**-8 / 3**0.5
    mant, ex = torch.frexp(want.float().abs())
    ulp = torch.where(want != 0, torch.ldexp(torch.ones_like(mant), ex - 8),
                      torch.zeros_like(mant))
    return 6.0 * sd + 2.0 * ulp + 1e-5


def attn_row(torch, timer, results: dict, target, name: str, key: str, fn, plain, *,
             q, k, v, valid, library_ms, bytes_moved, flops, dname, plain_iters=10,
             **aside) -> None:
    """Record one attention kernel shape: f32 held to 1e-4 abs, bf16 element
    by element to bf16_attn_limit over the keys the rows read (k, v: the
    (B, Sk, KV, D) view the plain version attends, dequantized for kv8/kv4;
    valid (B, Sq, Sk)).  A bf16 row keeps the worst error / limit, the error
    and the limit at that element, and as `tol` the loosest limit.  `aside`
    (other library times) joins the row."""
    got, want = fn(), plain()
    diff = (got.float() - want.float()).abs()
    err, tol, extra = diff.max().item(), 1e-4, {}
    if dname == "bf16":
        lim = bf16_attn_limit(torch, q, k, v, valid, want)
        ratio = diff / lim
        worst = int(ratio.argmax().item())
        extra = dict(err_over_limit=ratio.max().item(),
                     err_at_worst=diff.flatten()[worst].item(),
                     limit_at_worst=lim.flatten()[worst].item(),
                     tol_rule="per element: 6 sd of bf16 P rounding + 2 ulp + 1e-5")
        tol = lim.max().item()  # the loosest element's limit
        del lim, ratio
        log(f"[kernel] {name} {key}: worst error / limit {extra['err_over_limit']:.3f} "
            f"(error {extra['err_at_worst']:.3e}, limit {extra['limit_at_worst']:.3e})")
        if not extra["err_over_limit"] <= 1.0:
            raise AssertionError(f"{name} {key}: error {extra['err_at_worst']} exceeds its "
                                 f"per-element limit {extra['limit_at_worst']}")
    del diff
    add_row(results, target, name, key, err=err, tol=tol, ms=timer.ms(fn),
            plain_ms=timer.ms(plain, iters=plain_iters), library_ms=library_ms,
            bytes_moved=bytes_moved, flops=flops, dname=dname, **extra, **aside)


def decode_valid(torch, pos, L: int, live: int):
    """(B, L, live) mask of the keys decode rows at pos[b] + l attend:
    slots <= pos[b] + l (full attention, masked-causal inside a window)."""
    qpos = pos[:, None].long() + torch.arange(L, device=pos.device)
    return torch.arange(live, device=pos.device) <= qpos[..., None]


def rows_entry(torch, timer, results: dict, target, name: str, key: str, fn, plain, route, *,
               tol: float, plain_iters: int, **kw) -> None:
    """Record a packed GEMM's plain-row entry: `fn()` must equal `route()`
    (the packed route, pack -> packed kernel -> unpack on the card) bit for
    bit, and `plain()` within `tol` (0: bit for bit); the route's event time
    is kept beside the entry's as `packed_route_ms`."""
    got, want = fn(), route()
    if not torch.equal(got, want):
        raise AssertionError(f"{name} {key}: the plain-row entry differs from the packed "
                             f"route (max abs {(got - want).abs().max().item()})")
    ref_out = plain()
    err = (got - ref_out).abs().max().item()
    if tol == 0.0 and not torch.equal(got, ref_out):
        raise AssertionError(f"{name} {key}: not equal to its plain version bit for bit "
                             f"(max abs error {err})")
    add_row(results, target, name, key, err=err, tol=tol, ms=timer.ms(fn),
            plain_ms=timer.ms(plain, iters=plain_iters), packed_route_ms=timer.ms(route),
            **kw)


def check_kernels(torch, dev, target, timer, results: dict) -> None:
    """Phase 2: every kernel against its plain version at the main path's
    full-width shapes, both dtypes."""
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.kernels import (attn, fused_gemv, fused_pack_mmt4d, mmt4d, mmt4d_gemv,
                                     pack, ref)

    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=dev)

    def record(name, key, **kw):
        add_row(results, target, name, key, **kw)

    def rows_check(name, key, fn, plain, route, *, tol, plain_iters, **kw):
        rows_entry(torch, timer, results, target, name, key, fn, plain, route, tol=tol,
                   plain_iters=plain_iters, **kw)

    dtypes = [("bf16", torch.bfloat16), ("f32", torch.float32)]
    kn = [(2048, 2048), (2048, 512), (2048, 8192), (8192, 2048)]
    for dname, dt in dtypes:
        s = 2 if dname == "bf16" else 4
        for k, n in kn:
            w_t = rnd(n, k, scale=k**-0.5).to(dt)
            rhs4 = ref.pack(w_t, (128, 128))
            for m in (1, 4, 8):
                x = rnd(m, k).to(dt)
                got = fused_gemv.fused_gemv(x, rhs4)
                want = fused_gemv.fused_gemv_plain(x, rhs4)
                record("fused_gemv", f"{dname} M={m} K={k} N={n}",
                       err=(got - want).abs().max().item(), tol=1e-3,
                       ms=timer.ms(lambda: fused_gemv.fused_gemv(x, rhs4)),
                       plain_ms=timer.ms(lambda: fused_gemv.fused_gemv_plain(x, rhs4)),
                       library_ms=timer.ms(lambda: torch.matmul(x, w_t.t())),
                       bytes_moved=(m * k + n * k) * s + m * n * 4, flops=2 * m * n * k,
                       dname=dname)
            for m in (16, 512, 2048):
                x = rnd(m, k).to(dt)
                got = fused_pack_mmt4d.fused_pack_mmt4d(x, rhs4)
                want = fused_pack_mmt4d.fused_pack_mmt4d_plain(x, rhs4)
                record("fused_pack_mmt4d", f"{dname} M={m} K={k} N={n}",
                       err=(got - want).abs().max().item(), tol=1e-3,
                       ms=timer.ms(lambda: fused_pack_mmt4d.fused_pack_mmt4d(x, rhs4)),
                       plain_ms=timer.ms(
                           lambda: fused_pack_mmt4d.fused_pack_mmt4d_plain(x, rhs4), iters=3),
                       library_ms=timer.ms(lambda: torch.matmul(x, w_t.t())),
                       bytes_moved=(m * k + n * k) * s + m * n * 4, flops=2 * m * n * k,
                       dname=dname)
            # The packed kernels take the rows packed as ops did (ref.pack):
            # one block of M0 = M rows for the GEMV; M0 = 8 row blocks for the
            # GEMM at verify (20 rows), 16-slot decode (16) and mixed (256)
            # windows, 128-row slabs at prefill.  Bytes and operations count
            # the packed operands as given, pad rows included.  Beside each,
            # the plain-row entry the ops path now calls on the same rows:
            # equal to the packed route (pack -> kernel -> unpack, each a
            # kernel, timed as `packed_route_ms`) bit for bit, bytes counting
            # the M live rows.
            for m in (1, 4, 8):
                x = rnd(m, k).to(dt)
                lhs4 = ref.pack(x, (m, 128))
                got = mmt4d_gemv.mmt4d_gemv(lhs4, rhs4)
                want = mmt4d_gemv.mmt4d_gemv_plain(lhs4, rhs4)
                lib_ms = timer.ms(lambda: torch.matmul(x, w_t.t()))
                record("mmt4d_gemv", f"{dname} M={m} K={k} N={n}",
                       err=(got - want).abs().max().item(), tol=1e-3,
                       ms=timer.ms(lambda: mmt4d_gemv.mmt4d_gemv(lhs4, rhs4)),
                       plain_ms=timer.ms(lambda: mmt4d_gemv.mmt4d_gemv_plain(lhs4, rhs4)),
                       library_ms=lib_ms,
                       bytes_moved=(m * k + n * k) * s + m * n * 4, flops=2 * m * n * k,
                       dname=dname)

                def route():
                    return pack.unpack(mmt4d_gemv.mmt4d_gemv(pack.pack(x, (m, 128)), rhs4), (m, n))
                rows_check("mmt4d_gemv", f"{dname} rows M={m} K={k} N={n}",
                           lambda: mmt4d_gemv.mmt4d_gemv_rows(x, rhs4),
                           lambda: mmt4d_gemv.mmt4d_gemv_rows_plain(x, rhs4), route,
                           tol=1e-3, plain_iters=10, library_ms=lib_ms,
                           bytes_moved=(m * k + n * k) * s + m * n * 4, flops=2 * m * n * k,
                           dname=dname)
            for m, m0 in ((16, 8), (20, 8), (256, 8), (2048, 128)):
                x = rnd(m, k).to(dt)
                lhs4 = ref.pack(x, (m0, 128))
                rows = lhs4.shape[0] * m0
                got = mmt4d.mmt4d(lhs4, rhs4)
                want = mmt4d.mmt4d_plain(lhs4, rhs4)
                lib_ms = timer.ms(lambda: torch.matmul(x, w_t.t()))
                record("mmt4d", f"{dname} M={m} K={k} N={n}",
                       err=(got - want).abs().max().item(), tol=1e-3,
                       ms=timer.ms(lambda: mmt4d.mmt4d(lhs4, rhs4)),
                       plain_ms=timer.ms(lambda: mmt4d.mmt4d_plain(lhs4, rhs4), iters=3),
                       library_ms=lib_ms,
                       bytes_moved=(rows * k + n * k) * s + rows * n * 4,
                       flops=2 * rows * n * k, dname=dname)

                def route():
                    return pack.unpack(mmt4d.mmt4d(pack.pack(x, (m0, 128)), rhs4), (m, n))
                rows_check("mmt4d", f"{dname} rows M={m} K={k} N={n}",
                           lambda: mmt4d.mmt4d_rows(x, rhs4, m0),
                           lambda: mmt4d.mmt4d_rows_plain(x, rhs4, m0), route,
                           tol=1e-3, plain_iters=3, library_ms=lib_ms,
                           bytes_moved=(m * k + n * k) * s + m * n * 4, flops=2 * m * n * k,
                           dname=dname)
            del w_t, rhs4

    b, h, kvh, d = 4, 32, 8, 64
    for dname, dt in dtypes:
        s = 2 if dname == "bf16" else 4
        for sq, sk, q_off in ((512, 512, 0), (256, 512, 256)):
            q, k, v = rnd(b, sq, h, d).to(dt), rnd(b, sk, kvh, d).to(dt), rnd(b, sk, kvh, d).to(dt)
            qpos = q_off + torch.arange(sq, device=dev)
            mask = torch.arange(sk, device=dev)[None, :] <= qpos[:, None]
            pairs = int(mask.sum().item())  # causal (query, key) pairs this run needs
            # SDPA yardstick on K/V expanded to the query heads (head = kv*G + j).
            qt = q.transpose(1, 2)
            kt, vt = (t.repeat_interleave(h // kvh, dim=2).transpose(1, 2) for t in (k, v))
            # Beside it at q_offset 0, SDPA's own causal prefill over the
            # grouped heads (the same function), where torch takes enable_gqa.
            extra = {}
            if q_off == 0:
                try:
                    qg, kg, vg = (t.transpose(1, 2) for t in (q, k, v))
                    extra["sdpa_causal_ms"] = timer.ms(lambda: F.scaled_dot_product_attention(
                        qg, kg, vg, is_causal=True, enable_gqa=True))
                except TypeError:
                    extra["sdpa_causal_ms"] = None
            attn_row(torch, timer, results, target, "flash_prefill_attention",
                     f"{dname} B={b} Sq={sq} Sk={sk} q_offset={q_off}",
                     lambda: attn.flash_prefill_attention(q, k, v, q_offset=q_off),
                     lambda: attn.flash_prefill_attention_plain(q, k, v, q_offset=q_off),
                     q=q, k=k, v=v, valid=mask[None].expand(b, -1, -1), plain_iters=3,
                     library_ms=timer.ms(lambda: F.scaled_dot_product_attention(
                         qt, kt, vt, attn_mask=mask)),
                     bytes_moved=(2 * b * sq * h * d + 2 * b * sk * kvh * d) * s,
                     flops=4 * b * h * d * pairs, dname=dname, **extra)

    bs, pages = 16, 257
    pos_list = [37, 300, 511, 900]
    rng = np.random.RandomState(0)
    for dname, dt in dtypes:
        s = 2 if dname == "bf16" else 4
        k_pool = rnd(pages, bs, kvh, d).to(dt)
        v_pool = rnd(pages, bs, kvh, d).to(dt)
        full_table = torch.from_numpy(
            np.stack([rng.permutation(np.arange(1, pages))[:80] for _ in range(b)]).astype(np.int32)
        ).to(dev)
        # L = 1: decode; 4 and 5: short verify windows (5 = draft_k 4, 20
        # query rows: the tensor cores in bf16); 16 and 256: verify and
        # mixed windows of one and of sixteen 64-row tiles (G = 4).
        for L in (1, 4, 5, 16, 256):
            nb = max(64, -(-(max(pos_list) + L) // bs))  # the table covers every window
            table = full_table[:, :nb].contiguous()
            pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
            q = rnd(b, L, h, d).to(dt)
            live = max(pos_list) + L
            k_view, v_view = (attn.paged_gather(p, table)[:, :live] for p in (k_pool, v_pool))
            valid = decode_valid(torch, pos, L, live)
            keys = sum(p + L for p in pos_list)  # distinct cached keys each row reads
            pairs = sum(p + j + 1 for p in pos_list for j in range(L))
            attn_row(torch, timer, results, target, "paged_decode_attention",
                     f"{dname} B={b} L={L}",
                     lambda: attn.paged_decode_attention(q, k_pool, v_pool, table, pos),
                     lambda: attn.paged_decode_attention_plain(q, k_pool, v_pool, table, pos),
                     q=q, k=k_view, v=v_view, valid=valid,
                     library_ms=timer.ms(sdpa_call(torch, q, k_view, v_view, valid[:, None],
                                                   h // kvh)),
                     bytes_moved=(2 * b * L * h * d + 2 * keys * kvh * d) * s + b * nb * 4
                     + b * 4, flops=4 * h * d * pairs, dname=dname)
    torch.cuda.synchronize()


def int_mm_time(torch, timer, xq, w_q, s_a, s_w) -> float:
    """torch._int_mm (int8 x int8 -> int32) plus the scale epilogue: the
    library call of the w8a8 function; it needs more than 16 rows, so fewer
    are padded to 32."""
    import torch.nn.functional as F

    m = xq.shape[0]
    xp = F.pad(xq, (0, 0, 0, 32 - m)) if m <= 16 else xq
    w_kn = w_q.t()  # (K, N), column-major
    return timer.ms(lambda: (torch._int_mm(xp, w_kn)[:m].float() * s_a[:, None]) * s_w)


def check_quant_kernels(torch, dev, target, timer, results: dict) -> None:
    """Phase 2, quantized weights: the four w8a8/w4a8 kernels against their
    plain versions at the full-width projection shapes, and the packed
    GEMMs' plain-row entries against their packed routes, bit for bit.  Weights are drawn
    in bf16 and quantized on the card as the model does (ops.pack_rhs_q8 /
    pack_rhs_q4); activation rows are bf16, quantized per row."""
    import torch.nn.functional as F

    from repro_torch.kernels import fused_gemv, mmt4d_q4, mmt4d_q8, ops, pack, ref

    gen = torch.Generator(device=dev).manual_seed(1)

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(torch.bfloat16)

    def check(name, key, fn, plain, *, tol_rel, library_ms, bytes_moved, flops, iters,
              exact=False, **extra):
        got, want = fn(), plain()
        err = (got - want).abs().max().item()
        if exact and not torch.equal(got, want):
            raise AssertionError(f"{name} {key}: not equal to its plain version bit for bit "
                                 f"(max abs error {err})")
        add_row(results, target, name, key, err=err, tol=tol_rel * want.abs().max().item(),
                ms=timer.ms(fn), plain_ms=timer.ms(plain, iters=iters), library_ms=library_ms,
                bytes_moved=bytes_moved, flops=flops, dname="int8", **extra)

    def int_mm_ms(xq, w_q, s_a, s_w):
        return int_mm_time(torch, timer, xq, w_q, s_a, s_w)

    groups = (16, 32)
    kn = [(2048, 2048), (2048, 512), (2048, 8192), (8192, 2048)]

    def gemv_plans_forced(xq, rhs4_q, sa1, s_w, q4):
        """Each plan the decode GEMVs' rules pick at these shapes and 1-8
        rows, forced on both GEMVs at one shape: bit for bit with the plain
        versions."""
        picked = {fused_gemv.gemv_q8_plan(m, k // 128, n // 128) for k, n in kn
                  for m in range(1, 9)}
        picked |= {mmt4d_q4.gemv_q4_plan(m, k // 128, n // 128, g) for k, n in kn
                   for m in range(1, 9) for g in groups}
        for plan in sorted(picked):
            want = fused_gemv.fused_gemv_q8_plain(xq, rhs4_q, sa1, s_w)
            if not torch.equal(fused_gemv.fused_gemv_q8(xq, rhs4_q, sa1, s_w, plan=plan), want):
                raise AssertionError(f"fused_gemv_q8 under {plan}: not its plain version")
            for g, (rhs4_p, s_w4) in q4.items():
                want = mmt4d_q4.fused_gemv_q4_plain(xq, rhs4_p, sa1, s_w4, g)
                got = mmt4d_q4.fused_gemv_q4(xq, rhs4_p, sa1, s_w4, g, plan=plan)
                if not torch.equal(got, want):
                    raise AssertionError(f"fused_gemv_q4 g{g} under {plan}: not its plain version")
            log(f"[phase2] fused_gemv_q8, fused_gemv_q4 g16/g32 M={xq.shape[0]} forced {plan}: "
                f"bit for bit")

    for k, n in kn:
        w_t = rnd(n, k, scale=k**-0.5)
        rhs4_q, s_w = ops.pack_rhs_q8(w_t)
        w_q = ref.unpack(rhs4_q, (n, k)).contiguous()
        s_w_flat = s_w.reshape(-1)[:n]
        q4 = {g: ops.pack_rhs_q4(w_t, group=g) for g in groups}
        # The aside for int4: bf16 matmul on the dequantized weight (N, K).
        w_deq = {g: ref.unpack(ref.dequant_rhs4_q4(*q4[g], g), (n, k)).to(torch.bfloat16)
                 for g in groups}
        del w_t
        for m in (1, 4, 8):
            x = rnd(m, k)
            xq, s_a = ref.quantize_rows(x)
            sa1 = s_a[:, None]
            check("fused_gemv_q8", f"w8a8 M={m} K={k} N={n}",
                  lambda: fused_gemv.fused_gemv_q8(xq, rhs4_q, sa1, s_w),
                  lambda: fused_gemv.fused_gemv_q8_plain(xq, rhs4_q, sa1, s_w),
                  tol_rel=0.0, library_ms=int_mm_ms(xq, w_q, s_a, s_w_flat),
                  bytes_moved=m * k + n * k + m * 4 + n * 4 + m * n * 4, flops=2 * m * n * k,
                  iters=10, exact=True, library_rows=32)
            for g in groups:
                rhs4_p, s_w4 = q4[g]
                check("fused_gemv_q4", f"w4a8 g{g} M={m} K={k} N={n}",
                      lambda: mmt4d_q4.fused_gemv_q4(xq, rhs4_p, sa1, s_w4, g),
                      lambda: mmt4d_q4.fused_gemv_q4_plain(xq, rhs4_p, sa1, s_w4, g),
                      tol_rel=0.0, library_ms=None, exact=True,
                      bytes_moved=m * k + n * k // 2 + n * (k // g) * 2 + m * 4 + m * n * 4,
                      flops=2 * m * n * k, iters=10,
                      bf16_dequant_matmul_ms=timer.ms(lambda: torch.matmul(x, w_deq[g].t())))
        if (k, n) == (2048, 2048):
            gemv_plans_forced(xq, rhs4_q, sa1, s_w, q4)
        for m, m0 in ((16, 8), (20, 8), (256, 8), (2048, 128)):
            x = rnd(m, k)
            xq, s_a = ref.quantize_rows(x)
            lhs4 = ref.pack(xq, (m0, 128))
            rows = lhs4.shape[0] * m0  # pad rows included, as the kernels read them
            sa2 = F.pad(s_a, (0, rows - m)).reshape(-1, m0)
            iters = 3 if m == 2048 else 10
            lib_ms = int_mm_ms(xq, w_q, s_a, s_w_flat)
            check("mmt4d_q8", f"w8a8 M={m} K={k} N={n}",
                  lambda: mmt4d_q8.mmt4d_q8(lhs4, rhs4_q, sa2, s_w),
                  lambda: mmt4d_q8.mmt4d_q8_plain(lhs4, rhs4_q, sa2, s_w),
                  tol_rel=0.0, library_ms=lib_ms,
                  bytes_moved=rows * k + n * k + rows * 4 + n * 4 + rows * n * 4,
                  flops=2 * rows * n * k, iters=iters, library_rows=32 if m <= 16 else m)
            # The plain-row entry on the same rows: the packed route bit for
            # bit, the plain version too; bytes count the M live rows.

            def route():
                return pack.unpack(mmt4d_q8.mmt4d_q8(pack.pack(xq, (m0, 128)), rhs4_q, sa2, s_w),
                                   (m, n))
            rows_entry(torch, timer, results, target, "mmt4d_q8", f"w8a8 rows M={m} K={k} N={n}",
                       lambda: mmt4d_q8.mmt4d_q8_rows(xq, rhs4_q, s_a, s_w, m0),
                       lambda: mmt4d_q8.mmt4d_q8_rows_plain(xq, rhs4_q, s_a, s_w, m0), route,
                       tol=0.0, plain_iters=iters, library_ms=lib_ms,
                       bytes_moved=m * k + n * k + m * 4 + n * 4 + m * n * 4,
                       flops=2 * m * n * k, dname="int8", library_rows=32 if m <= 16 else m)
            for g in groups:
                rhs4_p, s_w4 = q4[g]
                deq_ms = timer.ms(lambda: torch.matmul(x, w_deq[g].t()))
                check("mmt4d_q4", f"w4a8 g{g} M={m} K={k} N={n}",
                      lambda: mmt4d_q4.mmt4d_q4(lhs4, rhs4_p, sa2, s_w4, g),
                      lambda: mmt4d_q4.mmt4d_q4_plain(lhs4, rhs4_p, sa2, s_w4, g),
                      tol_rel=3e-5, library_ms=None, exact=True,
                      bytes_moved=rows * k + n * k // 2 + n * (k // g) * 2 + rows * 4
                      + rows * n * 4,
                      flops=2 * rows * n * k, iters=iters, bf16_dequant_matmul_ms=deq_ms)

                def route():
                    return pack.unpack(mmt4d_q4.mmt4d_q4(pack.pack(xq, (m0, 128)), rhs4_p, sa2,
                                                         s_w4, g), (m, n))
                rows_entry(torch, timer, results, target, "mmt4d_q4",
                           f"w4a8 g{g} rows M={m} K={k} N={n}",
                           lambda: mmt4d_q4.mmt4d_q4_rows(xq, rhs4_p, s_a, s_w4, g, m0),
                           lambda: mmt4d_q4.mmt4d_q4_rows_plain(xq, rhs4_p, s_a, s_w4, g, m0),
                           route, tol=0.0, plain_iters=iters, library_ms=None,
                           bytes_moved=m * k + n * k // 2 + n * (k // g) * 2 + m * 4 + m * n * 4,
                           flops=2 * m * n * k, dname="int8", bf16_dequant_matmul_ms=deq_ms)
        del rhs4_q, w_q, q4, w_deq
    torch.cuda.synchronize()


def kv_data(torch, gen, kv: str, dt, *shape):
    """(data, scales) of random K or V rows of `shape` (.., KV, D) in layout
    `kv` (scales None for bf16, which keeps dtype `dt`)."""
    from repro_torch.core import encoding

    x = torch.randn(shape, generator=gen, device=gen.device)
    return (x.to(dt), None) if kv == "bf16" else encoding.kv_layout(kv).quantize(x)


def kv_dequant(kv: str, x, sc):
    from repro_torch.core import encoding

    return x if kv == "bf16" else encoding.kv_layout(kv).dequantize(x, sc)


def kv_row_bytes(kv: str, d: int, itemsize: int) -> int:
    """Bytes one cached (token, kv head) row of K or V costs to read."""
    from repro_torch.core import encoding

    if kv == "bf16":
        return d * itemsize
    return encoding.kv_layout(kv).storage_head_dim(d) + encoding.KV_SCALE_ITEMSIZE


def sdpa_call(torch, q, k_view, v_view, mask, g: int):
    """SDPA on (B, S, KV, D) views expanded to the query heads (head = kv*G +
    j): the attention kernels' library yardstick."""
    import torch.nn.functional as F

    qt = q.transpose(1, 2)
    kt, vt = (t.to(q.dtype).repeat_interleave(g, dim=2).transpose(1, 2)
              for t in (k_view, v_view))
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)


def check_decode_kernels(torch, dev, target, timer, results: dict) -> dict:
    """Phase 2, the decode kernels on every KV layout at the full-width
    shapes (B = 4, H = 32, KV = 8, D = 64, pos {37, 300, 511, 900}): paged
    decode on kv8 and kv4 pools, dense decode on bf16, f32, kv8 and kv4
    caches and on a wrapped ring, each against its plain version, with SDPA
    on the dequantized view as the yardstick; then the paged kernel through
    an identity table against the dense kernel, bit for bit."""
    import numpy as np

    from repro_torch.kernels import attn

    gen = torch.Generator(device=dev).manual_seed(2)
    b, h, kvh, d, bs, pages = 4, 32, 8, 64, 16, 257
    g = h // kvh
    pos_list = [37, 300, 511, 900]
    pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
    dtypes = [("bf16", torch.bfloat16), ("f32", torch.float32)]

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def check(name, key, fn, plain, *, q, k_view, v_view, valid, dname, bytes_moved, flops):
        attn_row(torch, timer, results, target, name, key, fn, plain, q=q, k=k_view, v=v_view,
                 valid=valid, library_ms=timer.ms(sdpa_call(torch, q, k_view, v_view,
                                                            valid[:, None], g)),
                 bytes_moved=bytes_moved, flops=flops, dname=dname)

    rng = np.random.RandomState(1)
    full_table = torch.from_numpy(
        np.stack([rng.permutation(pages - 1)[:80] + 1 for _ in range(b)]).astype(np.int32)
    ).to(dev)
    for kv in ("kv8", "kv4"):
        k_pool, k_sc = kv_data(torch, gen, kv, None, pages, bs, kvh, d)
        v_pool, v_sc = kv_data(torch, gen, kv, None, pages, bs, kvh, d)
        kw = dict(k_scale=k_sc, v_scale=v_sc, kv_quant=kv)
        for dname, dt in dtypes:
            s = 2 if dname == "bf16" else 4
            for L in (1, 4, 5, 16, 256):
                nb = max(64, -(-(max(pos_list) + L) // bs))
                table = full_table[:, :nb].contiguous()
                q = rnd(b, L, h, d).to(dt)
                live = max(pos_list) + L
                k_view, v_view = (kv_dequant(kv, attn.paged_gather(x, table)[:, :live],
                                          attn.paged_gather(sc, table)[:, :live])
                                  for x, sc in ((k_pool, k_sc), (v_pool, v_sc)))
                keys = sum(p + L for p in pos_list)  # distinct cached keys the rows read
                pairs = sum(p + j + 1 for p in pos_list for j in range(L))
                check(f"paged_decode_attention_{kv}", f"{kv} {dname} B={b} L={L}",
                      lambda: attn.paged_decode_attention(q, k_pool, v_pool, table, pos, **kw),
                      lambda: attn.paged_decode_attention_plain(q, k_pool, v_pool, table, pos,
                                                                **kw),
                      q=q, k_view=k_view, v_view=v_view,
                      valid=decode_valid(torch, pos, L, live), dname=dname,
                      bytes_moved=2 * b * L * h * d * s + 2 * keys * kvh * kv_row_bytes(kv, d, s)
                      + b * nb * 4 + b * 4, flops=4 * h * d * pairs)

    s_c = 1024
    for kv in ("bf16", "kv8", "kv4"):
        for dname, dt in dtypes:
            s = 2 if dname == "bf16" else 4
            k, k_sc = kv_data(torch, gen, kv, dt, b, s_c, kvh, d)
            v, v_sc = kv_data(torch, gen, kv, dt, b, s_c, kvh, d)
            kw = dict(k_scale=k_sc, v_scale=v_sc, kv_quant=kv)
            name = "dense_decode_attention" + ("" if kv == "bf16" else f"_{kv}")
            for L in (1, 16):
                q = rnd(b, L, h, d).to(dt)
                live = max(pos_list) + L
                k_view, v_view = (kv_dequant(kv, x[:, :live], None if sc is None else sc[:, :live])
                                  for x, sc in ((k, k_sc), (v, v_sc)))
                keys = sum(p + L for p in pos_list)
                pairs = sum(p + j + 1 for p in pos_list for j in range(L))
                prefix = "" if kv == "bf16" else f"{kv} "
                check(name, f"{prefix}{dname} B={b} S_c={s_c} L={L}",
                      lambda: attn.dense_decode_attention(q, k, v, pos, **kw),
                      lambda: attn.dense_decode_attention_plain(q, k, v, pos, **kw),
                      q=q, k_view=k_view, v_view=v_view,
                      valid=decode_valid(torch, pos, L, live), dname=dname,
                      bytes_moved=2 * b * L * h * d * s + 2 * keys * kvh * kv_row_bytes(kv, d, s)
                      + b * 4, flops=4 * h * d * pairs)
            del k, v, k_sc, v_sc

    # A ring cache as the engine sizes one (S_c = window = 256): row 37 is in
    # its first window, the other three have wrapped.
    window = ring = 256
    slot = torch.arange(ring, device=dev)
    qpos = pos.long()[:, None]
    valid = torch.where(qpos < window, slot <= qpos,
                        torch.remainder(qpos - slot, ring) < torch.clamp(qpos + 1, max=window))
    keys = int(valid.sum().item())
    for dname, dt in dtypes:
        s = 2 if dname == "bf16" else 4
        k, v = rnd(b, ring, kvh, d).to(dt), rnd(b, ring, kvh, d).to(dt)
        q = rnd(b, 1, h, d).to(dt)
        check("dense_decode_attention", f"{dname} B={b} S_c={ring} window={window} L=1",
              lambda: attn.dense_decode_attention(q, k, v, pos, window=window),
              lambda: attn.dense_decode_attention_plain(q, k, v, pos, window=window),
              q=q, k_view=k, v_view=v, valid=valid[:, None], dname=dname,
              bytes_moved=2 * b * h * d * s + 2 * keys * kvh * d * s + b * 4,
              flops=4 * h * d * keys)

    identity = {}
    nb = s_c // bs
    table = torch.arange(b * nb, dtype=torch.int32, device=dev).reshape(b, nb)
    for kv, dname, dt in (("bf16", "bf16", torch.bfloat16), ("bf16", "f32", torch.float32),
                          ("kv8", "bf16", torch.bfloat16), ("kv4", "bf16", torch.bfloat16)):
        k, k_sc = kv_data(torch, gen, kv, dt, b, s_c, kvh, d)
        v, v_sc = kv_data(torch, gen, kv, dt, b, s_c, kvh, d)

        def pages_of(x):
            return None if x is None else x.reshape(b * nb, bs, *x.shape[2:])

        for L in (1, 5, 16):
            q = rnd(b, L, h, d).to(dt)
            dense = attn.dense_decode_attention(q, k, v, pos, k_scale=k_sc, v_scale=v_sc,
                                                kv_quant=kv)
            paged = attn.paged_decode_attention(q, pages_of(k), pages_of(v), table, pos,
                                                k_scale=pages_of(k_sc), v_scale=pages_of(v_sc),
                                                kv_quant=kv)
            # A second call gives the same bits: the split merge runs in a
            # fixed order and leaves its counters at 0.
            again = attn.paged_decode_attention(q, pages_of(k), pages_of(v), table, pos,
                                                k_scale=pages_of(k_sc), v_scale=pages_of(v_sc),
                                                kv_quant=kv)
            same = bool(torch.equal(paged, dense)) and bool(torch.equal(paged, again))
            identity[f"{kv} {dname} L={L}"] = same
            log(f"[kernel] identity-table paged == dense, {kv} {dname} L={L}: bit for bit {same}")
            if not same:
                raise AssertionError(f"identity-table paged != dense or != paged again ({kv} "
                                     f"{dname} L={L}): max diffs "
                                     f"{(paged.float() - dense.float()).abs().max().item()}, "
                                     f"{(paged.float() - again.float()).abs().max().item()}")
    torch.cuda.synchronize()
    return identity


def check_pack_kernels(torch, dev, target, timer, results: dict) -> None:
    """Phase 2, the pack and unpack kernels, bit for bit against ref.pack /
    ref.unpack: the weight packs at load ((8192, 2048) bf16 and int8 at
    (128, 128), the int4 scales (8192, 128) bf16 at (128, 8)), and the
    activation and output shapes of the packed routes, which the serving
    paths no longer pack or unpack (4 decode rows at M0 = 4, a 20-row int8
    verify window at M0 = 8, 300 prefill rows at M0 = 128; unpacks to (300,
    8192) and (4, 8192) f32): the exports ops.pack_pallas and unpack_pallas
    take them.  The
    library yardstick is the permute(...).contiguous() copy on the padded
    operand (the pad is made outside the timing); the bound counts each
    byte the function must read and write once.  Then batch_mmt4d at an
    attention scores shape, a context shape and 64 x 64 output tiles, f32
    and bf16, against its plain version, torch.einsum timed as the
    yardstick."""
    from repro_torch.kernels import batch_mmt4d, pack

    gen = torch.Generator(device=dev).manual_seed(3)

    def raw(t):
        return t.contiguous().view({1: torch.int8, 2: torch.int16, 4: torch.int32}[
            t.element_size()])

    def data(dtype, *shape):
        x = torch.randn(shape, generator=gen, device=dev)
        return (x * 40).round().clamp(-127, 127).to(dtype) if dtype == torch.int8 else x.to(dtype)

    names = {torch.bfloat16: "bf16", torch.int8: "int8", torch.float32: "f32"}
    for dtype, (r, c), (t0, t1) in (
            (torch.bfloat16, (8192, 2048), (128, 128)), (torch.int8, (8192, 2048), (128, 128)),
            (torch.bfloat16, (8192, 128), (128, 8)), (torch.bfloat16, (4, 2048), (4, 128)),
            (torch.int8, (20, 2048), (8, 128)), (torch.bfloat16, (300, 2048), (128, 128))):
        x = data(dtype, r, c)
        r1, c1 = -(-r // t0), -(-c // t1)
        padded = torch.nn.functional.pad(x.float(), (0, c1 * t1 - c, 0, r1 * t0 - r)).to(dtype)
        same = torch.equal(raw(pack.pack(x, (t0, t1))), raw(pack.pack_plain(x, (t0, t1))))
        e = x.element_size()
        add_row(results, target, "pack", f"{names[dtype]} ({r}, {c}) tile ({t0}, {t1})",
                err=0.0 if same else float("inf"), tol=0.0,
                ms=timer.ms(lambda: pack.pack(x, (t0, t1))),
                plain_ms=timer.ms(lambda: pack.pack_plain(x, (t0, t1))),
                library_ms=timer.ms(lambda: padded.reshape(r1, t0, c1, t1).permute(
                    0, 2, 1, 3).contiguous()),
                bytes_moved=r * c * e + r1 * c1 * t0 * t1 * e, flops=0, dname=names[dtype])
    for m, m0 in ((300, 128), (4, 4)):
        m1 = -(-m // m0)
        y = data(torch.float32, m1, 64, m0, 128)
        same = torch.equal(raw(pack.unpack(y, (m, 8192))), raw(pack.unpack_plain(y, (m, 8192))))
        add_row(results, target, "unpack", f"f32 ({m1}, 64, {m0}, 128) -> ({m}, 8192)",
                err=0.0 if same else float("inf"), tol=0.0,
                ms=timer.ms(lambda: pack.unpack(y, (m, 8192))),
                plain_ms=timer.ms(lambda: pack.unpack_plain(y, (m, 8192)).contiguous()),
                library_ms=timer.ms(lambda: y.permute(0, 2, 1, 3).reshape(m1 * m0, 8192)[:m]),
                bytes_moved=2 * m * 8192 * 4, flops=0, dname="f32")

    for dname, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        s = 2 if dname == "bf16" else 4
        for label, (b, m1, n1, k1, m0, n0, k0) in (("scores", (128, 8, 8, 1, 16, 16, 64)),
                                                   ("context", (128, 8, 4, 2, 16, 16, 64)),
                                                   ("tile64", (32, 2, 2, 2, 64, 64, 64))):
            lhs = data(dtype, b, m1, k1, m0, k0)
            rhs = data(dtype, b, n1, k1, n0, k0)
            got = batch_mmt4d.batch_mmt4d(lhs, rhs)
            want = batch_mmt4d.batch_mmt4d_plain(lhs, rhs)
            m, n, k = m1 * m0, n1 * n0, k1 * k0
            add_row(results, target, "batch_mmt4d",
                    f"{dname} {label} {tuple(lhs.shape)} x {tuple(rhs.shape)}",
                    err=(got - want).abs().max().item(),
                    tol=1e-4 + 1e-5 * want.abs().max().item(),
                    ms=timer.ms(lambda: batch_mmt4d.batch_mmt4d(lhs, rhs)),
                    plain_ms=timer.ms(lambda: batch_mmt4d.batch_mmt4d_plain(lhs, rhs)),
                    library_ms=timer.ms(lambda: torch.einsum("zmkac,znkbc->zmnab", lhs, rhs)),
                    bytes_moved=b * (m * k + n * k) * s + b * m * n * 4,
                    flops=2 * b * m * n * k, dname=dname)
    torch.cuda.synchronize()


# (query heads, kv heads) of the dense family's group sizes at D = 128:
# Qwen2.5-14B/32B 40/8 (G = 5), Qwen2-1.5B 12/2 (G = 6), Yi-9B 32/4 (G = 8).
DENSE_HEADS = {5: (40, 8), 6: (12, 2), 8: (32, 4)}
# K x N of the dense family's projections: Qwen2-1.5B's q/o, k/v, gate/up
# and down, and the untied heads of Yi-9B and Qwen2.5 (N = vocab).
DENSE_KN = ((1536, 1536), (1536, 256), (1536, 8960), (8960, 1536), (4096, 64000),
            (5120, 152064))


def check_dense_family_attention(torch, dev, target, timer, results: dict) -> dict:
    """Phase 2, the decode and prefill kernels at the dense family's heads
    (D = 128; G = 5, 6, 8; B = 4, pos {37, 300, 511, 900}): paged decode on
    bf16, kv8 and kv4 pools and dense decode (S_c = 2048) at L = 1, 3, 5, 16
    and 256 with bf16 queries (f32 too on the bf16 layouts at L = 1 and
    16), flash prefill in bf16 and f32, each against its plain version at
    the tolerances of the Llama shapes with SDPA on the expanded heads as
    the yardstick; then the identity-table paged == dense check (S_c =
    1024), bit for bit."""
    import numpy as np

    from repro_torch.kernels import attn

    gen = torch.Generator(device=dev).manual_seed(5)
    b, d, bs, pages = 4, 128, 16, 257
    pos_list = [37, 300, 511, 900]
    pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
    rng = np.random.RandomState(5)
    full_table = torch.from_numpy(
        np.stack([rng.permutation(pages - 1)[:80] + 1 for _ in range(b)]).astype(np.int32)
    ).to(dev)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def check(name, key, fn, plain, *, q, k_view, v_view, valid, dname, bytes_moved, flops):
        attn_row(torch, timer, results, target, name, key, fn, plain, q=q, k=k_view, v=v_view,
                 valid=valid, library_ms=timer.ms(sdpa_call(torch, q, k_view, v_view,
                                                            valid[:, None], q.shape[2]
                                                            // k_view.shape[2])),
                 bytes_moved=bytes_moved, flops=flops, dname=dname, plain_iters=3)

    identity = {}
    for g, (h, kvh) in sorted(DENSE_HEADS.items()):
        for kv in ("bf16", "kv8", "kv4"):
            name = "paged_decode_attention" + ("" if kv == "bf16" else f"_{kv}")
            dts = [("bf16", torch.bfloat16)] + ([("f32", torch.float32)] if kv == "bf16" else [])
            for dname, dt in dts:
                s = 2 if dname == "bf16" else 4
                k_pool, k_sc = kv_data(torch, gen, kv, dt, pages, bs, kvh, d)
                v_pool, v_sc = kv_data(torch, gen, kv, dt, pages, bs, kvh, d)
                kw = dict(k_scale=k_sc, v_scale=v_sc, kv_quant=kv)
                for L in ((1, 3, 5, 16, 256) if dname == "bf16" else (1, 16)):
                    nb = max(64, -(-(max(pos_list) + L) // bs))
                    table = full_table[:, :nb].contiguous()
                    q = rnd(b, L, h, d).to(dt)
                    live = max(pos_list) + L
                    k_view, v_view = (kv_dequant(kv, attn.paged_gather(x, table)[:, :live],
                                              None if sc is None else
                                              attn.paged_gather(sc, table)[:, :live])
                                      for x, sc in ((k_pool, k_sc), (v_pool, v_sc)))
                    keys = sum(p + L for p in pos_list)
                    pairs = sum(p + j + 1 for p in pos_list for j in range(L))
                    prefix = "" if kv == "bf16" else f"{kv} "
                    check(name, f"{prefix}{dname} D=128 G={g} B={b} L={L}",
                          lambda: attn.paged_decode_attention(q, k_pool, v_pool, table, pos,
                                                              **kw),
                          lambda: attn.paged_decode_attention_plain(q, k_pool, v_pool, table,
                                                                    pos, **kw),
                          q=q, k_view=k_view, v_view=v_view,
                          valid=decode_valid(torch, pos, L, live), dname=dname,
                          bytes_moved=2 * b * L * h * d * s
                          + 2 * keys * kvh * kv_row_bytes(kv, d, s) + b * nb * 4 + b * 4,
                          flops=4 * h * d * pairs)
                del k_pool, v_pool, k_sc, v_sc

        s_c = 2048  # holds the L = 256 windows past pos 900
        for dname, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            s = 2 if dname == "bf16" else 4
            k, v = rnd(b, s_c, kvh, d).to(dt), rnd(b, s_c, kvh, d).to(dt)
            for L in ((1, 3, 5, 16, 256) if dname == "bf16" else (1, 16)):
                q = rnd(b, L, h, d).to(dt)
                live = max(pos_list) + L
                keys = sum(p + L for p in pos_list)
                pairs = sum(p + j + 1 for p in pos_list for j in range(L))
                check("dense_decode_attention", f"{dname} D=128 G={g} B={b} S_c={s_c} L={L}",
                      lambda: attn.dense_decode_attention(q, k, v, pos),
                      lambda: attn.dense_decode_attention_plain(q, k, v, pos),
                      q=q, k_view=k[:, :live], v_view=v[:, :live],
                      valid=decode_valid(torch, pos, L, live), dname=dname,
                      bytes_moved=2 * b * L * h * d * s + 2 * keys * kvh * d * s + b * 4,
                      flops=4 * h * d * pairs)

            for sq, sk, q_off in ((512, 512, 0), (256, 512, 256)):
                q, kp, vp = rnd(b, sq, h, d).to(dt), rnd(b, sk, kvh, d).to(dt), \
                    rnd(b, sk, kvh, d).to(dt)
                qpos = q_off + torch.arange(sq, device=dev)
                mask = torch.arange(sk, device=dev)[None, :] <= qpos[:, None]
                pairs = int(mask.sum().item())
                check("flash_prefill_attention",
                      f"{dname} D=128 G={g} B={b} Sq={sq} Sk={sk} q_offset={q_off}",
                      lambda: attn.flash_prefill_attention(q, kp, vp, q_offset=q_off),
                      lambda: attn.flash_prefill_attention_plain(q, kp, vp, q_offset=q_off),
                      q=q, k_view=kp, v_view=vp, valid=mask[None].expand(b, -1, -1),
                      dname=dname,
                      bytes_moved=(2 * b * sq * h * d + 2 * b * sk * kvh * d) * s,
                      flops=4 * b * h * d * pairs)
            del k, v

        s_c = 1024
        nb = s_c // bs
        table = torch.arange(b * nb, dtype=torch.int32, device=dev).reshape(b, nb)
        for kv, dname, dt in (("bf16", "bf16", torch.bfloat16), ("bf16", "f32", torch.float32),
                              ("kv8", "bf16", torch.bfloat16), ("kv4", "bf16", torch.bfloat16)):
            k, k_sc = kv_data(torch, gen, kv, dt, b, s_c, kvh, d)
            v, v_sc = kv_data(torch, gen, kv, dt, b, s_c, kvh, d)

            def pages_of(x):
                return None if x is None else x.reshape(b * nb, bs, *x.shape[2:])

            for L in (1, 5, 16):
                q = rnd(b, L, h, d).to(dt)
                dense = attn.dense_decode_attention(q, k, v, pos, k_scale=k_sc, v_scale=v_sc,
                                                    kv_quant=kv)
                paged = attn.paged_decode_attention(q, pages_of(k), pages_of(v), table, pos,
                                                    k_scale=pages_of(k_sc),
                                                    v_scale=pages_of(v_sc), kv_quant=kv)
                same = bool(torch.equal(paged, dense))
                identity[f"{kv} {dname} D=128 G={g} L={L}"] = same
                log(f"[kernel] identity-table paged == dense, {kv} {dname} D=128 G={g} L={L}: "
                    f"bit for bit {same}")
                if not same:
                    raise AssertionError(f"identity-table paged != dense ({kv} {dname} D=128 "
                                         f"G={g} L={L}): max diff "
                                         f"{(paged.float() - dense.float()).abs().max().item()}")
    torch.cuda.synchronize()
    return identity


def check_dense_family_projections(torch, dev, target, timer, results: dict) -> None:
    """Phase 2, the projection kernels at the dense family's K x N
    (DENSE_KN): bf16 fused_gemv and mmt4d_gemv_rows at 1, 4 and 8 rows,
    mmt4d_rows at 20 (M0 = 8) and 2048 (M0 = 128) rows, fused_pack_mmt4d at
    2048 rows (tolerance 1e-3, matmul the yardstick); w8a8 fused_gemv_q8 and
    mmt4d_q8_rows, w4a8 g16 fused_gemv_q4 and mmt4d_q4_rows at the same
    rows, bit for bit (torch._int_mm + epilogue the w8a8 yardstick; none
    computes int4 x int8).  Weights drawn in bf16 and packed or quantized on
    the card as the model does; plain versions timed once a shape at 2048
    rows."""
    from repro_torch.kernels import (fused_gemv, fused_pack_mmt4d, mmt4d, mmt4d_gemv, mmt4d_q4,
                                     mmt4d_q8, ops, ref)

    gen = torch.Generator(device=dev).manual_seed(6)

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(torch.bfloat16)

    def check(name, key, fn, plain, *, exact, library_ms, bytes_moved, flops, dname, iters):
        got, want = fn(), plain()
        err = (got - want).abs().max().item()
        if exact and not torch.equal(got, want):
            raise AssertionError(f"{name} {key}: not equal to its plain version bit for bit "
                                 f"(max abs error {err})")
        add_row(results, target, name, key, err=err, tol=0.0 if exact else 1e-3,
                ms=timer.ms(fn), plain_ms=timer.ms(plain, iters=iters, warmup=1),
                library_ms=library_ms, bytes_moved=bytes_moved, flops=flops, dname=dname)

    for k, n in DENSE_KN:
        w_t = rnd(n, k, scale=k**-0.5)
        rhs4 = ref.pack(w_t, (128, 128))
        shape = f"K={k} N={n}"
        for m in (1, 4, 8, 20, 2048):
            x = rnd(m, k)
            iters = 1 if m == 2048 else 3
            lib_ms = timer.ms(lambda: torch.matmul(x, w_t.t()))
            kw = dict(exact=False, library_ms=lib_ms, bytes_moved=(m * k + n * k) * 2 + m * n * 4,
                      flops=2 * m * n * k, dname="bf16", iters=iters)
            if m <= 8:
                check("fused_gemv", f"dense bf16 M={m} {shape}",
                      lambda: fused_gemv.fused_gemv(x, rhs4),
                      lambda: fused_gemv.fused_gemv_plain(x, rhs4), **kw)
                check("mmt4d_gemv", f"dense bf16 rows M={m} {shape}",
                      lambda: mmt4d_gemv.mmt4d_gemv_rows(x, rhs4),
                      lambda: mmt4d_gemv.mmt4d_gemv_rows_plain(x, rhs4), **kw)
            else:
                m0 = 8 if m == 20 else 128
                check("mmt4d", f"dense bf16 rows M={m} {shape}",
                      lambda: mmt4d.mmt4d_rows(x, rhs4, m0),
                      lambda: mmt4d.mmt4d_rows_plain(x, rhs4, m0), **kw)
            if m == 2048:
                check("fused_pack_mmt4d", f"dense bf16 M={m} {shape}",
                      lambda: fused_pack_mmt4d.fused_pack_mmt4d(x, rhs4),
                      lambda: fused_pack_mmt4d.fused_pack_mmt4d_plain(x, rhs4), **kw)
        del rhs4
        rhs4_q, s_w = ops.pack_rhs_q8(w_t)
        w_q = ref.unpack(rhs4_q, (n, k)).contiguous()
        s_w_flat = s_w.reshape(-1)[:n]
        for m in (1, 4, 8, 20, 2048):
            xq, s_a = ref.quantize_rows(rnd(m, k))
            kw = dict(exact=True, library_ms=int_mm_time(torch, timer, xq, w_q, s_a, s_w_flat),
                      bytes_moved=m * k + n * k + m * 4 + n * 4 + m * n * 4,
                      flops=2 * m * n * k, dname="int8", iters=1 if m == 2048 else 3)
            if m <= 8:
                sa1 = s_a[:, None]
                check("fused_gemv_q8", f"dense w8a8 M={m} {shape}",
                      lambda: fused_gemv.fused_gemv_q8(xq, rhs4_q, sa1, s_w),
                      lambda: fused_gemv.fused_gemv_q8_plain(xq, rhs4_q, sa1, s_w), **kw)
            else:
                m0 = 8 if m == 20 else 128
                check("mmt4d_q8", f"dense w8a8 rows M={m} {shape}",
                      lambda: mmt4d_q8.mmt4d_q8_rows(xq, rhs4_q, s_a, s_w, m0),
                      lambda: mmt4d_q8.mmt4d_q8_rows_plain(xq, rhs4_q, s_a, s_w, m0), **kw)
        del rhs4_q, w_q
        rhs4_p, s_w4 = ops.pack_rhs_q4(w_t, group=16)
        del w_t
        for m in (1, 4, 8, 20, 2048):
            xq, s_a = ref.quantize_rows(rnd(m, k))
            kw = dict(exact=True, library_ms=None,
                      bytes_moved=m * k + n * k // 2 + n * (k // 16) * 2 + m * 4 + m * n * 4,
                      flops=2 * m * n * k, dname="int8", iters=1 if m == 2048 else 3)
            if m <= 8:
                sa1 = s_a[:, None]
                check("fused_gemv_q4", f"dense w4a8 g16 M={m} {shape}",
                      lambda: mmt4d_q4.fused_gemv_q4(xq, rhs4_p, sa1, s_w4, 16),
                      lambda: mmt4d_q4.fused_gemv_q4_plain(xq, rhs4_p, sa1, s_w4, 16), **kw)
            else:
                m0 = 8 if m == 20 else 128
                check("mmt4d_q4", f"dense w4a8 g16 rows M={m} {shape}",
                      lambda: mmt4d_q4.mmt4d_q4_rows(xq, rhs4_p, s_a, s_w4, 16, m0),
                      lambda: mmt4d_q4.mmt4d_q4_rows_plain(xq, rhs4_p, s_a, s_w4, 16, m0),
                      **kw)
        del rhs4_p, s_w4
        torch.cuda.empty_cache()
    torch.cuda.synchronize()


# Mixtral-8x22B (MoE, window 4096): K x N of its attention projections (q/o
# 6144 x 6144, k/v 6144 x 1024), its experts (gate/up 6144 x 16384, down
# 16384 x 6144) and its router (6144 x 8, f32 in the unquantized formats);
# the prompt longer than the window that phases 3 and 11 serve.
MOE_KN = ((6144, 6144), (6144, 1024), (6144, 16384), (16384, 6144))
MOE_LONG_PROMPT = 4500


def check_moe_shapes(torch, dev, target, timer, results: dict) -> None:
    """Phase 2, Mixtral-8x22B's shapes, each against its plain version: the
    projections (MOE_KN) in bf16 at 1 and 4 decode rows (fused_gemv) and at
    the expert buffer of a MOE_LONG_PROMPT-token prefill (cap = int(1.25 x
    4500 x 2 / 8) = 1406 rows, fused_pack_mmt4d), and in w8a8
    (fused_gemv_q8, mmt4d_q8_rows, bit for bit); the router (N = 8, one
    128-column pack tile) in f32 and int8 at 1, 4 and 4500 rows; windowed
    flash prefill at Sq = Sk = 4608, window 4096, G = 6 (48/8 heads, D =
    128); the ring dense decode at S_c = 4096 with rows in their first
    window, at its edge and wrapped.  The attention rows hold f32 to 1e-4
    and bf16 to bf16_attn_limit, element by element.  matmul,
    torch._int_mm + epilogue and SDPA with the window mask are the library
    times."""
    from repro_torch.configs import registry as cfg_registry
    from repro_torch.core import encoding
    from repro_torch.core.encoding import Phase
    from repro_torch.kernels import attn, fused_gemv, fused_pack_mmt4d, mmt4d_q8, ops, ref
    from repro_torch.models import layers as model_layers

    cfg = cfg_registry.get_config("mixtral-8x22b")
    cap = model_layers.moe_capacity(cfg, MOE_LONG_PROMPT)[1]
    gen = torch.Generator(device=dev).manual_seed(7)

    def rnd(*shape, scale=1.0, dt=torch.bfloat16):
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(dt)

    def check(name, key, fn, plain, *, tol, library_ms, bytes_moved, flops, dname):
        got, want = fn(), plain()
        err = (got.float() - want.float()).abs().max().item()
        if tol == 0.0 and not torch.equal(got, want):
            raise AssertionError(f"{name} {key}: not equal to its plain version bit for bit "
                                 f"(max abs error {err})")
        add_row(results, target, name, key, err=err, tol=tol, ms=timer.ms(fn),
                plain_ms=timer.ms(plain, iters=3), library_ms=library_ms,
                bytes_moved=bytes_moved, flops=flops, dname=dname)

    def projection(tag, w_t, rows, dname):
        n, k = w_t.shape
        s = 2 if dname == "bf16" else 4
        rhs4 = ref.pack(w_t, (128, 128))
        for m in rows:
            x = rnd(m, k, dt=w_t.dtype)
            kw = dict(tol=1e-3, library_ms=timer.ms(lambda: torch.matmul(x, w_t.t())),
                      bytes_moved=(m * k + n * k) * s + m * n * 4, flops=2 * m * n * k,
                      dname=dname)
            if m <= encoding.GEMV_MAX_ROWS:
                check("fused_gemv", f"moe {tag} M={m} K={k} N={n}",
                      lambda: fused_gemv.fused_gemv(x, rhs4),
                      lambda: fused_gemv.fused_gemv_plain(x, rhs4), **kw)
            else:
                check("fused_pack_mmt4d", f"moe {tag} M={m} K={k} N={n}",
                      lambda: fused_pack_mmt4d.fused_pack_mmt4d(x, rhs4),
                      lambda: fused_pack_mmt4d.fused_pack_mmt4d_plain(x, rhs4), **kw)
        del rhs4
        rhs4_q, s_w = ops.pack_rhs_q8(w_t)
        w_q = ref.unpack(rhs4_q, (n, k)).contiguous()
        s_w_flat = s_w.reshape(-1)[:n]
        for m in rows:
            xq, s_a = ref.quantize_rows(rnd(m, k))
            kw = dict(tol=0.0, library_ms=int_mm_time(torch, timer, xq, w_q, s_a, s_w_flat),
                      bytes_moved=m * k + n * k + m * 4 + n * 4 + m * n * 4,
                      flops=2 * m * n * k, dname="int8")
            if m <= encoding.GEMV_MAX_ROWS:
                sa1 = s_a[:, None]
                check("fused_gemv_q8", f"moe w8a8 {tag} M={m} K={k} N={n}",
                      lambda: fused_gemv.fused_gemv_q8(xq, rhs4_q, sa1, s_w),
                      lambda: fused_gemv.fused_gemv_q8_plain(xq, rhs4_q, sa1, s_w), **kw)
            else:
                m0 = encoding.select_tile_sizes(Phase.PREFILL, m_hint=m).m0
                check("mmt4d_q8", f"moe w8a8 {tag} rows M={m} K={k} N={n}",
                      lambda: mmt4d_q8.mmt4d_q8_rows(xq, rhs4_q, s_a, s_w, m0),
                      lambda: mmt4d_q8.mmt4d_q8_rows_plain(xq, rhs4_q, s_a, s_w, m0), **kw)
        del rhs4_q, w_q

    for k, n in MOE_KN:
        projection("bf16", rnd(n, k, scale=k**-0.5), (1, 4, cap), "bf16")
        torch.cuda.empty_cache()
    d, e = cfg.d_model, cfg.num_experts
    projection("router f32", rnd(e, d, scale=d**-0.5, dt=torch.float32),
               (1, 4, MOE_LONG_PROMPT), "f32")

    h, kvh, hd, window = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.sliding_window
    g = h // kvh
    sq = sk = 4608
    qpos = torch.arange(sq, device=dev)[:, None]
    kpos = torch.arange(sk, device=dev)[None, :]
    mask = (kpos <= qpos) & (kpos > qpos - window)
    pairs = int(mask.sum().item())
    b, s_c = 4, window
    pos_list = [37, 4095, 5000, 8000]  # first window, its last slot, wrapped twice
    pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
    slot = torch.arange(s_c, device=dev)
    rpos = pos.long()[:, None]
    valid = torch.where(rpos < window, slot <= rpos,
                        torch.remainder(rpos - slot, s_c) < torch.clamp(rpos + 1, max=window))
    keys = int(valid.sum().item())
    for dname, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        s = 2 if dname == "bf16" else 4
        q, kp, vp = rnd(1, sq, h, hd, dt=dt), rnd(1, sk, kvh, hd, dt=dt), rnd(1, sk, kvh, hd, dt=dt)
        attn_row(torch, timer, results, target, "flash_prefill_attention",
                 f"moe {dname} D=128 G={g} B=1 Sq={sq} Sk={sk} window={window}",
                 lambda: attn.flash_prefill_attention(q, kp, vp, window=window),
                 lambda: attn.flash_prefill_attention_plain(q, kp, vp, window=window),
                 q=q, k=kp, v=vp, valid=mask[None],
                 library_ms=timer.ms(sdpa_call(torch, q, kp, vp, mask, g)),
                 bytes_moved=(2 * sq * h * hd + 2 * sk * kvh * hd) * s, flops=4 * h * hd * pairs,
                 dname=dname, plain_iters=1)
        del q, kp, vp
        torch.cuda.empty_cache()
        k, v, q = rnd(b, s_c, kvh, hd, dt=dt), rnd(b, s_c, kvh, hd, dt=dt), rnd(b, 1, h, hd, dt=dt)
        attn_row(torch, timer, results, target, "dense_decode_attention",
                 f"moe ring {dname} D=128 G={g} B={b} S_c={s_c} window={window} L=1",
                 lambda: attn.dense_decode_attention(q, k, v, pos, window=window),
                 lambda: attn.dense_decode_attention_plain(q, k, v, pos, window=window),
                 q=q, k=k, v=v, valid=valid[:, None],
                 library_ms=timer.ms(sdpa_call(torch, q, k, v, valid[:, None, None, :], g)),
                 bytes_moved=2 * b * h * hd * s + 2 * keys * kvh * hd * s + b * 4,
                 flops=4 * h * hd * keys, dname=dname, plain_iters=3)
        del k, v, q
    torch.cuda.synchronize()

# K x N of the recurrent families' projections: RecurrentGemma-9B's q/o and
# RG-LRU (4096 x 4096), gate/up (4096 x 12288), k/v (one kv head of 256),
# down (12288 x 4096); RWKV6-1.6B's time mix (2048 x 2048), channel mix
# (2048 x 7168, 7168 x 2048) and untied head (2048 x 65536).
RECURRENT_KN = ((4096, 4096), (4096, 12288), (4096, 256), (12288, 4096), (2048, 2048),
                (2048, 7168), (7168, 2048), (2048, 65536))
RECURRENT_LONG_PROMPT = 2500


def check_recurrent_shapes(torch, dev, target, timer, results: dict) -> None:
    """Phase 2, the recurrent families' shapes, each against its plain
    version: RecurrentGemma's local attention at head dim 256 (16 query
    heads on one kv head, G = 16; window 2048): windowed flash prefill at B
    = 1, Sq = Sk = 2560, and the ring dense decode at S_c = 2048 with 4 rows
    in their first window, at its last slot and wrapped; bf16 element by
    element to bf16_attn_limit and f32 to 1e-4, SDPA with the window mask
    as the library time.  Then the projections (RECURRENT_KN) in bf16 at 1
    and 4 decode rows (fused_gemv) and a 2048-row prefill
    (fused_pack_mmt4d), to 1e-3, matmul as the library time."""
    from repro_torch.configs import registry as cfg_registry
    from repro_torch.kernels import attn, fused_gemv, fused_pack_mmt4d, ref

    cfg = cfg_registry.get_config("recurrentgemma-9b")
    gen = torch.Generator(device=dev).manual_seed(12)

    def rnd(*shape, scale=1.0, dt=torch.bfloat16):
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(dt)

    h, kvh, hd, window = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.sliding_window
    g = h // kvh
    sq = sk = 2560
    qpos = torch.arange(sq, device=dev)[:, None]
    kpos = torch.arange(sk, device=dev)[None, :]
    mask = (kpos <= qpos) & (kpos > qpos - window)
    pairs = int(mask.sum().item())
    b, s_c = 4, window
    pos = torch.tensor([37, 2047, 3000, 5000], dtype=torch.int32, device=dev)
    slot = torch.arange(s_c, device=dev)
    rpos = pos.long()[:, None]
    valid = torch.where(rpos < window, slot <= rpos,
                        torch.remainder(rpos - slot, s_c) < torch.clamp(rpos + 1, max=window))
    keys = int(valid.sum().item())
    for dname, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        s = 2 if dname == "bf16" else 4
        q, kp, vp = rnd(1, sq, h, hd, dt=dt), rnd(1, sk, kvh, hd, dt=dt), rnd(1, sk, kvh, hd, dt=dt)
        attn_row(torch, timer, results, target, "flash_prefill_attention",
                 f"recurrentgemma {dname} D={hd} G={g} B=1 Sq={sq} Sk={sk} window={window}",
                 lambda: attn.flash_prefill_attention(q, kp, vp, window=window),
                 lambda: attn.flash_prefill_attention_plain(q, kp, vp, window=window),
                 q=q, k=kp, v=vp, valid=mask[None],
                 library_ms=timer.ms(sdpa_call(torch, q, kp, vp, mask, g)),
                 bytes_moved=(2 * sq * h * hd + 2 * sk * kvh * hd) * s, flops=4 * h * hd * pairs,
                 dname=dname, plain_iters=1)
        del q, kp, vp
        k, v, q = rnd(b, s_c, kvh, hd, dt=dt), rnd(b, s_c, kvh, hd, dt=dt), rnd(b, 1, h, hd, dt=dt)
        attn_row(torch, timer, results, target, "dense_decode_attention",
                 f"recurrentgemma ring {dname} D={hd} G={g} B={b} S_c={s_c} window={window} L=1",
                 lambda: attn.dense_decode_attention(q, k, v, pos, window=window),
                 lambda: attn.dense_decode_attention_plain(q, k, v, pos, window=window),
                 q=q, k=k, v=v, valid=valid[:, None],
                 library_ms=timer.ms(sdpa_call(torch, q, k, v, valid[:, None, None, :], g)),
                 bytes_moved=2 * b * h * hd * s + 2 * keys * kvh * hd * s + b * 4,
                 flops=4 * h * hd * keys, dname=dname, plain_iters=3)
        del k, v, q
        torch.cuda.empty_cache()

    for k, n in RECURRENT_KN:
        w_t = rnd(n, k, scale=k**-0.5)
        rhs4 = ref.pack(w_t, (128, 128))
        for m in (1, 4, 2048):
            x = rnd(m, k)
            fn, plain = ((fused_gemv.fused_gemv, fused_gemv.fused_gemv_plain) if m <= 8 else
                         (fused_pack_mmt4d.fused_pack_mmt4d,
                          fused_pack_mmt4d.fused_pack_mmt4d_plain))
            got, want = fn(x, rhs4), plain(x, rhs4)
            add_row(results, target, fn.__name__, f"recurrent bf16 M={m} K={k} N={n}",
                    err=(got.float() - want.float()).abs().max().item(), tol=1e-3,
                    ms=timer.ms(lambda: fn(x, rhs4)),
                    plain_ms=timer.ms(lambda: plain(x, rhs4), iters=3),
                    library_ms=timer.ms(lambda: torch.matmul(x, w_t.t())),
                    bytes_moved=(m * k + n * k) * 2 + m * n * 4, flops=2 * m * n * k,
                    dname="bf16")
        del w_t, rhs4
    torch.cuda.synchronize()


def profiled(torch, fn) -> tuple[int, float] | tuple[None, None]:
    """(device kernels and copies one call of `fn` launches, the sum of their
    durations in ms: device busy time), by torch.profiler; (None, None)
    where the profiler records no device activity."""
    from torch.profiler import DeviceType, ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not device:
        return None, None
    return len(device), sum(e.time_range.elapsed_us() for e in device) / 1e3


def check_sampler(torch, dev, timer) -> dict:
    """Phase 2, the sampler (plain PyTorch, JAX's key stream): the (4,
    128256) random bits on the card equal the CPU's for three keys, and so
    do the uniforms and the sampled rows; a chi-square test of 20000 draws
    at V = 8 against softmax(l / T) (threshold 24.32, 7 degrees of freedom
    at p = 0.001); and, at the serving shape, its launches and device busy
    time (profiler) beside the time between CUDA events around one call,
    which the host's launch overhead bounds."""
    import numpy as np

    from repro_torch.serving import sampling

    shape = (4, 128256)
    gen = torch.Generator(device=dev).manual_seed(4)
    temp = torch.tensor([0.8, 0.0, 0.8, 0.0], device=dev)
    for seed, step in ((0, 0), (9, 3), (12345, 100000)):
        key = sampling.fold_in(sampling.prng_key(seed), step)
        bits = torch.equal(sampling.random_bits(key, shape, dev).cpu(),
                           sampling.random_bits(key, shape))
        u_dev = sampling.uniform(key, shape, minval=sampling.TINY, device=dev).cpu()
        u_cpu = sampling.uniform(key, shape, minval=sampling.TINY)
        uni = torch.equal(u_dev.view(torch.int32), u_cpu.view(torch.int32))
        logits = 4 * torch.randn(shape, generator=gen, device=dev)
        rows = torch.equal(sampling.sample_rows(logits, temp, key).cpu(),
                           sampling.sample_rows(logits.cpu(), temp.cpu(), key))
        log(f"[sampler] key {key}: bits card == CPU {bits}, uniforms {uni}, sampled rows {rows}")
        if not (bits and uni and rows):
            raise AssertionError(f"sampler on the card differs from the CPU for key {key}")
    logits = torch.tensor([1.0, 0.5, 0.0, -0.5, 2.0, -1.0, 0.25, 1.5], device=dev)
    n, t = 20000, 0.7
    draws = sampling.sample_rows(logits.expand(n, -1), torch.full((n,), t, device=dev),
                                 sampling.fold_in(sampling.prng_key(5), 0))
    counts = torch.bincount(draws, minlength=8).double().cpu()
    expect = n * torch.softmax(logits.double().cpu() / t, dim=0)
    chi2 = float(((counts - expect) ** 2 / expect).sum())
    log(f"[sampler] chi-square of {n} draws at V=8, T={t}: {chi2:.3f} (threshold 24.32)")
    if not chi2 < 24.32:
        raise AssertionError(f"sampler frequencies off: chi2 {chi2}, counts {counts.tolist()}")
    logits = torch.randn(shape, generator=gen, device=dev)
    key = sampling.fold_in(sampling.prng_key(0), 1)
    temps = np.array([0.8, 0.0, 0.8, 0.0], np.float32)

    def step():  # what a sampled decode step adds: the temperatures' copy, the sampler
        return sampling.sample_rows(logits, torch.from_numpy(temps).to(dev), key)

    launches, busy_ms = profiled(torch, step)
    out = {"chi2": chi2, "launches": launches, "busy_ms": busy_ms,
           "event_ms": timer.ms(step, flush=False),
           "argmax_ms": timer.ms(lambda: torch.argmax(logits, dim=-1), flush=False)}
    log(f"[sampler] (4, 128256) sampled step: {launches} device launches, device busy "
        f"{busy_ms} ms, {out['event_ms']:.4f} ms between CUDA events around the call "
        f"(greedy argmax {out['argmax_ms']:.4f} ms)")
    return out


def layer_projections(cfg, block: str) -> int:
    """Projection weights a layer of type `block` holds: an attention
    layer's 4 projections, then its MLP's 3 (SwiGLU) or 2 (GELU) or, for an
    MoE layer, the router and 3 a expert; an RG-LRU layer's 5 and its
    SwiGLU's 3; an RWKV layer's 5 time-mix and 3 channel-mix projections;
    an encoder layer's 4 and its MLP's (6 for Whisper); an enc-dec decoder
    layer's 4 self and 4 cross projections and its MLP's (10)."""
    ffn = 3 if cfg.mlp_kind == "swiglu" else 2
    if block in ("rec", "rwkv"):
        return 8
    if block == "encdec_attn":
        return 8 + ffn
    return 4 + (1 + 3 * cfg.num_experts if cfg.num_experts else ffn)


def init_model(cfg, enc, seed: int, dev):
    """T.model_init on the card, where every projection weight is packed by
    the pack kernel (int4 packs its codes and its scales): its launches must
    equal the weights made, layer_projections of every layer (+1 for an untied
    head; an enc-dec model's encoder layers, a VLM's 2 projector weights),
    doubled for int4; the layers by their block type."""
    from repro_torch.kernels import pack
    from repro_torch.models import transformer as T

    before = pack.pack.launches
    params = T.model_init(cfg, enc, seed=seed, device=dev)
    weights = (sum(layer_projections(cfg, t) for t in T.layer_types(cfg))
               + cfg.encoder_layers * layer_projections(cfg, "enc_attn")
               + (2 if cfg.family == "vlm" else 0) + (0 if cfg.tie_embeddings else 1))
    want = weights * (2 if enc.weight_quant == "int4" else 1)
    got = pack.pack.launches - before
    if got != want:
        raise AssertionError(f"model init ({enc.weight_quant} weights): {got} pack launches, "
                             f"tallied {want}")
    log(f"[init] {cfg.name} depth {cfg.num_layers} {enc.weight_quant} weights: {got} pack "
        f"launches == tallied")
    WEIGHT_PACKS.append(got)
    return params


def forward_check(torch, dev, seed: int) -> dict:
    """Phase 3: depth-2, full-width f32 model; one batched prefill and 8
    decode steps through the kernels and through the plain backends; then
    speculative decode, the token budget and 12 slots through the kernels,
    each emitting the plain phase-split engine's tokens."""
    import numpy as np

    from repro_torch.configs import registry as cfg_registry
    from repro_torch.core.packed import EncodingConfig
    from repro_torch.serving import engine as engine_lib
    from repro_torch.serving.config import EngineConfig

    cfg = dataclasses.replace(cfg_registry.get_config("llama3.2-1b"), num_layers=2,
                              dtype="float32")
    params = init_model(cfg, EncodingConfig(), seed, dev)
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(1, cfg.vocab_size, n).astype(np.int32) for n in (100, 37, 250, 180)]
    outs = {}
    for label, enc in (("kernels", EncodingConfig(backend="fused", attn_backend="auto")),
                       ("plain", EncodingConfig(backend="reference", attn_backend="xla"))):
        eng = engine_lib.Engine(params, cfg, enc,
                                config=EngineConfig(slots=4, max_seq=512, block_size=16),
                                device=dev)
        for i, p in enumerate(prompts):
            eng.submit(engine_lib.Request(uid=i, prompt=p, max_new_tokens=8))
        done = eng.run()
        st = eng.stats
        if st["dispatches"] != {"prefill": 1, "decode": 8}:
            raise AssertionError(f"{label}: dispatches {st['dispatches']}")
        outs[label] = {r.uid: r.generated for r in done}
    same = outs["kernels"] == outs["plain"]
    log(f"[forward] depth-2 f32 full width: kernel tokens == plain tokens: {same}")
    if not same:
        raise AssertionError(f"token mismatch: {outs}")

    # The window paths: 6 prompts of a 16-token pattern tiled (drafts are
    # proposed) and 6 incompressible ones, each engine against the plain
    # phase-split engine.
    prompts = [np.tile(rng.randint(1, cfg.vocab_size, 16), 12)[:n].astype(np.int32)
               for n in (48, 80, 112, 144, 176, 160)]
    prompts += [rng.randint(1, cfg.vocab_size, n).astype(np.int32)
                for n in (20, 64, 150, 200, 33, 97)]
    auto = EncodingConfig(backend="auto", attn_backend="auto")
    cases = [
        ("plain", EncodingConfig(backend="reference", attn_backend="xla"), dict(slots=12)),
        ("spec", auto, dict(slots=4, spec_decode=True, draft_k=4)),
        ("spec_pallas", EncodingConfig(backend="pallas", attn_backend="auto"),
         dict(slots=4, spec_decode=True, draft_k=4)),
        ("budget", auto, dict(slots=4, token_budget=64)),
        ("budget_spec", auto, dict(slots=4, token_budget=64, spec_decode=True, draft_k=4)),
        ("slots12", auto, dict(slots=12)),
    ]
    for label, enc, config in cases:
        eng = engine_lib.Engine(params, cfg, enc, device=dev,
                                config=EngineConfig(max_seq=512, block_size=16, **config))
        for i, p in enumerate(prompts):
            eng.submit(engine_lib.Request(uid=i, prompt=p, max_new_tokens=8))
        done = eng.run()
        st = eng.stats
        outs[label] = {r.uid: r.generated for r in done}
        if label != "plain" and outs[label] != outs["plain"]:
            raise AssertionError(f"{label}: tokens differ from the plain engine: "
                                 f"{outs[label]} vs {outs['plain']}")
        if st["pages_in_use"] or st["degraded"]:
            raise AssertionError(f"{label}: pages {st['pages_in_use']} degraded {st['degraded']}")
        if config.get("spec_decode") and not (st["spec"]["proposed"] > 0
                                              and st["dispatches"].get("verify", 0)
                                              + st["dispatches"].get("mixed", 0) > 0):
            raise AssertionError(f"{label}: no drafts verified: {st['spec']}")
        if config.get("token_budget") and st["continuous"]["decode_stall_steps"]:
            raise AssertionError(f"{label}: decode stalls {st['continuous']}")
        extra = (f" spec proposed={st['spec']['proposed']} accepted={st['spec']['accepted']}"
                 if "spec" in st else "")
        log(f"[forward] depth-2 f32 {label}: tokens == plain, dispatches {st['dispatches']}"
            f"{extra}")
    del params
    torch.cuda.empty_cache()
    return outs


def quant_forward_check(torch, dev, seed: int) -> dict:
    """Phase 3, quantized weights: the depth-2, full-width f32 model with
    int8 and with int4 weights, phase-split (backend "fused") and spec
    decode (registry routing), each against the plain quantized projections
    (backend "xla") in the same configuration.  Both runs take the attention
    kernels: the activation quantizer turns an f32 difference of one ulp into
    a whole int8 step, so the comparison isolates the quantized projection
    kernels, which equal their plain versions bit for bit."""
    import numpy as np

    from repro_torch.configs import registry as cfg_registry
    from repro_torch.core.packed import EncodingConfig
    from repro_torch.serving import engine as engine_lib
    from repro_torch.serving.config import EngineConfig

    cfg = dataclasses.replace(cfg_registry.get_config("llama3.2-1b"), num_layers=2,
                              dtype="float32")
    rng = np.random.RandomState(seed + 2)
    prompts = [np.tile(rng.randint(1, cfg.vocab_size, 16), 12)[:n].astype(np.int32)
               for n in (48, 80, 112, 144)]
    prompts += [rng.randint(1, cfg.vocab_size, n).astype(np.int32) for n in (20, 64, 150, 200)]
    kernels = kernel_fns()
    outs = {}
    for wq in ("int8", "int4"):
        params = init_model(cfg, EncodingConfig(weight_quant=wq), seed, dev)
        for label, backend, config in (("phase-split", "fused", dict(slots=4)),
                                       ("spec", "auto", dict(slots=4, spec_decode=True,
                                                             draft_k=4))):
            got = {}
            for be in ("xla", backend):
                before = {name: k.launches for name, k in kernels.items()}
                eng = engine_lib.Engine(
                    params, cfg, EncodingConfig(backend=be, attn_backend="auto", weight_quant=wq),
                    device=dev, config=EngineConfig(max_seq=512, block_size=16, **config))
                for i, p in enumerate(prompts):
                    eng.submit(engine_lib.Request(uid=i, prompt=p, max_new_tokens=8))
                got[be] = {r.uid: r.generated for r in eng.run()}
                st = eng.stats
                if st["pages_in_use"] or st["degraded"]:
                    raise AssertionError(f"{wq} {label} {be}: pages {st['pages_in_use']} "
                                         f"degraded {st['degraded']}")
                ran = {name for name, k in kernels.items() if k.launches > before[name]}
            if got["xla"] != got[backend]:
                raise AssertionError(f"{wq} {label}: kernel tokens differ from the plain "
                                     f"quantized path: {got[backend]} vs {got['xla']}")
            quant_ran = sorted(ran & {"fused_gemv_q8", "mmt4d_q8", "fused_gemv_q4", "mmt4d_q4"})
            if not quant_ran:
                raise AssertionError(f"{wq} {label}: no quantized kernel launched")
            extra = (f" spec proposed={st['spec']['proposed']} accepted={st['spec']['accepted']}"
                     if "spec" in st else "")
            log(f"[forward] depth-2 f32 {wq} {label}: kernel tokens == plain tokens, "
                f"dispatches {st['dispatches']}, kernels {quant_ran}{extra}")
            outs[f"{wq} {label}"] = got[backend]
        del params
    torch.cuda.empty_cache()
    return outs


def kv_forward_check(torch, dev, seed: int) -> dict:
    """Phase 3, KV layouts and the dense cache: the depth-2, full-width f32
    model.  kv8 pools through the paged kernel against the same engine on
    the plain attention (same projection kernels, so the quantized codes are
    the same and only the attention's order of sums differs), phase-split,
    spec decode and budget 64; the dense cache through the dense kernel
    (vectorized, grouped, spec, budget) against the plain phase-split engine;
    kv4 pools on the card against the same engine on the CPU (the plain
    attention would downgrade kv4 to kv8)."""
    import numpy as np

    from repro_torch.configs import registry as cfg_registry
    from repro_torch.core.packed import EncodingConfig
    from repro_torch.kernels import attn
    from repro_torch.serving import engine as engine_lib
    from repro_torch.serving.config import EngineConfig

    cfg = dataclasses.replace(cfg_registry.get_config("llama3.2-1b"), num_layers=2,
                              dtype="float32")
    params = init_model(cfg, EncodingConfig(), seed, dev)
    rng = np.random.RandomState(seed + 3)
    prompts = [np.tile(rng.randint(1, cfg.vocab_size, 16), 12)[:n].astype(np.int32)
               for n in (48, 80, 112, 144)]
    prompts += [rng.randint(1, cfg.vocab_size, n).astype(np.int32) for n in (20, 64, 150, 200)]

    def serve_tokens(label, prm, enc, config, device=dev, max_new=8, reqs=prompts):
        eng = engine_lib.Engine(prm, cfg, enc, device=device,
                                config=EngineConfig(max_seq=512, block_size=16, **config))
        for i, p in enumerate(reqs):
            eng.submit(engine_lib.Request(uid=i, prompt=p, max_new_tokens=max_new))
        got = {r.uid: r.generated for r in eng.run()}
        st = eng.stats
        if st.get("pages_in_use", 0) or st["degraded"] or len(got) != len(reqs):
            raise AssertionError(f"{label}: pages {st.get('pages_in_use')} degraded "
                                 f"{st['degraded']} finished {len(got)}")
        if config.get("token_budget") and st["continuous"]["decode_stall_steps"]:
            raise AssertionError(f"{label}: decode stalls {st['continuous']}")
        return got, st

    outs = {}
    paged = attn.paged_decode_attention.launches_by_kv
    dense = attn.dense_decode_attention.launches_by_kv
    for label, backend, config in (
            ("phase-split", "fused", dict(slots=4)),
            ("spec", "auto", dict(slots=4, spec_decode=True, draft_k=4)),
            ("budget", "auto", dict(slots=4, token_budget=64))):
        config = dict(config, kv_quant="kv8")
        want, _ = serve_tokens(f"kv8 {label} plain", params,
                               EncodingConfig(backend=backend, attn_backend="xla"), config)
        before = paged["kv8"]
        got, st = serve_tokens(f"kv8 {label}", params,
                               EncodingConfig(backend=backend, attn_backend="auto"), config)
        if got != want or paged["kv8"] == before or st["kv_quant"] != "kv8":
            raise AssertionError(f"kv8 {label}: tokens {got} vs plain attention {want}; kv8 "
                                 f"launches {paged['kv8'] - before}")
        log(f"[forward] depth-2 f32 kv8 {label}: kernel tokens == plain-attention tokens, "
            f"dispatches {st['dispatches']}, kv8 launches {paged['kv8'] - before}")
        outs[f"kv8 {label}"] = got

    plain, _ = serve_tokens("plain", params, EncodingConfig(backend="reference",
                                                            attn_backend="xla"), dict(slots=4))
    auto = EncodingConfig(backend="auto", attn_backend="auto")
    for label, config in (("dense", dict(slots=4, cache_mode="dense")),
                          ("grouped", dict(slots=4, decode_mode="grouped")),
                          ("dense spec", dict(slots=4, cache_mode="dense", spec_decode=True,
                                              draft_k=4)),
                          ("dense budget", dict(slots=4, cache_mode="dense", token_budget=64))):
        before = dense["bf16"]
        got, st = serve_tokens(label, params, auto, config)
        if got != plain or dense["bf16"] == before or st["cache_mode"] != "dense":
            raise AssertionError(f"{label}: tokens {got} vs plain {plain}; dense launches "
                                 f"{dense['bf16'] - before}")
        log(f"[forward] depth-2 f32 {label} ({st['decode_mode']}): tokens == plain, dispatches "
            f"{st['dispatches']}, dense launches {dense['bf16'] - before}")
        outs[label] = got

    cpu_params = _to_device(params, "cpu")
    reqs = prompts[:2] + prompts[4:6]
    kv4 = dict(slots=4, kv_quant="kv4")
    fused = EncodingConfig(backend="fused", attn_backend="auto")
    t0 = time.perf_counter()
    want, _ = serve_tokens("kv4 cpu", cpu_params, fused, kv4, device="cpu", reqs=reqs)
    cpu_s = time.perf_counter() - t0
    before = paged["kv4"]
    got, st = serve_tokens("kv4", params, fused, kv4, reqs=reqs)
    if got != want or paged["kv4"] == before or st["kv_quant"] != "kv4":
        raise AssertionError(f"kv4: card tokens {got} vs CPU {want}")
    log(f"[forward] depth-2 f32 kv4: card tokens == CPU tokens ({len(reqs)} requests, CPU "
        f"{cpu_s:.1f}s), kv4 launches {paged['kv4'] - before}")
    outs["kv4"] = got
    del params, cpu_params
    torch.cuda.empty_cache()
    return outs


def sampled_forward_check(torch, dev, seed: int) -> dict:
    """Phase 3, temperature sampling: the depth-2, full-width f32 model
    sampled at temperature 0.7 on half the requests and 0 on the others,
    paged vectorized and dense grouped decode: the kernels' tokens equal the
    plain backends' (the same logits within f32 rounding, the same key
    stream), and the temperature-0 requests equal the greedy engine's."""
    import numpy as np

    from repro_torch.configs import registry as cfg_registry
    from repro_torch.core.packed import EncodingConfig
    from repro_torch.serving import engine as engine_lib
    from repro_torch.serving.config import EngineConfig

    cfg = dataclasses.replace(cfg_registry.get_config("llama3.2-1b"), num_layers=2,
                              dtype="float32")
    params = init_model(cfg, EncodingConfig(), seed, dev)
    rng = np.random.RandomState(seed + 4)
    prompts = [rng.randint(1, cfg.vocab_size, n).astype(np.int32)
               for n in (100, 37, 250, 180, 64, 20)]
    temps = [0.7 if i % 2 == 0 else 0.0 for i in range(len(prompts))]
    kernels = EncodingConfig(backend="fused", attn_backend="auto")
    plain = EncodingConfig(backend="reference", attn_backend="xla")
    outs = {}
    for mode, config in (("vectorized", dict()), ("grouped", dict(decode_mode="grouped"))):
        got = {}
        for label, enc, sample in (("kernels", kernels, "temperature"),
                                   ("plain", plain, "temperature"),
                                   ("greedy", kernels, "greedy")):
            eng = engine_lib.Engine(params, cfg, enc, device=dev, config=EngineConfig(
                slots=4, max_seq=512, block_size=16, sample=sample, seed=seed, **config))
            for i, (p, t) in enumerate(zip(prompts, temps)):
                eng.submit(engine_lib.Request(uid=i, prompt=p, max_new_tokens=8, temperature=t))
            got[label] = {r.uid: r.generated for r in eng.run()}
            st = eng.stats
            if st["degraded"] or st.get("pages_in_use", 0) or st["decode_mode"] != mode:
                raise AssertionError(f"sampled {mode} {label}: {st['decode_mode']} degraded "
                                     f"{st['degraded']} pages {st.get('pages_in_use')}")
        if got["kernels"] != got["plain"]:
            raise AssertionError(f"sampled {mode}: kernel tokens {got['kernels']} differ from "
                                 f"the plain backends' {got['plain']}")
        cold = [i for i, t in enumerate(temps) if t == 0]
        if any(got["kernels"][i] != got["greedy"][i] for i in cold):
            raise AssertionError(f"sampled {mode}: temperature-0 requests differ from greedy")
        moved = sum(got["kernels"][i] != got["greedy"][i] for i, t in enumerate(temps) if t > 0)
        log(f"[forward] depth-2 f32 sampled {mode}: kernel tokens == plain tokens; temperature-0 "
            f"requests == greedy; {moved} of {len(temps) - len(cold)} sampled requests left "
            f"the greedy stream")
        outs[mode] = got["kernels"]
    del params
    torch.cuda.empty_cache()
    return outs


def _to_device(tree, device):
    """A copy of a parameter tree on `device`."""
    import torch

    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


class LayoutLaunches:
    """One KV layout's launch count of a decode kernel wrapper, read and set
    to 0 like a wrapper's own `launches`."""

    def __init__(self, fn, kv: str):
        self.fn, self.kv = fn, kv

    @property
    def launches(self) -> int:
        return self.fn.launches_by_kv[self.kv]

    @launches.setter
    def launches(self, n: int) -> None:
        self.fn.launches_by_kv[self.kv] = n


def kernel_fns() -> dict:
    """The kernel wrappers by table name, each with its launch count (the
    decode kernels' per KV layout)."""
    from repro_torch.kernels import (attn, batch_mmt4d, fused_gemv, fused_pack_mmt4d, mmt4d,
                                     mmt4d_gemv, mmt4d_q4, mmt4d_q8, pack)

    decode = {"paged": attn.paged_decode_attention, "dense": attn.dense_decode_attention}
    fns = {
        "fused_gemv": fused_gemv.fused_gemv,
        "fused_pack_mmt4d": fused_pack_mmt4d.fused_pack_mmt4d,
        "flash_prefill_attention": attn.flash_prefill_attention,
        "mmt4d": mmt4d.mmt4d,
        "mmt4d_gemv": mmt4d_gemv.mmt4d_gemv,
        "fused_gemv_q8": fused_gemv.fused_gemv_q8,
        "mmt4d_q8": mmt4d_q8.mmt4d_q8,
        "fused_gemv_q4": mmt4d_q4.fused_gemv_q4,
        "mmt4d_q4": mmt4d_q4.mmt4d_q4,
        "pack": pack.pack,
        "unpack": pack.unpack,
        "batch_mmt4d": batch_mmt4d.batch_mmt4d,
    }
    fns.update({name: LayoutLaunches(decode[cache], kv)
                for name, (cache, kv) in LAYOUT_ROWS.items()})
    return fns


class DispatchTally:
    """Tallies, for one engine, the launches its dispatches should make.

    Wraps the instance's _dispatch and step (nothing in the engine changes):
    before each dispatch, the rows it feeds the model (the token tensor's
    size: batch x padded length at prefill, slots at decode, slots x L for a
    verify or mixed window), the weight format and the registry decide which
    kernel its projections and its attention resolve to, as kernels/ops.py
    and models/layers.py route them; each adds layers launches per
    projection (a packed projection is one launch of its GEMM's plain-row
    entry: no pack, no unpack, so their tallies stay 0).  A dense layer has
    7 projections at the dispatch's rows and one attention launch.  An MoE
    layer has 4 attention projections and the router at those rows, and 3
    a expert at each expert buffer's rows (models/layers.moe_expert_rows:
    groups x cap, or every row under moe_dense_decode at decode), dead and
    padded rows taking capacity.  An RG-LRU or RWKV layer has 8 projections
    at the dispatch's rows and no attention (its recurrence is plain
    PyTorch).  An untied head adds one projection a dispatch at its logit
    rows (the batch at prefill, every window row of a verify, the
    logits_idx columns of a mixed step); a tied head is torch.matmul, no
    kernel.  `by_type` keeps the launches by layer type ("head" for the
    head).  Each step's watchdog duration is kept under the kinds it
    dispatched (verify and mixed windows with their width L)."""

    def __init__(self, eng):
        import collections

        from repro_torch.core.encoding import GEMV_MAX_ROWS, Phase
        from repro_torch.core.packed import QUANT_KEYS
        from repro_torch.kernels import registry
        from repro_torch.models import layers as model_layers

        from repro_torch.models import transformer as T

        self.want = collections.Counter()
        self.by_kind = collections.Counter()  # (kind, kernel) -> launches
        self.by_type = collections.Counter()  # (layer type, kernel) -> launches
        self.max_rows = collections.Counter()  # kind -> most rows of one dispatch
        self.step_ms: dict[str, list[float]] = collections.defaultdict(list)
        kinds: list[str] = []
        dispatch, step = eng._dispatch, eng.step
        quant = QUANT_KEYS[eng.enc.weight_quant]
        requested = eng.enc.resolved_backend() if quant == "none" else eng.enc.quant_backend()

        def routed(kind: str, rows: int) -> tuple[str | None, str | None]:
            phase = Phase.PREFILL if kind == "prefill" else Phase.DECODE
            small = phase is Phase.DECODE and rows <= GEMV_MAX_ROWS
            mm = registry.select(quant=quant, phase=phase, m=rows, target=eng.enc.target,
                                 requested=requested).backend
            pair = MATMUL_KERNELS[quant].get(mm)  # None: a plain backend, no kernel
            mm_kernel = pair and pair[0 if small else 1]
            # As models/layers.py keys it: prefill and the dense cache as
            # bf16, a paged decode by its pool's layout.
            paged = phase is Phase.DECODE and eng.cache_mode == "paged"
            kv = eng.kv_quant if paged else "bf16"
            at = registry.select_attn(phase=phase, s=eng._attn_s(phase), target=eng.enc.target,
                                      requested=eng.enc.attn_backend, kv=kv).backend
            at_kernel = None
            if at == "pallas":
                at_kernel = ("flash_prefill_attention" if phase is Phase.PREFILL
                             else LAYOUT_NAMES[("paged" if paged else "dense", kv)])
            return mm_kernel, at_kernel

        cfg = eng.cfg
        counts = collections.Counter(T.layer_types(cfg))

        def counted_dispatch(kind, fn, *args):
            rows = int(args[0].numel())
            mm_kernel, at_kernel = routed(kind, rows)
            out = dispatch(kind, fn, *args)
            attn = counts["attn"]
            launched = [("rec", mm_kernel, 8 * counts["rec"]),
                        ("rwkv", mm_kernel, 8 * counts["rwkv"]), ("attn", at_kernel, attn)]
            if cfg.num_experts:
                phase = Phase.PREFILL if kind == "prefill" else Phase.DECODE
                expert_kernel = routed(kind, model_layers.moe_expert_rows(cfg, rows, phase))[0]
                launched += [("attn", mm_kernel, 5 * attn),
                             ("attn", expert_kernel, 3 * cfg.num_experts * attn)]
            else:
                launched.append(("attn", mm_kernel, 7 * attn))
            if not cfg.tie_embeddings:
                logit_rows = (args[0].shape[0] if kind == "prefill"
                              else int(args[2].numel()) if kind == "mixed" else rows)
                launched.append(("head", routed(kind, logit_rows)[0], 1))
            for block, kernel, n in launched:
                if kernel is not None and n:
                    self.want[kernel] += n
                    self.by_kind[(kind, kernel)] += n
                    self.by_type[(block, kernel)] += n
            self.max_rows[kind] = max(self.max_rows[kind], rows)
            kinds.append(kind if kind in ("prefill", "decode") else f"{kind} L={rows // eng.slots}")
            return out

        def timed_step():
            kinds.clear()
            emitted = step()
            label = "+".join(sorted(set(kinds))) or "idle"
            self.step_ms[label].append(1e3 * eng.watchdog.last_duration)
            return emitted

        eng._dispatch = counted_dispatch
        eng.step = timed_step

    def step_summary(self) -> dict:
        import numpy as np

        return {k: {"steps": len(v), "p50_ms": float(np.percentile(v, 50)),
                    "p99_ms": float(np.percentile(v, 99))}
                for k, v in sorted(self.step_ms.items())}


def counted_run(torch, dev, params, cfg, enc, config: dict, drive, label: str,
                tag: str) -> tuple[object, dict]:
    """Serve one run at full depth: an engine of `config`, every launch count
    set to 0 just before `drive(eng)` and read just after, each equal to its
    dispatch tally; every request must finish ok with all its tokens and no
    page may leak or key be quarantined.  A tensor-parallel engine (config
    mesh_shape, this process one rank) runs its shard's kernels, each rank
    the same dispatches, so the same tally holds per rank; its collectives,
    set to 0 and read as the launches, must be 2 a layer plus the
    embedding's and the head's a dispatch, plus 2 a layer of activation
    absmax reduces with int8 or int4 weights, each staged through the host
    on gloo."""
    from repro_torch.core import encoding
    from repro_torch.models import transformer as T
    from repro_torch.parallel import collectives
    from repro_torch.serving import engine as engine_lib
    from repro_torch.serving.config import EngineConfig

    kernels = kernel_fns()
    eng = engine_lib.Engine(params, cfg, enc, device=dev,
                            config=EngineConfig(**{"max_seq": 1024, "block_size": 16, **config}))
    tally = DispatchTally(eng)
    for k in kernels.values():
        k.launches = 0
    collectives.counts.clear()
    gc.collect()  # earlier runs' engines sit in reference cycles (DispatchTally's wrappers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    start_gib = torch.cuda.memory_allocated(dev) / 2**30
    t0 = time.perf_counter()
    done = drive(eng)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    coll = {k: v for k, v in collectives.counts.items() if k != "host_copies"}
    host_copies = collectives.counts["host_copies"]
    want = {name: tally.want[name] for name in kernels}
    st = eng.stats
    bad = [(r.uid, r.status, len(r.generated)) for r in done
           if r.status != "ok" or len(r.generated) != r.max_new_tokens]
    if bad:
        raise AssertionError(f"{label}: requests not all ok with their tokens: {bad}")
    eng.audit()
    degraded = st["degraded"]
    if isinstance(degraded, dict):  # per shard at tp > 1
        degraded = [d for ds in degraded.values() for d in ds]
    if st.get("pages_in_use", 0) or degraded:
        raise AssertionError(f"{label}: pages {st.get('pages_in_use')} degraded {degraded}")
    if launches != want:
        raise AssertionError(f"{label}: launch counts {launches} != tallied {want}")
    if eng.tp_shards > 1:
        n, layers = sum(st["dispatches"].values()), cfg.num_layers
        quant = enc.weight_quant != "none"
        want_coll = {"all_reduce_sum": n * (2 * layers + 1), "all_gather_last": n,
                     "all_reduce_max": n * 2 * layers if quant else 0}
        got_coll = {k: coll.get(k, 0) for k in want_coll}
        if got_coll != want_coll:
            raise AssertionError(f"{label}: collectives {got_coll} != tallied {want_coll}")
        device_coll = sum(want_coll.values())
        if dev.type == "cuda" and eng.mesh.backend == "gloo" and host_copies != device_coll:
            raise AssertionError(f"{label}: {host_copies} host copies for {device_coll} "
                                 "collectives of card tensors on gloo")
    tokens = sum(len(r.generated) for r in done)
    itemsize = torch.empty((), dtype=cfg.activation_dtype).element_size()
    out = {"requests": len(done), "tokens": tokens, "wall_s": wall, "tok_s": tokens / wall,
           "steps": st["steps"], "dispatches": st["dispatches"], "launches": launches,
           "mmt4d_by_kind": {k: n for (k, name), n in tally.by_kind.items() if name == "mmt4d"},
           "launches_by_layer_type": {f"{block} {name}": n
                                      for (block, name), n in sorted(tally.by_type.items())},
           "max_rows": dict(tally.max_rows), "step_ms": tally.step_summary(),
           "watchdog": st["watchdog"], "preemptions": st.get("preemptions", 0),
           "start_gib": start_gib, "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
           "prefix_hit_tokens": st.get("prefix_cache", {}).get("hit_tokens", 0),
           "cache_mode": st["cache_mode"], "decode_mode": st["decode_mode"],
           "kv_quant": st["kv_quant"],
           "cache_bytes_per_slot": T.cache_bytes(eng.caches) // eng.slots,
           "collectives": coll, "host_copies": host_copies,
           "kv_bytes_per_token": encoding.kv_bytes_per_token(
               cfg.num_layers, cfg.num_kv_heads, cfg.head_dim, itemsize=itemsize,
               kv_quant=st["kv_quant"])}
    for key in ("spec", "continuous"):
        if key in st:
            out[key] = {k: v for k, v in st[key].items() if not k.startswith("per_slot")}
    steps = "; ".join(f"{k} x{v['steps']} p50 {v['p50_ms']:.3f} p99 {v['p99_ms']:.3f} ms"
                      for k, v in out["step_ms"].items())
    log(f"[{tag}] {label}: {len(done)} requests, {tokens} tokens in {wall:.3f}s "
        f"({tokens / wall:.1f} tok/s incl. prefill); dispatches {st['dispatches']}; "
        f"max rows {out['max_rows']}; memory {start_gib:.2f} GiB at the start, peak "
        f"{out['peak_gib']:.2f} GiB; steps: {steps}")
    log(f"[{tag}] {label}: launches {launches} == tallied; mmt4d by kind "
        f"{out['mmt4d_by_kind']}")
    return eng, out


def submit_all(prompts, max_new):
    """A drive: submit every prompt (each must be admitted), then run."""
    from repro_torch.serving import engine as engine_lib

    def drive(eng):
        for i, p in enumerate(prompts):
            if not eng.submit(engine_lib.Request(uid=i, prompt=p, max_new_tokens=max_new)):
                raise AssertionError(f"request {i} rejected")
        return eng.run()
    return drive


def tiled_prompts(rng, vocab: int) -> list:
    """8 prompts, each a 16-token pattern tiled to 128-384 tokens, so the
    prompt-lookup drafter proposes every step."""
    import numpy as np

    return [np.tile(rng.randint(1, vocab, 16), 24)[: int(n)].astype(np.int32)
            for n in rng.choice([128, 192, 256, 320, 384], 8)]


def shared_prefix_prompts(rng, vocab: int) -> list:
    """Phase 4's 8 prompts of 100-500 tokens; requests 0, 4, 5 and 6 share a
    256-token prefix (wave 1 writes it, wave 2 reuses it)."""
    import numpy as np

    prefix = rng.randint(1, vocab, 256).astype(np.int32)
    lengths = rng.randint(100, 501, 8)
    prompts = []
    for i in range(8):
        if i in (0, 4, 5, 6):
            tail = rng.randint(1, vocab, max(1, int(lengths[i]) - 256))
            prompts.append(np.concatenate([prefix, tail]).astype(np.int32))
        else:
            prompts.append(rng.randint(1, vocab, int(lengths[i])).astype(np.int32))
    return prompts


def serve_windows(torch, dev, seed: int) -> dict:
    """Phase 5: full width and depth, bf16, through the paths of more than 8
    rows and the packed kernels.  Each run starts every launch count at 0
    and must end with the counts its dispatches tally."""
    import numpy as np

    from repro_torch.configs import registry as cfg_registry
    from repro_torch.core.packed import EncodingConfig
    from repro_torch.serving import engine as engine_lib

    cfg = cfg_registry.get_config("llama3.2-1b")
    auto = EncodingConfig(backend="auto", attn_backend="auto")
    params = init_model(cfg, auto, seed, dev)
    rng = np.random.RandomState(seed + 1)
    vocab = cfg.vocab_size
    runs = {}

    def run(label, enc, config, drive):
        eng, runs[label] = counted_run(torch, dev, params, cfg, enc, config, drive, label,
                                       "windows")
        return eng, runs[label]

    # (a) Speculative decode on tiled prompts.
    _, out = run("spec", auto, dict(slots=4, spec_decode=True, draft_k=4),
                 submit_all(tiled_prompts(rng, vocab), 32))
    if not (out["dispatches"].get("verify", 0) > 0 and out["spec"]["proposed"] > 0):
        raise AssertionError(f"spec: no verify dispatch: {out['dispatches']} {out['spec']}")
    log(f"[windows] spec: acceptance {out['spec']['acceptance_rate']:.3f}, "
        f"mean committed per slot step {out['spec']['mean_accepted_len']:.3f}")

    # (b) Token budget 256: three requests decode, then a 900-token prompt
    # is admitted and streams in as chunk rows beside them.
    short = [rng.randint(1, vocab, int(n)).astype(np.int32) for n in rng.randint(64, 161, 3)]
    long_prompt = rng.randint(1, vocab, 900).astype(np.int32)

    def budget_drive(eng):
        for i, p in enumerate(short):
            eng.submit(engine_lib.Request(uid=i, prompt=p, max_new_tokens=64))
        for _ in range(100):
            if all(r is not None and r.generated for r in eng.slot_req[:3]):
                break
            eng.step()
        else:
            raise AssertionError("budget: the three short requests never all decoded")
        if not eng.submit(engine_lib.Request(uid=3, prompt=long_prompt, max_new_tokens=32)):
            raise AssertionError("900-token request rejected")
        return eng.run()

    _, out = run("budget", auto, dict(slots=4, token_budget=256), budget_drive)
    c = out["continuous"]
    if c["decode_stall_steps"] != 0 or c["completed_prefills"] != 4:
        raise AssertionError(f"budget: {c}")
    if out["max_rows"].get("mixed", 0) < 4 * 256:
        raise AssertionError(f"budget: no 256-wide mixed window: {out['max_rows']}")

    # (c) 16 slots under registry routing: 32 requests.
    prompts = [rng.randint(1, vocab, int(n)).astype(np.int32) for n in rng.randint(64, 321, 32)]
    run("slots16", auto, dict(slots=16), submit_all(prompts, 32))

    # (d) backend "pallas": the packed GEMV at decode, the packed GEMM at prefill.
    prompts = [rng.randint(1, vocab, int(n)).astype(np.int32) for n in rng.randint(100, 401, 8)]
    run("packed", EncodingConfig(backend="pallas", attn_backend="auto"), dict(slots=4),
        submit_all(prompts, 32))

    by_kind = runs["spec"]["mmt4d_by_kind"]
    if not (by_kind.get("verify", 0) > 0 and runs["budget"]["mmt4d_by_kind"].get("mixed", 0) > 0
            and runs["slots16"]["mmt4d_by_kind"].get("decode", 0) > 0):
        raise AssertionError("mmt4d did not serve verify, mixed and 16-slot decode dispatches")
    del params
    torch.cuda.empty_cache()
    return runs


def serve(torch, dev, seed: int) -> dict:
    """Phase 4: the main path at full width and depth, bf16."""
    import numpy as np

    from repro_torch.configs import registry as cfg_registry
    from repro_torch.core.packed import EncodingConfig
    from repro_torch.serving import engine as engine_lib
    from repro_torch.serving.config import EngineConfig

    cfg = cfg_registry.get_config("llama3.2-1b")
    enc = EncodingConfig(backend="fused", attn_backend="auto")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = init_model(cfg, enc, seed, dev)
    torch.cuda.synchronize()
    log(f"[serve] init {cfg.name} ({cfg.dtype}) in {time.perf_counter() - t0:.1f}s")
    eng = engine_lib.Engine(params, cfg, enc,
                            config=EngineConfig(slots=4, max_seq=1024, block_size=16),
                            device=dev)
    prompts = shared_prefix_prompts(np.random.RandomState(seed), cfg.vocab_size)
    for i, prompt in enumerate(prompts):
        if not eng.submit(engine_lib.Request(uid=i, prompt=prompt, max_new_tokens=32)):
            raise AssertionError(f"request {i} rejected")

    tally = DispatchTally(eng)
    kernels = kernel_fns()
    for k in kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}

    st = eng.stats
    tokens = sum(len(r.generated) for r in done)
    bad = [(r.uid, r.status, len(r.generated)) for r in done
           if r.status != "ok" or len(r.generated) != 32]
    if len(done) != 8 or bad:
        raise AssertionError(f"requests not all ok with 32 tokens: {bad}")
    eng.audit()
    if st["pages_in_use"] != 0:
        raise AssertionError(f"pages leaked: {st['pages_in_use']} in use after the run")
    if st["degraded"]:
        raise AssertionError(f"kernels quarantined: {st['degraded']}")
    if st["prefix_cache"]["hit_tokens"] <= 0:
        raise AssertionError("no prefix-cache hit")
    disp = st["dispatches"]
    want = {name: tally.want[name] for name in kernels}
    log(f"[serve] launches {launches} expected {want} dispatches {disp}")
    if launches != want:
        raise AssertionError(f"launch counts {launches} != expected {want}")
    wd = st["watchdog"]
    log(f"[serve] 8/8 requests ok, {tokens} tokens in {wall:.3f}s "
        f"({tokens / wall:.1f} tok/s incl. prefill); step p50 {wd['p50_ms']:.3f} ms "
        f"p99 {wd['p99_ms']:.3f} ms; prefix hit_tokens {st['prefix_cache']['hit_tokens']}; "
        f"peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    return {"launches": launches, "dispatches": disp, "tokens": tokens, "wall_s": wall,
            "tok_s": tokens / wall, "step_p50_ms": wd["p50_ms"], "step_p99_ms": wd["p99_ms"],
            "hit_tokens": st["prefix_cache"]["hit_tokens"], "steps": st["steps"]}


def serve_quantized(torch, dev, seed: int) -> dict:
    """Phase 6: full width and depth, bf16 activations, with w8a8 and with
    w4a8 weights quantized on the card: phase 4's 8 shared-prefix requests
    (backend "fused") and phase 5's speculative decode on tiled prompts
    (registry routing), each run's launches equal to its tally."""
    import numpy as np

    from repro_torch.configs import registry as cfg_registry
    from repro_torch.core import targets
    from repro_torch.core.packed import QUANT_KEYS, EncodingConfig
    from repro_torch.models import transformer as T

    cfg = cfg_registry.get_config("llama3.2-1b")
    vocab = cfg.vocab_size
    runs = {}
    for wq in ("int8", "int4"):
        quant = QUANT_KEYS[wq]
        fused = EncodingConfig(backend="fused", attn_backend="auto", weight_quant=wq)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = init_model(cfg, fused, seed, dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        stream = T.decode_weight_stream_bytes(cfg, fused)
        floor_ms = 1e3 * sum(stream.values()) / targets.H100.hbm_bytes_per_s
        log(f"[quant] {quant}: init + quantize on the card {init_s:.1f}s; a decode step "
            f"streams {stream['projections'] / 1e9:.4f} GB of projections + "
            f"{stream['head'] / 1e9:.4f} GB of head (floor {floor_ms:.3f} ms at the "
            f"data-sheet rate)")
        prompts = shared_prefix_prompts(np.random.RandomState(seed), vocab)
        _, out = counted_run(torch, dev, params, cfg, fused, dict(slots=4),
                             submit_all(prompts, 32), f"{quant} phase4", "quant")
        if out["prefix_hit_tokens"] <= 0:
            raise AssertionError(f"{quant} phase4: no prefix-cache hit")
        runs[f"{quant} phase4"] = dict(out, init_s=init_s, stream_bytes=stream,
                                       stream_floor_ms=floor_ms)
        auto = EncodingConfig(backend="auto", attn_backend="auto", weight_quant=wq)
        _, out = counted_run(torch, dev, params, cfg, auto,
                             dict(slots=4, spec_decode=True, draft_k=4),
                             submit_all(tiled_prompts(np.random.RandomState(seed + 1), vocab), 32),
                             f"{quant} spec", "quant")
        if not (out["dispatches"].get("verify", 0) > 0 and out["spec"]["proposed"] > 0):
            raise AssertionError(f"{quant} spec: no verify dispatch: {out['dispatches']}")
        log(f"[quant] {quant} spec: acceptance {out['spec']['acceptance_rate']:.3f}, "
            f"mean committed per slot step {out['spec']['mean_accepted_len']:.3f}")
        runs[f"{quant} spec"] = dict(out, stream_bytes=stream, stream_floor_ms=floor_ms)
        del params
        torch.cuda.empty_cache()
    for name in ("fused_gemv_q8", "mmt4d_q8", "fused_gemv_q4", "mmt4d_q4"):
        if not sum(r["launches"][name] for r in runs.values()):
            raise AssertionError(f"phase 6: {name} never launched")
    return runs


def serve_kv(torch, dev, seed: int) -> dict:
    """Phase 7: full width and depth, bf16, on quantized pools and the dense
    cache: phase 4's 8 shared-prefix requests on bf16 (the reference of this
    call), kv8 and kv4 pools, and the dense cache with vectorized and grouped
    decode; kv8 speculative decode on phase 5's tiled prompts.  Each run's
    launches (per KV layout) equal to its tally."""
    import numpy as np

    from repro_torch.configs import registry as cfg_registry
    from repro_torch.core.packed import EncodingConfig

    cfg = cfg_registry.get_config("llama3.2-1b")
    vocab = cfg.vocab_size
    fused = EncodingConfig(backend="fused", attn_backend="auto")
    params = init_model(cfg, fused, seed, dev)
    runs = {}
    for label, config in (("bf16 phase4", dict(slots=4)),
                          ("kv8 phase4", dict(slots=4, kv_quant="kv8")),
                          ("kv4 phase4", dict(slots=4, kv_quant="kv4")),
                          ("dense phase4", dict(slots=4, cache_mode="dense")),
                          ("grouped phase4", dict(slots=4, decode_mode="grouped"))):
        prompts = shared_prefix_prompts(np.random.RandomState(seed), vocab)
        _, out = counted_run(torch, dev, params, cfg, fused, config, submit_all(prompts, 32),
                             label, "kv")
        if out["cache_mode"] == "paged" and out["prefix_hit_tokens"] <= 0:
            raise AssertionError(f"{label}: no prefix-cache hit")
        log(f"[kv] {label}: {out['kv_quant']} {out['cache_mode']} {out['decode_mode']}, "
            f"{out['kv_bytes_per_token']} pool bytes per cached token, prefix write-skip hit "
            f"tokens {out['prefix_hit_tokens']}")
        runs[label] = out
    auto = EncodingConfig(backend="auto", attn_backend="auto")
    _, out = counted_run(torch, dev, params, cfg, auto,
                         dict(slots=4, spec_decode=True, draft_k=4, kv_quant="kv8"),
                         submit_all(tiled_prompts(np.random.RandomState(seed + 1), vocab), 32),
                         "kv8 spec", "kv")
    if not (out["dispatches"].get("verify", 0) > 0 and out["spec"]["proposed"] > 0):
        raise AssertionError(f"kv8 spec: no verify dispatch: {out['dispatches']}")
    log(f"[kv] kv8 spec: acceptance {out['spec']['acceptance_rate']:.3f}, "
        f"mean committed per slot step {out['spec']['mean_accepted_len']:.3f}")
    runs["kv8 spec"] = out
    del params
    torch.cuda.empty_cache()
    for name in ("paged_decode_attention_kv8", "paged_decode_attention_kv4",
                 "dense_decode_attention"):
        if not sum(r["launches"][name] for r in runs.values()):
            raise AssertionError(f"phase 7: {name} never launched")
    return runs


def serve_sampled(torch, dev, seed: int, sampler: dict) -> dict:
    """Phase 8: full width and depth, bf16, phase 4's 8 shared-prefix
    requests served greedy and with sample="temperature" (0.8 on the even
    requests, 0 on the odd ones), in turns greedy, sampled, sampled, greedy,
    each run's launches equal to its tally.  The temperature-0 requests
    must emit the greedy run's tokens; decode step p50 is reported as a
    multiple of the greedy runs', beside the sampler's launches and device
    busy time a step (phase 2's `sampler`)."""
    import numpy as np

    from repro_torch.configs import registry as cfg_registry
    from repro_torch.core.packed import EncodingConfig
    from repro_torch.serving import engine as engine_lib

    cfg = cfg_registry.get_config("llama3.2-1b")
    fused = EncodingConfig(backend="fused", attn_backend="auto")
    params = init_model(cfg, fused, seed, dev)
    prompts = shared_prefix_prompts(np.random.RandomState(seed), cfg.vocab_size)
    temps = [0.8 if i % 2 == 0 else 0.0 for i in range(len(prompts))]

    def drive(eng):
        for i, (p, t) in enumerate(zip(prompts, temps)):
            if not eng.submit(engine_lib.Request(uid=i, prompt=p, max_new_tokens=32,
                                                 temperature=t)):
                raise AssertionError(f"request {i} rejected")
        return eng.run()

    runs, tokens = {}, {}
    for label, sample in (("greedy A", "greedy"), ("sampled A", "temperature"),
                          ("sampled B", "temperature"), ("greedy B", "greedy")):
        eng, runs[label] = counted_run(torch, dev, params, cfg, fused,
                                       dict(slots=4, sample=sample, seed=seed), drive, label,
                                       "sampled")
        tokens[label] = {r.uid: r.generated for r in eng.finished}
        runs[label]["sample"] = eng.stats["sample"]
        runs[label]["key_draws"] = eng._step_idx
    if tokens["greedy A"] != tokens["greedy B"] or tokens["sampled A"] != tokens["sampled B"]:
        raise AssertionError("phase 8: a repeated run emitted other tokens")
    cold = [i for i, t in enumerate(temps) if t == 0]
    same = all(tokens["sampled A"][i] == tokens["greedy A"][i] for i in cold)
    moved = sum(tokens["sampled A"][i] != tokens["greedy A"][i]
                for i, t in enumerate(temps) if t > 0)
    log(f"[sampled] temperature-0 requests == greedy run's tokens: {same}; {moved} of "
        f"{len(temps) - len(cold)} sampled requests left the greedy stream")
    if not same:
        raise AssertionError("phase 8: temperature-0 requests differ from the greedy run")
    p50 = {k: v["step_ms"]["decode"]["p50_ms"] for k, v in runs.items()}
    for pair in ("A", "B"):
        runs[f"sampled {pair}"]["p50_vs_greedy"] = p50[f"sampled {pair}"] / p50[f"greedy {pair}"]
    log(f"[sampled] decode p50 sampled / greedy: A {runs['sampled A']['p50_vs_greedy']:.3f}, "
        f"B {runs['sampled B']['p50_vs_greedy']:.3f}; key draws per run "
        f"{runs['sampled A']['key_draws']} (one per decode dispatch); the sampler adds "
        f"{sampler['launches']} launches and {sampler['busy_ms']} ms of device busy time a "
        f"step (phase 2)")
    del params
    torch.cuda.empty_cache()
    return runs


DENSE_FAMILY = ("qwen2-1.5b", "qwen2.5-14b", "qwen2.5-32b", "yi-9b")


def randomize_biases(torch, params, seed: int) -> None:
    """Set every QKV bias of `params` (zero after model_init, as in JAX) to
    N(0, 0.5^2) from `seed`, so that a dropped or misplaced bias changes
    the tokens."""
    gen = torch.Generator(device=params["embed"].device).manual_seed(seed)
    for layer in params["layers"]:
        for proj in layer["attn"].values():
            if "b" in proj:
                b = torch.randn(proj["b"].shape, generator=gen, device=proj["b"].device)
                proj["b"].copy_(0.5 * b)


def dense_family_forward_check(torch, dev, seed: int) -> dict:
    """Phase 3, the dense family: each of Qwen2-1.5B, Qwen2.5-14B/32B and
    Yi-9B at full width, depth 2, f32, with nonzero QKV biases (and the
    untied heads of Qwen2.5 and Yi through the packed projections),
    served through the kernels (backend "fused", then registry routing with
    spec decode) and through the plain backends: identical tokens."""
    import numpy as np

    from repro_torch.configs import registry as cfg_registry
    from repro_torch.core.packed import EncodingConfig
    from repro_torch.serving import engine as engine_lib
    from repro_torch.serving.config import EngineConfig

    outs = {}
    for arch in DENSE_FAMILY:
        cfg = dataclasses.replace(cfg_registry.get_config(arch), num_layers=2, dtype="float32")
        params = init_model(cfg, EncodingConfig(), seed, dev)
        randomize_biases(torch, params, seed + 7)
        rng = np.random.RandomState(seed + 5)
        prompts = [np.tile(rng.randint(1, cfg.vocab_size, 16), 12)[:n].astype(np.int32)
                   for n in (80, 144)]
        prompts += [rng.randint(1, cfg.vocab_size, n).astype(np.int32) for n in (100, 37, 250)]
        got = {}
        for label, enc, config in (
                ("plain", EncodingConfig(backend="reference", attn_backend="xla"), {}),
                ("kernels", EncodingConfig(backend="fused", attn_backend="auto"), {}),
                ("spec", EncodingConfig(backend="auto", attn_backend="auto"),
                 dict(spec_decode=True, draft_k=4))):
            eng = engine_lib.Engine(params, cfg, enc, device=dev, config=EngineConfig(
                slots=4, max_seq=512, block_size=16, **config))
            for i, p in enumerate(prompts):
                eng.submit(engine_lib.Request(uid=i, prompt=p, max_new_tokens=8))
            got[label] = {r.uid: r.generated for r in eng.run()}
            st = eng.stats
            if st["pages_in_use"] or st["degraded"] or len(got[label]) != len(prompts):
                raise AssertionError(f"{arch} {label}: pages {st['pages_in_use']} degraded "
                                     f"{st['degraded']}")
            if config and not st["spec"]["proposed"]:
                raise AssertionError(f"{arch} spec: no drafts verified")
        same = got["kernels"] == got["plain"] and got["spec"] == got["plain"]
        log(f"[forward] {arch} depth-2 f32 full width (G={cfg.gqa_groups}, D={cfg.head_dim}, "
            f"bias {cfg.qkv_bias}, tied head {cfg.tie_embeddings}): kernel and spec tokens == "
            f"plain tokens: {same}")
        if not same:
            raise AssertionError(f"{arch}: tokens differ: {got}")
        outs[arch] = got["plain"]
        del params
        torch.cuda.empty_cache()
    return outs


def serve_dense_family(torch, dev, seed: int) -> dict:
    """Phase 9: Qwen2-1.5B at full width and depth (28 layers), bf16, with
    nonzero QKV biases: phase 4's 8 shared-prefix requests (backend
    "fused"), phase 5's speculative decode on tiled prompts (registry
    routing) and phase 4's trace with w8a8 weights, each run's launches
    equal to its tally (layers from the config)."""
    import numpy as np

    from repro_torch.configs import registry as cfg_registry
    from repro_torch.core.packed import EncodingConfig

    cfg = cfg_registry.get_config("qwen2-1.5b")
    runs = {}
    for wq in ("none", "int8"):
        fused = EncodingConfig(backend="fused", attn_backend="auto", weight_quant=wq)
        params = init_model(cfg, fused, seed, dev)
        randomize_biases(torch, params, seed + 7)
        tag = "bf16" if wq == "none" else "w8a8"
        prompts = shared_prefix_prompts(np.random.RandomState(seed), cfg.vocab_size)
        _, out = counted_run(torch, dev, params, cfg, fused, dict(slots=4),
                             submit_all(prompts, 32), f"{cfg.name} {tag} phase4", "dense")
        if out["prefix_hit_tokens"] <= 0:
            raise AssertionError(f"{cfg.name} {tag} phase4: no prefix-cache hit")
        runs[f"{tag} phase4"] = out
        if wq == "none":
            auto = EncodingConfig(backend="auto", attn_backend="auto")
            _, out = counted_run(torch, dev, params, cfg, auto,
                                 dict(slots=4, spec_decode=True, draft_k=4),
                                 submit_all(tiled_prompts(np.random.RandomState(seed + 1),
                                                          cfg.vocab_size), 32),
                                 f"{cfg.name} bf16 spec", "dense")
            if not (out["dispatches"].get("verify", 0) > 0 and out["spec"]["proposed"] > 0):
                raise AssertionError(f"{cfg.name} spec: no verify dispatch: {out['dispatches']}")
            log(f"[dense] {cfg.name} spec: acceptance {out['spec']['acceptance_rate']:.3f}, "
                f"mean committed per slot step {out['spec']['mean_accepted_len']:.3f}")
            runs["bf16 spec"] = out
        del params
        torch.cuda.empty_cache()
    return runs


def moe_prompts(rng, vocab: int) -> list:
    """Phase 11's trace (phase 3 serves it too): 8 prompts of 100-500
    tokens, then one of MOE_LONG_PROMPT tokens, longer than Mixtral's 4096
    window and not a multiple of it."""
    import numpy as np

    prompts = [rng.randint(1, vocab, int(n)).astype(np.int32) for n in rng.randint(100, 501, 8)]
    return prompts + [rng.randint(1, vocab, MOE_LONG_PROMPT).astype(np.int32)]


def moe_forward_check(torch, dev, seed: int) -> dict:
    """Phase 3, Mixtral-8x22B at full width, depth 2, f32 (8 experts, top-2,
    capacity 1.25, window 4096 on a 4096-slot ring, max_seq 8192): phase
    11's trace with 8 new tokens a request, served through the kernels and
    through the plain backends in the same engine configuration, since MoE
    capacity drops depend on the batch: phase-split (backend "fused"),
    backend "pallas", grouped decode and 12 slots (the attention projections
    take the packed GEMM there) against backend "reference" with the plain
    attention; then int8 and int4 weights (backend "fused" against the
    plain quantized projections, "xla", both on the attention kernels).
    Every pair must emit identical tokens, the 4500-token prompt included."""
    import numpy as np

    from repro_torch.configs import registry as cfg_registry
    from repro_torch.core.packed import EncodingConfig
    from repro_torch.serving import engine as engine_lib
    from repro_torch.serving.config import EngineConfig

    cfg = dataclasses.replace(cfg_registry.get_config("mixtral-8x22b"), num_layers=2,
                              dtype="float32")
    prompts = moe_prompts(np.random.RandomState(seed + 11), cfg.vocab_size)
    plain = EncodingConfig(backend="reference", attn_backend="xla")
    outs = {}

    def serve_tokens(params, enc, config):
        eng = engine_lib.Engine(params, cfg, enc, device=dev,
                                config=EngineConfig(max_seq=8192, **config))
        for i, p in enumerate(prompts):
            if not eng.submit(engine_lib.Request(uid=i, prompt=p, max_new_tokens=8)):
                raise AssertionError(f"request {i} rejected")
        done = eng.run()
        st = eng.stats
        if st["cache_mode"] != "dense" or st["degraded"] or any(
                r.status != "ok" or len(r.generated) != 8 for r in done):
            raise AssertionError(f"mixtral {config}: {st['cache_mode']} {st['degraded']} "
                                 f"{[(r.uid, r.status) for r in done]}")
        return {r.uid: r.generated for r in done}, st["dispatches"]

    cases = [
        ("phase-split", "none", EncodingConfig(backend="fused", attn_backend="auto"), plain,
         dict(slots=4)),
        ("pallas", "none", EncodingConfig(backend="pallas", attn_backend="auto"), plain,
         dict(slots=4)),
        ("grouped", "none", EncodingConfig(backend="fused", attn_backend="auto"), plain,
         dict(slots=4, decode_mode="grouped")),
        ("slots12", "none", EncodingConfig(backend="auto", attn_backend="auto"), plain,
         dict(slots=12)),
    ]
    for wq in ("int8", "int4"):
        cases.append((f"{wq} phase-split", wq,
                      EncodingConfig(backend="fused", attn_backend="auto", weight_quant=wq),
                      EncodingConfig(backend="xla", attn_backend="auto", weight_quant=wq),
                      dict(slots=4)))
    params, made = None, None
    plain_runs: dict = {}
    for label, wq, enc, ref_enc, config in cases:
        if made != wq:
            del params
            torch.cuda.empty_cache()
            params, made = init_model(cfg, EncodingConfig(weight_quant=wq), seed, dev), wq
        t0 = time.perf_counter()
        key = (wq, ref_enc.backend, tuple(sorted(config.items())))
        if key not in plain_runs:
            plain_runs[key] = serve_tokens(params, ref_enc, config)[0]
        t1 = time.perf_counter()
        got, disp = serve_tokens(params, enc, config)
        same = got == plain_runs[key]
        log(f"[forward] mixtral-8x22b depth-2 f32 {label}: kernel tokens == plain tokens "
            f"(prompts {[len(p) for p in prompts]}, dispatches {disp}; plain "
            f"{t1 - t0:.1f}s, kernels {time.perf_counter() - t1:.1f}s): {same}")
        if not same:
            raise AssertionError(f"mixtral {label}: tokens differ: {got} vs {plain_runs[key]}")
        outs[label] = got
    del params
    torch.cuda.empty_cache()
    return outs


def serve_moe(torch, dev, seed: int) -> dict:
    """Phase 11: Mixtral-8x22B at full width and depth 8 of 56 in bf16 (the
    depth cut: 56 layers hold 282 GB of bf16 weights, 141 GB in int8, one
    card 80 GB), 4 slots, max_seq 8192 (a 4096-slot ring a layer): phase
    11's trace of 9 requests, 32 new tokens each, with bf16 and with w8a8
    weights (backend "fused"), each run's launches equal to its tally.
    Reports tokens/s, step p50/p99 by kind, peak memory and the weight bytes
    a decode step streams."""
    import numpy as np

    from repro_torch.configs import registry as cfg_registry
    from repro_torch.core import targets
    from repro_torch.core.packed import QUANT_KEYS, EncodingConfig
    from repro_torch.models import transformer as T

    full = cfg_registry.get_config("mixtral-8x22b")
    cfg = dataclasses.replace(full, num_layers=8)
    reduced = [f"depth cut to {cfg.num_layers} of {full.num_layers} layers (full width): one "
               "card holds 80 GB"]
    runs = {}
    for wq in ("none", "int8"):
        quant = QUANT_KEYS[wq]
        tag = "bf16" if wq == "none" else quant
        enc = EncodingConfig(backend="fused", attn_backend="auto", weight_quant=wq)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = init_model(cfg, enc, seed, dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        weights_gib = torch.cuda.memory_allocated(dev) / 2**30
        stream = T.decode_weight_stream_bytes(cfg, enc)
        floor_ms = 1e3 * sum(stream.values()) / targets.H100.hbm_bytes_per_s
        log(f"[moe] {cfg.name} depth {cfg.num_layers} {tag}: init {init_s:.1f}s, "
            f"{weights_gib:.2f} GiB on the card; a decode step streams "
            f"{stream['projections'] / 1e9:.3f} GB of projections (router and all "
            f"{cfg.num_experts} experts) + {stream['head'] / 1e9:.3f} GB of head: floor "
            f"{floor_ms:.3f} ms at the data-sheet rate; reduced: {reduced}")
        prompts = moe_prompts(np.random.RandomState(seed + 11), cfg.vocab_size)
        eng, out = counted_run(torch, dev, params, cfg, enc, dict(slots=4, max_seq=8192),
                               submit_all(prompts, 32), f"{cfg.name} {tag} trace", "moe")
        out["tokens_by_uid"] = {r.uid: list(r.generated) for r in eng.finished}
        del eng
        if out["cache_mode"] != "dense" or out["max_rows"].get("prefill", 0) < MOE_LONG_PROMPT:
            raise AssertionError(f"{tag}: not the ring or no long prefill: {out}")
        runs[f"{tag} trace"] = dict(out, init_s=init_s, weights_gib=weights_gib,
                                    stream_bytes=stream, stream_floor_ms=floor_ms,
                                    layers=cfg.num_layers, reduced=reduced)
        del params
        torch.cuda.empty_cache()
    return runs


def recurrent_prompts(rng, vocab: int) -> list:
    """Phase 12's trace (phase 3 serves it too): 8 prompts of 100-500
    tokens, then one of RECURRENT_LONG_PROMPT tokens, longer than
    RecurrentGemma's 2048-token window and not a multiple of it."""
    import numpy as np

    prompts = [rng.randint(1, vocab, int(n)).astype(np.int32) for n in rng.randint(100, 501, 8)]
    return prompts + [rng.randint(1, vocab, RECURRENT_LONG_PROMPT).astype(np.int32)]


def recurrent_forward_check(torch, dev, seed: int) -> dict:
    """Phase 3, the recurrent families and Grok-1 at full width, f32, each
    through the kernels (backend "fused", attention "auto") and through the
    plain backends ("reference", "xla") in the same engine configuration:
    RWKV6-1.6B at depth 2 and RecurrentGemma-9B at depth 3 (one rec, rec,
    attn group), 4 slots (dense, grouped: resolve()), max_seq 4096, phase
    12's 9 requests (the 2500-token one past the window), 8 new tokens, so
    every slot is reused; Grok-1-314B at depth 1 on the paged cache (4
    slots, phase 4's trace), and with spec decode (backend "auto", phase
    5's tiled prompts).  Every pair must emit identical tokens."""
    import numpy as np

    from repro_torch.configs import registry as cfg_registry
    from repro_torch.core.packed import EncodingConfig
    from repro_torch.serving import engine as engine_lib
    from repro_torch.serving.config import EngineConfig

    plain = EncodingConfig(backend="reference", attn_backend="xla")
    outs = {}

    def serve_tokens(params, cfg, enc, config, prompts):
        eng = engine_lib.Engine(params, cfg, enc, device=dev, config=EngineConfig(**config))
        for i, p in enumerate(prompts):
            if not eng.submit(engine_lib.Request(uid=i, prompt=p, max_new_tokens=8)):
                raise AssertionError(f"{cfg.name}: request {i} rejected")
        done = eng.run()
        st = eng.stats
        if st["degraded"] or any(r.status != "ok" or len(r.generated) != 8 for r in done):
            raise AssertionError(f"{cfg.name} {config}: {st['degraded']} "
                                 f"{[(r.uid, r.status) for r in done]}")
        return {r.uid: r.generated for r in done}, st

    cases = [("rwkv6-1.6b", 2, "kernels", EncodingConfig(backend="fused", attn_backend="auto"),
              dict(slots=4, max_seq=4096), "trace"),
             ("recurrentgemma-9b", 3, "kernels",
              EncodingConfig(backend="fused", attn_backend="auto"), dict(slots=4, max_seq=4096),
              "trace"),
             ("grok-1-314b", 1, "paged", EncodingConfig(backend="fused", attn_backend="auto"),
              dict(slots=4, max_seq=1024, block_size=16), "shared"),
             ("grok-1-314b", 1, "spec", EncodingConfig(backend="auto", attn_backend="auto"),
              dict(slots=4, max_seq=1024, block_size=16, spec_decode=True, draft_k=4), "tiled")]
    params, made = None, None
    for arch, depth, label, enc, config, trace in cases:
        cfg = dataclasses.replace(cfg_registry.get_config(arch), num_layers=depth,
                                  dtype="float32")
        if made != arch:
            del params
            torch.cuda.empty_cache()
            params, made = init_model(cfg, EncodingConfig(), seed, dev), arch
        rng = np.random.RandomState(seed + 12)
        prompts = {"trace": recurrent_prompts, "shared": shared_prefix_prompts,
                   "tiled": tiled_prompts}[trace](rng, cfg.vocab_size)
        t0 = time.perf_counter()
        want, pst = serve_tokens(params, cfg, plain, config, prompts)
        t1 = time.perf_counter()
        got, st = serve_tokens(params, cfg, enc, config, prompts)
        same = got == want
        log(f"[forward] {arch} depth-{depth} f32 {label}: kernel tokens == plain tokens "
            f"(prompts {[len(p) for p in prompts]}, {st['cache_mode']} {st['decode_mode']}, "
            f"dispatches {st['dispatches']}; plain {t1 - t0:.1f}s, kernels "
            f"{time.perf_counter() - t1:.1f}s): {same}")
        if not same:
            raise AssertionError(f"{arch} {label}: tokens differ: {got} vs {want}")
        if arch != "grok-1-314b" and (st["cache_mode"], st["decode_mode"]) != ("dense",
                                                                                "grouped"):
            raise AssertionError(f"{arch}: resolved to {st['cache_mode']} {st['decode_mode']}")
        if label == "spec" and not (st["spec"]["proposed"] > 0
                                    and st["dispatches"].get("verify", 0) > 0):
            raise AssertionError(f"grok spec: no drafts verified: {st['spec']}")
        outs[f"{arch} {label}"] = got
    del params
    torch.cuda.empty_cache()
    return outs


def recurrence_share(torch, dev, params, cfg, enc, prompt) -> dict:
    """Host-clock ms of one prefill of `prompt` (a fresh one-slot cache; the
    card synchronized before and after), and of the plain recurrences
    inside it: RWKV's chunked wkv loop (S / 16 iterations a layer) or the
    RG-LRU's associative scan, each call bracketed by synchronizations (so
    the total here runs a little slower than unbracketed), beside the
    prefill's unbracketed time."""
    from repro_torch.core.encoding import Phase
    from repro_torch.models import recurrent as R
    from repro_torch.models import transformer as T

    name = "_wkv_chunked" if "rwkv" in cfg.block_pattern else "associative_scan"
    toks = torch.as_tensor(prompt[None], device=dev)

    def prefill():
        caches = T.cache_init(cfg, 1, len(prompt), device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        T.forward(params, toks, cfg=cfg, enc=enc, phase=Phase.PREFILL, caches=caches,
                  last_logits_only=True)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    prefill()  # warm
    plain_ms = prefill()
    inner = {"ms": 0.0, "calls": 0}
    orig = getattr(R, name)

    def timed(*a):
        if name == "associative_scan" and inner.get("depth"):
            return orig(*a)  # the scan's own recursion: timed at the top call
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inner["depth"] = 1
        try:
            out = orig(*a)
            torch.cuda.synchronize()
        finally:
            inner["depth"] = 0
        inner["ms"] += 1e3 * (time.perf_counter() - t0)
        inner["calls"] += 1
        return out

    setattr(R, name, timed)
    try:
        bracketed_ms = prefill()
    finally:
        setattr(R, name, orig)
    out = {"recurrence": name, "prompt": len(prompt), "prefill_ms": plain_ms,
           "bracketed_prefill_ms": bracketed_ms, "recurrence_ms": inner["ms"],
           "recurrence_calls": inner["calls"], "share": inner["ms"] / bracketed_ms}
    if name == "_wkv_chunked":
        out["chunk_iterations_a_layer"] = -(-len(prompt) // R.RWKV_CHUNK)
    log(f"[recurrent] {cfg.name}: a {len(prompt)}-token prefill takes {plain_ms:.1f} ms; "
        f"with each {name} call bracketed by syncs {bracketed_ms:.1f} ms, of which "
        f"{name} {inner['ms']:.1f} ms over {inner['calls']} calls (share {out['share']:.3f})")
    return out


def serve_recurrent(torch, dev, seed: int) -> dict:
    """Phase 12: RWKV6-1.6B (24 layers) and RecurrentGemma-9B (38 layers) at
    full width and full depth in bf16, 4 slots, max_seq 4096 (dense cache,
    grouped decode, one prefill an admission: resolve()), phase 12's 9
    requests with 32 new tokens; then Grok-1-314B at full width and depth 4
    of 64 in bf16 (the cut: 64 layers hold ~620 GB, one card 80 GB), paged,
    4 slots, phase 4's trace, and with spec decode (backend "auto") on phase
    5's tiled prompts.  Each run's launches equal its tally (by layer type
    too).  Reports tokens/s, step p50/p99 by kind, the weight bytes a decode
    step streams and the cache bytes a slot holds (K/V rows and state), and
    for the recurrent families the share of a 2500-token prefill spent in
    the plain recurrence (recurrence_share)."""
    import numpy as np

    from repro_torch.configs import registry as cfg_registry
    from repro_torch.core import targets
    from repro_torch.core.packed import EncodingConfig
    from repro_torch.models import transformer as T

    runs = {}
    fused = EncodingConfig(backend="fused", attn_backend="auto")
    plan = [("rwkv6-1.6b", None, [("trace", fused, dict(slots=4, max_seq=4096), "trace")]),
            ("recurrentgemma-9b", None,
             [("trace", fused, dict(slots=4, max_seq=4096), "trace")]),
            ("grok-1-314b", 4,
             [("trace", fused, dict(slots=4), "shared"),
              ("spec", EncodingConfig(backend="auto", attn_backend="auto"),
               dict(slots=4, spec_decode=True, draft_k=4), "tiled")])]
    for arch, depth, served in plan:
        full = cfg_registry.get_config(arch)
        cfg = full if depth is None else dataclasses.replace(full, num_layers=depth)
        reduced = ([] if depth is None else
                   [f"depth cut to {depth} of {full.num_layers} layers (full width): one card "
                    "holds 80 GB"])
        gc.collect()  # earlier phases' engines sit in reference cycles
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        params = init_model(cfg, fused, seed, dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        weights_gib = (torch.cuda.memory_allocated(dev) - before) / 2**30
        stream = T.decode_weight_stream_bytes(cfg, fused)
        floor_ms = 1e3 * sum(stream.values()) / targets.H100.hbm_bytes_per_s
        log(f"[recurrent] {cfg.name} depth {cfg.num_layers} bf16: init {init_s:.1f}s, "
            f"{weights_gib:.2f} GiB on the card; a decode step streams "
            f"{stream['projections'] / 1e9:.3f} GB of projections + {stream['head'] / 1e9:.3f} "
            f"GB of head: floor {floor_ms:.3f} ms at the data-sheet rate; reduced: {reduced}")
        for label, enc, config, trace in served:
            rng = np.random.RandomState(seed + 12)
            prompts = {"trace": recurrent_prompts, "shared": shared_prefix_prompts,
                       "tiled": tiled_prompts}[trace](rng, cfg.vocab_size)
            eng, out = counted_run(torch, dev, params, cfg, enc, config,
                                   submit_all(prompts, 32), f"{cfg.name} bf16 {label}",
                                   "recurrent")
            if arch != "grok-1-314b" and (
                    (out["cache_mode"], out["decode_mode"]) != ("dense", "grouped")
                    or out["max_rows"].get("prefill", 0) < RECURRENT_LONG_PROMPT):
                raise AssertionError(f"{arch}: not dense grouped or no long prefill: {out}")
            if arch == "grok-1-314b" and (out["cache_mode"] != "paged" or (
                    label == "spec" and not out["dispatches"].get("verify", 0))):
                raise AssertionError(f"grok {label}: not paged or no verify window: {out}")
            log(f"[recurrent] {cfg.name} {label}: cache bytes a slot "
                f"{out['cache_bytes_per_slot']}; launches by layer type "
                f"{out['launches_by_layer_type']}")
            runs[f"{arch} {label}"] = dict(out, init_s=init_s, weights_gib=weights_gib,
                                           stream_bytes=stream, stream_floor_ms=floor_ms,
                                           layers=cfg.num_layers, reduced=reduced)
            del eng
            if arch != "grok-1-314b":
                runs[f"{arch} {label}"]["recurrence"] = recurrence_share(
                    torch, dev, params, cfg, enc, prompts[-1])
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return runs


# Whisper-tiny (enc-dec) and InternVL2-26B (VLM): the K x N of their
# projections with the rows phase 13 gives each.  Whisper: q/k/v/o 384 x
# 384, up 384 x 1536, down 1536 x 384 at 1 and 4 decode rows (fused_gemv)
# and at the encoder's 4 x 1500 rows and a 4 x 64 decoder prefill
# (fused_pack_mmt4d); its untied head 384 x 51865 at 1 and 4 decode rows and
# at the prefill's 4 logit rows.  InternVL: q/o 6144 x 6144, k/v 6144 x
# 1024, gate/up 6144 x 16384, down 16384 x 6144 at 1, 4 and a 4 x (256 +
# 500)-row prefill; the head 6144 x 92553 at 1, 4 and 4 prefill rows; the
# projector's fc1 3200 x 6144 and fc2 at its 4 x 256 patch rows.
# (K, N, decode rows, prefill rows) per model.
ENCDEC_VLM_KN = {
    "whisper": [(384, 384, (1, 4), (256, 6000)), (384, 1536, (1, 4), (256, 6000)),
                (1536, 384, (1, 4), (256, 6000)), (384, 51865, (1, 4), (4,))],
    "internvl": [(6144, 6144, (1, 4), (1024, 3024)), (6144, 1024, (1, 4), (3024,)),
                 (6144, 16384, (1, 4), (3024,)), (16384, 6144, (1, 4), (3024,)),
                 (6144, 92553, (1, 4), (4,)), (3200, 6144, (), (1024,))],
}
WHISPER_PROMPTS = (4, 64)     # text prompt lengths, with 1500 frames
INTERNVL_PROMPTS = (100, 500)  # text after 256 patches
WHISPER_MAX_SEQ = 448          # Whisper's decoder context


# Tensor-parallel shard shapes (phase 15): each rank's projections and
# attention heads.  Llama-3.2-1B at tp = 2: q 2048 -> 1024, k/v 2048 -> 256,
# o 1024 -> 2048, gate/up 2048 -> 4096, down 4096 -> 2048, attention 16 query
# and 4 kv heads at D = 64; Yi-9B at tp = 4: q 4096 -> 1024, k/v 4096 -> 128,
# o 1024 -> 4096, gate/up 4096 -> 2752, down 2752 -> 4096, its head 4096 ->
# 16000 vocabulary rows, attention 8 query heads on one kv head at D = 128.
# An expert of Mixtral-8x22B at tp = 2 (Grok-1-314B's at tp = 4: the same
# shapes): w_gate/w_up 6144 -> 8192, w_down 8192 -> 6144; Mixtral's at tp =
# 4: 6144 -> 4096, 4096 -> 6144 (Grok's at tp = 2, 6144 -> 16384 and 16384
# -> 6144, are Mixtral's whole experts: check_moe_shapes).
TP_SHAPES = {
    "llama tp2": dict(kn=((2048, 1024), (2048, 256), (1024, 2048), (2048, 4096), (4096, 2048)),
                      heads=(16, 4), d=64),
    "yi tp4": dict(kn=((4096, 1024), (4096, 128), (1024, 4096), (4096, 2752), (2752, 4096),
                       (4096, 16000)),
                   heads=(8, 1), d=128),
    "mixtral tp2 / grok tp4 expert": dict(kn=((6144, 8192), (8192, 6144))),
    "mixtral tp4 expert": dict(kn=((6144, 4096), (4096, 6144))),
}


def check_tp_shapes(torch, dev, target, timer, results: dict) -> None:
    """Phase 2, the kernels at the tensor-parallel shard shapes (TP_SHAPES),
    each against its plain version with its bound and library time: bf16
    fused_gemv (4 decode rows) and fused_pack_mmt4d (2048 prefill rows)
    with matmul as the yardstick, w8a8 fused_gemv_q8 and w4a8 g16
    fused_gemv_q4 at 4 rows bit for bit; paged decode at the shard's heads
    (B = 4, L = 1, pos {37, 300, 511, 900}) on bf16, kv8 and kv4 pools and
    flash prefill (bf16, B = 4, 512 x 512), SDPA the yardstick, where the
    entry names heads (the MoE experts' entries are projections only).  A K
    that is no multiple of 128 (Yi's 2752 FFN columns a rank) is
    zero-padded on the rows as kernels/ops.py pads them."""
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.kernels import attn, fused_gemv, fused_pack_mmt4d, mmt4d_q4, ops, ref

    gen = torch.Generator(device=dev).manual_seed(15)

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(torch.bfloat16)

    def check(name, key, fn, plain, *, exact, library_ms, bytes_moved, flops, dname):
        got, want = fn(), plain()
        err = (got - want).abs().max().item()
        if exact and not torch.equal(got, want):
            raise AssertionError(f"{name} {key}: not equal to its plain version bit for bit "
                                 f"(max abs error {err})")
        add_row(results, target, name, key, err=err, tol=0.0 if exact else 1e-3,
                ms=timer.ms(fn), plain_ms=timer.ms(plain, iters=3, warmup=1),
                library_ms=library_ms, bytes_moved=bytes_moved, flops=flops, dname=dname)

    b, bs, pages = 4, 16, 257
    pos_list = [37, 300, 511, 900]
    pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
    rng = np.random.RandomState(15)
    table = torch.from_numpy(np.stack([rng.permutation(pages - 1)[:64] + 1 for _ in range(b)])
                             .astype(np.int32)).to(dev)
    for label, shape in TP_SHAPES.items():
        for k, n in shape["kn"]:
            w_t = rnd(n, k, scale=k**-0.5)
            rhs4 = ref.pack(w_t, (128, 128))
            tag = f"{label} K={k} N={n}"
            kp = rhs4.shape[1] * 128
            for m in (4, 2048):
                x0 = rnd(m, k)
                x = F.pad(x0, (0, kp - k))
                kw = dict(exact=False, library_ms=timer.ms(lambda: torch.matmul(x0, w_t.t())),
                          bytes_moved=(m * k + n * k) * 2 + m * n * 4, flops=2 * m * n * k,
                          dname="bf16")
                if m == 4:
                    check("fused_gemv", f"{tag} bf16 M={m}",
                          lambda: fused_gemv.fused_gemv(x, rhs4),
                          lambda: fused_gemv.fused_gemv_plain(x, rhs4), **kw)
                else:
                    check("fused_pack_mmt4d", f"{tag} bf16 M={m}",
                          lambda: fused_pack_mmt4d.fused_pack_mmt4d(x, rhs4),
                          lambda: fused_pack_mmt4d.fused_pack_mmt4d_plain(x, rhs4), **kw)
            del rhs4
            rhs4_q, s_w = ops.pack_rhs_q8(w_t)
            w_q = ref.unpack(rhs4_q, (n, kp)).contiguous()
            xq, s_a = ref.quantize_rows(F.pad(rnd(4, k), (0, kp - k)))
            sa1 = s_a[:, None]
            check("fused_gemv_q8", f"{tag} w8a8 M=4",
                  lambda: fused_gemv.fused_gemv_q8(xq, rhs4_q, sa1, s_w),
                  lambda: fused_gemv.fused_gemv_q8_plain(xq, rhs4_q, sa1, s_w), exact=True,
                  library_ms=int_mm_time(torch, timer, xq, w_q, s_a, s_w.reshape(-1)[:n]),
                  bytes_moved=4 * k + n * k + 16 + n * 4 + 4 * n * 4, flops=8 * n * k,
                  dname="int8")
            del rhs4_q, w_q
            rhs4_p, s_w4 = ops.pack_rhs_q4(w_t, group=16)
            check("fused_gemv_q4", f"{tag} w4a8 g16 M=4",
                  lambda: mmt4d_q4.fused_gemv_q4(xq, rhs4_p, sa1, s_w4, 16),
                  lambda: mmt4d_q4.fused_gemv_q4_plain(xq, rhs4_p, sa1, s_w4, 16), exact=True,
                  library_ms=None,
                  bytes_moved=4 * k + n * k // 2 + n * (k // 16) * 2 + 16 + 4 * n * 4,
                  flops=8 * n * k, dname="int8")
            del rhs4_p, s_w4, w_t
        if "heads" not in shape:
            continue
        h, kvh = shape["heads"]
        d = shape["d"]
        g = h // kvh
        live = max(pos_list) + 1
        keys = sum(p + 1 for p in pos_list)
        for kv in ("bf16", "kv8", "kv4"):
            name = "paged_decode_attention" + ("" if kv == "bf16" else f"_{kv}")
            k_pool, k_sc = kv_data(torch, gen, kv, torch.bfloat16, pages, bs, kvh, d)
            v_pool, v_sc = kv_data(torch, gen, kv, torch.bfloat16, pages, bs, kvh, d)
            kw = dict(k_scale=k_sc, v_scale=v_sc, kv_quant=kv)
            q = rnd(b, 1, h, d)
            k_view, v_view = (kv_dequant(kv, attn.paged_gather(x, table)[:, :live],
                                         None if sc is None else
                                         attn.paged_gather(sc, table)[:, :live])
                              for x, sc in ((k_pool, k_sc), (v_pool, v_sc)))
            valid = decode_valid(torch, pos, 1, live)
            attn_row(torch, timer, results, target, name,
                     f"{label} {'' if kv == 'bf16' else kv + ' '}bf16 D={d} H={h} KV={kvh} "
                     f"B={b} L=1",
                     lambda: attn.paged_decode_attention(q, k_pool, v_pool, table, pos, **kw),
                     lambda: attn.paged_decode_attention_plain(q, k_pool, v_pool, table, pos,
                                                               **kw),
                     q=q, k=k_view, v=v_view, valid=valid,
                     library_ms=timer.ms(sdpa_call(torch, q, k_view, v_view, valid[:, None], g)),
                     bytes_moved=2 * b * h * d * 2 + 2 * keys * kvh * kv_row_bytes(kv, d, 2)
                     + b * 64 * 4 + b * 4,
                     flops=4 * h * d * keys, dname="bf16", plain_iters=3)
            del k_pool, v_pool, k_sc, v_sc
        sq = 512
        q, kp, vp = rnd(b, sq, h, d), rnd(b, sq, kvh, d), rnd(b, sq, kvh, d)
        mask = torch.arange(sq, device=dev)[None, :] <= torch.arange(sq, device=dev)[:, None]
        attn_row(torch, timer, results, target, "flash_prefill_attention",
                 f"{label} bf16 D={d} H={h} KV={kvh} B={b} Sq={sq} Sk={sq} q_offset=0",
                 lambda: attn.flash_prefill_attention(q, kp, vp),
                 lambda: attn.flash_prefill_attention_plain(q, kp, vp),
                 q=q, k=kp, v=vp, valid=mask[None].expand(b, -1, -1),
                 library_ms=timer.ms(sdpa_call(torch, q, kp, vp, mask[None, None], g)),
                 bytes_moved=(2 * b * sq * h * d + 2 * b * sq * kvh * d) * 2,
                 flops=4 * b * h * d * int(mask.sum().item()), dname="bf16", plain_iters=3)
        del q, kp, vp
        torch.cuda.empty_cache()
    torch.cuda.synchronize()


def check_encdec_vlm_shapes(torch, dev, target, timer, results: dict) -> None:
    """Phase 2, the shapes Whisper-tiny and InternVL2-26B give the kernels:
    flash prefill with causal=False (never run causally off in a serving
    path before) at Whisper's encoder (B = 4, Sq = Sk = 1500: a partial last
    key tile, H = KV = 6, G = 1, D = 64) and as cross attention (Sq = 64
    and 448 over Sk = 1500); the dense decode over a 1500-row cross cache at
    pos = 1499 (every key, G = 1) and InternVL's self decode (D = 128, G =
    6, S_c = 1024); bf16 element by element to bf16_attn_limit, f32 to 1e-4,
    SDPA without a mask (or with the decode's) as the library time.  Then
    the projections (ENCDEC_VLM_KN) in bf16, to 1e-3, matmul as the library
    time."""
    from repro_torch.kernels import attn, fused_gemv, fused_pack_mmt4d, ref

    gen = torch.Generator(device=dev).manual_seed(13)

    def rnd(*shape, scale=1.0, dt=torch.bfloat16):
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(dt)

    b, h, d, te = 4, 6, 64, 1500
    for dname, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        s = 2 if dname == "bf16" else 4
        k, v = rnd(b, te, h, d, dt=dt), rnd(b, te, h, d, dt=dt)
        for sq in (te, 64, 448):
            q = rnd(b, sq, h, d, dt=dt)
            what = "encoder" if sq == te else "cross"
            attn_row(torch, timer, results, target, "flash_prefill_attention",
                     f"whisper {what} {dname} B={b} Sq={sq} Sk={te} G=1 causal=False",
                     lambda: attn.flash_prefill_attention(q, k, v, causal=False),
                     lambda: attn.flash_prefill_attention_plain(q, k, v, causal=False),
                     q=q, k=k, v=v,
                     valid=torch.ones(b, sq, te, dtype=torch.bool, device=dev),
                     library_ms=timer.ms(sdpa_call(torch, q, k, v, None, 1)),
                     bytes_moved=(2 * b * sq * h * d + 2 * b * te * h * d) * s,
                     flops=4 * b * h * d * sq * te, dname=dname, plain_iters=3)
            del q
        q = rnd(b, 1, h, d, dt=dt)
        pos = torch.full((b,), te - 1, dtype=torch.int32, device=dev)
        valid = decode_valid(torch, pos, 1, te)
        attn_row(torch, timer, results, target, "dense_decode_attention",
                 f"whisper cross {dname} B={b} S_c={te} G=1 pos={te - 1} L=1",
                 lambda: attn.dense_decode_attention(q, k, v, te - 1),
                 lambda: attn.dense_decode_attention_plain(q, k, v, te - 1),
                 q=q, k=k, v=v, valid=valid,
                 library_ms=timer.ms(sdpa_call(torch, q, k, v, valid[:, None], 1)),
                 bytes_moved=2 * b * h * d * s + 2 * b * te * h * d * s + b * 4,
                 flops=4 * b * h * d * te, dname=dname)
        del k, v, q
        hv, kvh, dv, s_c = 48, 8, 128, 1024
        pos = torch.tensor([400, 523, 700, 1023], dtype=torch.int32, device=dev)
        k, v, q = rnd(b, s_c, kvh, dv, dt=dt), rnd(b, s_c, kvh, dv, dt=dt), rnd(b, 1, hv, dv, dt=dt)
        valid = decode_valid(torch, pos, 1, s_c)
        keys = int(valid.sum().item())
        attn_row(torch, timer, results, target, "dense_decode_attention",
                 f"internvl {dname} B={b} S_c={s_c} D={dv} G={hv // kvh} L=1",
                 lambda: attn.dense_decode_attention(q, k, v, pos),
                 lambda: attn.dense_decode_attention_plain(q, k, v, pos),
                 q=q, k=k, v=v, valid=valid,
                 library_ms=timer.ms(sdpa_call(torch, q, k, v, valid[:, None], hv // kvh)),
                 bytes_moved=2 * b * hv * dv * s + 2 * keys * kvh * dv * s + b * 4,
                 flops=4 * hv * dv * keys, dname=dname)
        del k, v, q
        torch.cuda.empty_cache()

    for model, shapes in ENCDEC_VLM_KN.items():
        for k, n, gemv_rows, gemm_rows in shapes:
            w_t = rnd(n, k, scale=k**-0.5)
            rhs4 = ref.pack(w_t, (128, 128))
            # By list, not by row count: the heads' 4 prefill logit rows are
            # also a decode row count, and run on the GEMM.
            gemv = (fused_gemv.fused_gemv, fused_gemv.fused_gemv_plain)
            gemm = (fused_pack_mmt4d.fused_pack_mmt4d, fused_pack_mmt4d.fused_pack_mmt4d_plain)
            for m, (fn, plain) in ([(m, gemv) for m in gemv_rows]
                                   + [(m, gemm) for m in gemm_rows]):
                x = rnd(m, k)
                got, want = fn(x, rhs4), plain(x, rhs4)
                err = (got.float() - want.float()).abs().max().item()
                del got, want
                add_row(results, target, fn.__name__, f"{model} bf16 M={m} K={k} N={n}",
                        err=err, tol=1e-3, ms=timer.ms(lambda: fn(x, rhs4)),
                        plain_ms=timer.ms(lambda: plain(x, rhs4), iters=1 if m > 1000 else 3,
                                          warmup=1),
                        library_ms=timer.ms(lambda: torch.matmul(x, w_t.t())),
                        bytes_moved=(m * k + n * k) * 2 + m * n * 4, flops=2 * m * n * k,
                        dname="bf16")
            del w_t, rhs4
            torch.cuda.empty_cache()
    torch.cuda.synchronize()


def frontend_inputs(torch, dev, cfg, rng) -> dict:
    """Frames (B, 1500, d_model) for Whisper or patches (B, 256, 3200) for
    InternVL, 4 rows drawn N(0, 0.1^2) from `rng` (as JAX's
    tests/test_archs.py), in the activation dtype on the card."""
    if cfg.family == "encdec":
        name, shape = "frames", (4, cfg.frontend_tokens, cfg.d_model)
    else:
        name, shape = "patches", (4, cfg.frontend_tokens, cfg.frontend_dim)
    x = (0.1 * rng.randn(*shape)).astype("float32")
    return {name: torch.from_numpy(x).to(dev, cfg.activation_dtype)}


def encdec_vlm_prompts(rng, cfg) -> list:
    """4 text prompts: 4-64 tokens for Whisper, 100-500 for InternVL."""
    lo, hi = WHISPER_PROMPTS if cfg.family == "encdec" else INTERNVL_PROMPTS
    return [rng.randint(1, cfg.vocab_size, int(n)).astype("int32")
            for n in rng.randint(lo, hi + 1, 4)]


def encdec_vlm_max_seq(cfg) -> int:
    return WHISPER_MAX_SEQ if cfg.family == "encdec" else 1024


def encdec_vlm_forward_check(torch, dev, seed: int) -> dict:
    """Phase 3, Whisper-tiny at full width and depth (4 encoder, 4 decoder
    layers) and InternVL2-26B at full width, depth 2 of 48 (~8 GB in f32),
    f32, through models/transformer.greedy_generate (forward on dense
    caches: the engine takes tokens only): 4 requests, frames or patches
    N(0, 0.1^2) from the seed, 8 greedy tokens each, through the kernels
    (backend "fused", attention "auto": flash prefill non-causal for the
    encoder and cross attention, the dense decode over the cross cache) and
    through the plain backends ("reference", "xla").  Tokens identical."""
    import numpy as np

    from repro_torch.configs import registry as cfg_registry
    from repro_torch.core.packed import EncodingConfig
    from repro_torch.kernels import attn
    from repro_torch.models import transformer as T

    plain = EncodingConfig(backend="reference", attn_backend="xla")
    kernels = EncodingConfig(backend="fused", attn_backend="auto")
    outs = {}
    for arch, depth in (("whisper-tiny", None), ("internvl2-26b", 2)):
        full = cfg_registry.get_config(arch)
        cfg = dataclasses.replace(full, dtype="float32",
                                  num_layers=depth or full.num_layers)
        params = init_model(cfg, EncodingConfig(), seed, dev)
        rng = np.random.RandomState(seed + 13)
        extra = frontend_inputs(torch, dev, cfg, rng)
        prompts = encdec_vlm_prompts(rng, cfg)
        kw = dict(cfg=cfg, max_new=8, max_seq=encdec_vlm_max_seq(cfg), device=dev, **extra)
        t0 = time.perf_counter()
        before = attn.flash_prefill_attention.launches
        want = T.greedy_generate(params, prompts, enc=plain, **kw)
        if attn.flash_prefill_attention.launches != before:
            raise AssertionError(f"{arch}: the plain backends launched flash prefill")
        t1 = time.perf_counter()
        noncausal = attn.flash_prefill_attention.launches_noncausal
        got = T.greedy_generate(params, prompts, enc=kernels, **kw)
        noncausal = attn.flash_prefill_attention.launches_noncausal - noncausal
        same = got == want
        log(f"[forward] {arch} depth-{cfg.num_layers} f32: kernel tokens == plain tokens "
            f"(prompts {[len(p) for p in prompts]}, non-causal flash launches {noncausal}; "
            f"plain {t1 - t0:.1f}s, kernels {time.perf_counter() - t1:.1f}s): {same}")
        if not same:
            raise AssertionError(f"{arch}: tokens differ: {got} vs {want}")
        if (noncausal > 0) != (cfg.family == "encdec"):
            raise AssertionError(f"{arch}: {noncausal} non-causal flash launches")
        outs[arch] = got
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return outs


def forward_tally(cfg, enc, *, b: int, s: int, max_new: int, max_seq: int):
    """The launches one greedy_generate of `b` rows padded to `s` text
    tokens should make, by (layer type, kernel), and the non-causal flash
    launches among them, from each call's rows and the registry as
    kernels/ops.py and models/layers.py route them.  Prefill: an enc-dec
    model's encoder layers (6 projections at b x Te rows, one non-causal
    flash), its decoder layers (8 projections at b x s rows, the cross wk
    and wv at b x Te, a causal and a non-causal flash); a VLM's projector (2
    projections at b x P rows) and its layers (7 at b x (P + s), one causal
    flash); the untied head at the b logit rows.  Each of the max_new - 1
    decode steps: 8 projections a decoder layer (self q/k/v/o, cross q/o,
    MLP) and 2 dense decodes (self over max_seq slots, cross over Te), or 7
    and 1 for a VLM layer; the head."""
    import collections

    from repro_torch.core.encoding import GEMV_MAX_ROWS, Phase
    from repro_torch.kernels import registry

    def mm(phase, rows):
        be = registry.select(quant="none", phase=phase, m=rows, target=enc.target,
                             requested=enc.resolved_backend()).backend
        pair = MATMUL_KERNELS["none"].get(be)
        return pair and pair[0 if phase is Phase.DECODE and rows <= GEMV_MAX_ROWS else 1]

    def at(phase, keys):
        be = registry.select_attn(phase=phase, s=keys, target=enc.target,
                                  requested=enc.attn_backend).backend
        if be != "pallas":
            return None
        return "flash_prefill_attention" if phase is Phase.PREFILL else "dense_decode_attention"

    want = collections.Counter()
    noncausal = 0

    def add(block, kernel, n):
        if kernel and n:
            want[(block, kernel)] += n

    pre, dec, steps = Phase.PREFILL, Phase.DECODE, max_new - 1
    n = cfg.num_layers
    if cfg.family == "encdec":
        te, ne = cfg.frontend_tokens, cfg.encoder_layers
        add("enc_attn", mm(pre, b * te), layer_projections(cfg, "enc_attn") * ne)
        add("enc_attn", at(pre, te), ne)
        per = layer_projections(cfg, "encdec_attn")
        add("encdec_attn", mm(pre, b * s), (per - 2) * n)
        add("encdec_attn", mm(pre, b * te), 2 * n)
        add("encdec_attn", at(pre, s), n)
        add("encdec_attn", at(pre, te), n)
        add("encdec_attn", mm(dec, b), (per - 2) * n * steps)
        add("encdec_attn", at(dec, max_seq), n * steps)
        add("encdec_attn", at(dec, te), n * steps)
        noncausal = ne + n if at(pre, te) else 0
    else:
        p = cfg.frontend_tokens
        add("projector", mm(pre, b * p), 2)
        per = layer_projections(cfg, "attn")
        add("attn", mm(pre, b * (p + s)), per * n)
        add("attn", at(pre, p + s), n)
        add("attn", mm(dec, b), per * n * steps)
        add("attn", at(dec, max_seq), n * steps)
    if not cfg.tie_embeddings:
        add("head", mm(pre, b), 1)
        add("head", mm(dec, b), steps)
    return want, noncausal


def serve_encdec_vlm(torch, dev, seed: int) -> dict:
    """Phase 13: Whisper-tiny (4 + 4 layers) and InternVL2-26B (48 layers,
    ~40 GB) at full width and depth in bf16 through
    models/transformer.greedy_generate (kernels: backend "fused", attention
    "auto"): 4 requests each, Whisper 1500 frames and 4-64 text tokens
    (max_seq 448), InternVL 256 patches and 100-500 text tokens (max_seq
    1024), 32 new tokens.  Every launch count is set to 0 just before the
    run and read just after: each kernel's launches equal the tally
    (forward_tally, by layer type too), and flash prefill launched with
    causal=False once an encoder layer and once a decoder layer.  Reports
    tokens/s, the prefill ms and (Whisper) the encoder's own ms, decode-step
    p50/p99 (host clock; this run's on_step synchronizes after each
    forward), peak memory, the weight bytes a decode step streams and their
    floor, the cache bytes a slot, and (torch.profiler, after the counted
    run, with no synchronization between steps) the device launches and
    busy ms of the prefill and of a decode step, and the step's idle
    share."""
    import collections

    import numpy as np

    from repro_torch.configs import registry as cfg_registry
    from repro_torch.core import targets
    from repro_torch.core.encoding import Phase
    from repro_torch.core.packed import EncodingConfig
    from repro_torch.kernels import attn
    from repro_torch.models import transformer as T

    enc = EncodingConfig(backend="fused", attn_backend="auto")
    runs = {}
    for arch in ("whisper-tiny", "internvl2-26b"):
        cfg = cfg_registry.get_config(arch)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        params = init_model(cfg, enc, seed, dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        weights_gib = (torch.cuda.memory_allocated(dev) - before) / 2**30
        stream = T.decode_weight_stream_bytes(cfg, enc)
        floor_ms = 1e3 * sum(stream.values()) / targets.H100.hbm_bytes_per_s
        rng = np.random.RandomState(seed + 14)
        extra = frontend_inputs(torch, dev, cfg, rng)
        prompts = encdec_vlm_prompts(rng, cfg)
        max_new, max_seq = 32, encdec_vlm_max_seq(cfg)
        b, s = len(prompts), max(len(p) for p in prompts)
        want, want_noncausal = forward_tally(cfg, enc, b=b, s=s, max_new=max_new,
                                             max_seq=max_seq)
        kernels = kernel_fns()
        for k in kernels.values():
            k.launches = 0
        attn.flash_prefill_attention.launches_noncausal = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        stamps = []

        def stamp():  # the host clock after the device has done each forward
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

        t0 = time.perf_counter()
        tokens = T.greedy_generate(params, prompts, cfg=cfg, enc=enc, max_new=max_new,
                                   max_seq=max_seq, device=dev, on_step=stamp, **extra)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prefill_ms = 1e3 * (stamps[1] - stamps[0])
        launches = {name: k.launches for name, k in kernels.items()}
        noncausal = attn.flash_prefill_attention.launches_noncausal
        peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
        by_kernel = collections.Counter()
        for (_, name), n in want.items():
            by_kernel[name] += n
        tallied = {name: by_kernel[name] for name in kernels}
        if launches != tallied or noncausal != want_noncausal:
            raise AssertionError(f"{arch}: launches {launches} (non-causal flash {noncausal}) "
                                 f"!= tallied {tallied} ({want_noncausal})")
        if (len(tokens) != b or any(len(t) != max_new for t in tokens)
                or not all(0 <= x < cfg.vocab_size for t in tokens for x in t)):
            raise AssertionError(f"{arch}: malformed tokens {tokens}")
        n_tok = b * max_new
        steps = 1e3 * np.diff(stamps[1:])
        out = {"requests": b, "prompts": [len(p) for p in prompts], "tokens": n_tok,
               "wall_s": wall, "tok_s": n_tok / wall, "prefill_ms": prefill_ms,
               "decode_p50_ms": float(np.percentile(steps, 50)),
               "decode_p99_ms": float(np.percentile(steps, 99)), "decode_steps": len(steps),
               "peak_gib": peak_gib, "weights_gib": weights_gib, "init_s": init_s,
               "stream_bytes": stream, "stream_floor_ms": floor_ms,
               "cache_bytes_per_slot": T.cache_bytes(T.cache_init(cfg, 1, max_seq,
                                                                  device="meta")),
               "max_seq": max_seq, "layers": cfg.num_layers, "launches": launches,
               "noncausal_flash": noncausal,
               "launches_by_layer_type": {f"{blk} {name}": n
                                          for (blk, name), n in sorted(want.items())},
               "first_tokens": [t[:8] for t in tokens]}
        # Device busy time by torch.profiler (outside the counted run): a
        # prefill alone, then prefill and every decode step; the difference
        # over the steps is a decode step's launches and busy ms.
        prof = {}
        for n in (1, max_new):
            prof[n] = profiled(torch, lambda n=n: T.greedy_generate(
                params, prompts, cfg=cfg, enc=enc, max_new=n, max_seq=max_seq, device=dev,
                **extra))
        if prof[1][1] is not None:
            step_busy = (prof[max_new][1] - prof[1][1]) / (max_new - 1)
            out["profile"] = {
                "prefill_launches": prof[1][0], "prefill_busy_ms": prof[1][1],
                "decode_step_launches": (prof[max_new][0] - prof[1][0]) / (max_new - 1),
                "decode_step_busy_ms": step_busy,
                "decode_idle_share": 1 - step_busy / out["decode_p50_ms"]}
            log(f"[encdec-vlm] {cfg.name} profile: prefill {prof[1][0]} device launches, "
                f"busy {prof[1][1]:.2f} ms; a decode step "
                f"{out['profile']['decode_step_launches']:.0f} launches, busy {step_busy:.3f} "
                f"ms, idle {out['profile']['decode_idle_share']:.3f} of its p50")
        if cfg.family == "encdec":
            enc_ms = []
            for _ in range(4):  # the encoder on its own, outside the counted run
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                with torch.no_grad():
                    T._run_encoder(params, extra["frames"], cfg, enc, Phase.PREFILL)
                torch.cuda.synchronize()
                enc_ms.append(1e3 * (time.perf_counter() - t1))
            out["encoder_ms"] = float(np.median(enc_ms[1:]))
        log(f"[encdec-vlm] {cfg.name} depth {cfg.num_layers} bf16: init {init_s:.1f}s, "
            f"{weights_gib:.2f} GiB; {b} requests (prompts {out['prompts']}), {n_tok} tokens "
            f"in {wall:.3f}s ({out['tok_s']:.1f} tok/s incl. prefill); prefill "
            f"{prefill_ms:.1f} ms" + (f" (the encoder alone {out['encoder_ms']:.2f} ms)"
                                            if "encoder_ms" in out else "")
            + f"; decode p50 {out['decode_p50_ms']:.2f} p99 {out['decode_p99_ms']:.2f} ms; "
            f"peak {peak_gib:.2f} GiB; a decode step streams {sum(stream.values()) / 1e9:.4f} "
            f"GB (floor {floor_ms:.3f} ms); cache bytes a slot {out['cache_bytes_per_slot']}")
        log(f"[encdec-vlm] {cfg.name}: launches {launches} == tallied, non-causal flash "
            f"{noncausal}; by layer type {out['launches_by_layer_type']}")
        runs[arch] = out
        del params, extra
        gc.collect()
        torch.cuda.empty_cache()
    return runs


def chaos_check(torch, dev, seed: int) -> dict:
    """Phase 10, the chaos harness on the card: Qwen2-1.5B at full width,
    depth 2, f32, nonzero biases, served through the kernels (backend
    "fused", attention "auto") under the committed schedules
    tests/fault_schedules/random_7.json (paged bf16 pool) and
    kv_quant_mix.json (kv8 pool).  Every request ends in a terminal status
    within a step budget; the survivors emit the fault-free card run's
    tokens; no page leaks; every kernel_fail of the log is in
    stats["degraded"] with an injected fault's reason (the engine catches
    KernelFaultError only: any real CUDA error would end the phase); the
    card is still sound after it (a synchronize).  The quarantine the
    faults leave is cleared at the end."""
    import numpy as np

    from repro_torch.configs import registry as cfg_registry
    from repro_torch.core.packed import EncodingConfig
    from repro_torch.kernels import registry
    from repro_torch.serving import engine as engine_lib
    from repro_torch.serving import faults as faults_lib
    from repro_torch.serving.config import EngineConfig

    cfg = dataclasses.replace(cfg_registry.get_config("qwen2-1.5b"), num_layers=2,
                              dtype="float32")
    params = init_model(cfg, EncodingConfig(), seed, dev)
    randomize_biases(torch, params, seed + 7)
    rng = np.random.RandomState(seed + 8)
    prompts = [rng.randint(1, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.randint(8, 48, 6)]
    enc = EncodingConfig(backend="fused", attn_backend="auto")
    sched_dir = os.path.join(HERE, "tests", "fault_schedules")
    out = {}
    for name, kv in (("random_7.json", "bf16"), ("kv_quant_mix.json", "kv8")):
        def engine(hooks=None):
            eng = engine_lib.Engine(params, cfg, enc, device=dev, fault_hooks=hooks,
                                    clock=None if hooks is None else hooks.clock,
                                    config=EngineConfig(slots=3, max_seq=128, block_size=16,
                                                        kv_quant=kv))
            for i, p in enumerate(prompts):
                if not eng.submit(engine_lib.Request(uid=i, prompt=p, max_new_tokens=8)):
                    raise AssertionError(f"chaos {name}: request {i} rejected")
            return eng

        def drive(eng, sched=None):
            steps = 0
            while eng.queue or any(r is not None for r in eng.slot_req):
                if steps >= 300:
                    raise AssertionError(f"chaos {name}: engine deadlocked under faults")
                eng.step()
                eng.audit()
                steps += 1
            if sched is not None:
                sched.drain(eng)
                eng.audit()
            return steps

        registry.clear_quarantine()
        gold_eng = engine()
        drive(gold_eng)
        gold = {r.uid: r.generated for r in gold_eng.finished}
        sched = faults_lib.FaultSchedule.from_json(os.path.join(sched_dir, name))
        eng = engine(sched)
        steps = drive(eng, sched)
        torch.cuda.synchronize()
        statuses = {r.uid: r.status for r in eng.finished}
        if sorted(statuses) != list(range(len(prompts))) or not all(
                r.done and r.status in engine_lib.REQUEST_STATUSES for r in eng.finished):
            raise AssertionError(f"chaos {name}: statuses {statuses}")
        diverged = [r.uid for r in eng.finished if r.status == "ok" and r.generated != gold[r.uid]]
        if diverged:
            raise AssertionError(f"chaos {name}: survivors {diverged} diverged from the "
                                 "fault-free card run")
        if eng.alloc.in_use() != 0 or eng.alloc.available() != eng.alloc.capacity:
            raise AssertionError(f"chaos {name}: {eng.alloc.in_use()} pages leaked")
        fired = [e["key"] for e in sched.log if e["kind"] == "kernel_fail"]
        degraded = eng.stats["degraded"]
        if [d["key"] for d in degraded] != fired or not all(
                d["reason"].startswith("injected kernel fault") for d in degraded):
            raise AssertionError(f"chaos {name}: kernel faults {fired} vs degraded {degraded}")
        kinds = sorted({e["kind"] for e in sched.log})
        survivors = sum(s == "ok" for s in statuses.values())
        log(f"[chaos] {name} ({kv} pool, {steps} steps): statuses {statuses}; {survivors} "
            f"survivors == fault-free card tokens; 0 pages leaked; fired {kinds}; degraded "
            f"{[(d['key'], d['from'], d['to']) for d in degraded]}")
        out[name] = {"kv_quant": kv, "steps": steps, "statuses": statuses, "log": sched.log,
                     "degraded": degraded, "lifecycle": eng.stats["lifecycle"]}
        del eng, gold_eng
    registry.clear_quarantine()
    del params
    torch.cuda.empty_cache()
    return out


def _bits(torch, t):
    """A tensor's bytes, flat (a bitwise comparison: NaN payloads and -0.0 too)."""
    return t.detach().reshape(-1).contiguous().view(torch.uint8)


def train_card_vs_cpu(torch, dev, seed: int, *, cfg=None, batch: int = 2,
                      seq: int = 128) -> dict:
    """Phase 14 (a): Llama at full width, depth 2, f32, TF32 off.  The params
    are made on the CPU from `seed` (the two devices' generators differ) and
    copied to the card; one train step on each device from the same batch:
    the loss within 1e-5 relative, the grad norm within 1e-4 relative, every
    updated param within 1e-6 abs except where |g| < 1e-6 x max|g| of its
    leaf (Adam's first step is the sign of noise there) or where the
    clipped gradient Adam sees, |g| x min(1, clip_norm / grad_norm), is below
    10 x eps (Adam's eps region: its first step g / (|g| + eps) turns steeply
    with g, so the f32 noise of the gradient moves it); there within 2 x lr.  The
    trained packed weights then serve 4 prompts through the kernels (backend
    "auto") and the plain path ("xla"): identical tokens.  (Llama's widths
    are multiples of the 128 tile, so its packed weights carry no padding;
    tests/test_torch_train.py holds padding at zero on the reduced Yi.)  Then the state (params, mu, nu) goes through
    AsyncCheckpointer under build/ and back: every leaf bit for bit, and the
    next step's loss from the restored state equal to the uninterrupted
    run's (bit for bit, or within 1e-6 relative)."""
    import shutil

    import numpy as np

    from repro_torch.checkpoint import checkpoint as ckpt_lib
    from repro_torch.configs import registry as cfg_registry
    from repro_torch.core import tree
    from repro_torch.core.packed import EncodingConfig
    from repro_torch.data import pipeline as data_lib
    from repro_torch.models import transformer as T
    from repro_torch.serving import engine as engine_lib
    from repro_torch.serving.config import EngineConfig
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import trainer as trainer_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    cfg = cfg or dataclasses.replace(cfg_registry.get_config("llama3.2-1b"), num_layers=2,
                                     dtype="float32")
    enc = EncodingConfig(backend="xla")
    t0 = time.perf_counter()
    params_cpu = T.model_init(cfg, enc, seed=seed, device="cpu")
    params = _to_device(params_cpu, dev)
    data = data_lib.SyntheticPacked(data_lib.DataConfig(cfg.vocab_size, seq, batch, seed=seed))
    opt_cfg = opt_lib.OptimizerConfig(peak_lr=1e-3)
    step = trainer_lib.make_train_step(cfg, enc, opt_cfg)
    b0 = data.batch(0)
    t1 = time.perf_counter()
    p_cpu, _, m_cpu, _ = step(params_cpu, opt_lib.init(params_cpu),
                              data_lib.to_torch(b0, "cpu"))
    cpu_s = time.perf_counter() - t1
    p_dev, o_dev, m_dev, _ = step(params, opt_lib.init(params), data_lib.to_torch(b0, dev))
    grads = trainer_lib.value_and_grad(params, data_lib.to_torch(b0, dev), cfg, enc)[2]
    loss_rel = abs(float(m_dev["loss"]) - float(m_cpu["loss"])) / abs(float(m_cpu["loss"]))
    gn_rel = (abs(float(m_dev["grad_norm"]) - float(m_cpu["grad_norm"]))
              / float(m_cpu["grad_norm"]))
    lr = float(m_cpu["lr"])
    clip = min(1.0, opt_cfg.clip_norm / float(m_dev["grad_norm"]))
    worst = worst_small = 0.0
    n_small = n_all = 0
    where = None
    for (path, a), b, g in zip(tree.leaves_with_path(p_dev), tree.leaves(p_cpu),
                               tree.leaves(grads)):
        g = g.float().abs()
        small = (g < 1e-6 * g.max()) | (g * clip < 10 * opt_cfg.eps)
        diff = (a.float() - b.to(dev).float()).abs()
        big = torch.where(small, 0.0, diff)
        if float(big.max()) > worst:
            worst, i = float(big.max()), int(big.argmax())
            where = {"leaf": tree.keystr(path), "abs_g": float(g.reshape(-1)[i]),
                     "max_abs_g": float(g.max()), "clip_scale": clip}
        worst_small = max(worst_small, float(torch.where(small, diff, 0.0).max()))
        n_small += int(small.sum())
        n_all += small.numel()
    out = {"loss_cpu": float(m_cpu["loss"]), "loss_card": float(m_dev["loss"]),
           "loss_rel": loss_rel, "grad_norm_cpu": float(m_cpu["grad_norm"]),
           "grad_norm_card": float(m_dev["grad_norm"]), "grad_norm_rel": gn_rel, "lr": lr,
           "param_max_abs": worst, "param_max_abs_small_g": worst_small,
           "param_worst_at": where, "small_g_elements": n_small, "elements": n_all,
           "cpu_step_s": cpu_s,
           "setup_s": t1 - t0}
    log(f"[train] card vs CPU, {cfg.name} depth {cfg.num_layers} f32, batch {batch} x "
        f"{seq}: loss {out['loss_card']:.7f} vs {out['loss_cpu']:.7f} (rel {loss_rel:.2e}), "
        f"grad norm rel {gn_rel:.2e}, params max abs {worst:.2e} ({n_small} of {n_all} "
        f"elements with |g| < 1e-6 max|g| or clipped |g| < 10 eps: max abs {worst_small:.2e}, "
        f"limit "
        f"{2 * lr:.1e}); "
        f"the worst element {where}; CPU step {cpu_s:.1f}s")
    if not (loss_rel <= 1e-5 and gn_rel <= 1e-4 and worst <= 1e-6 and worst_small <= 2 * lr):
        raise AssertionError(f"train step on the card differs from the CPU's: {out}")

    rng = np.random.RandomState(seed)
    prompts = [rng.randint(1, cfg.vocab_size, n).astype(np.int32) for n in (100, 37, 250, 180)]
    kernels = kernel_fns()
    tokens, launched = {}, {}
    for label, enc_s in (("kernels", EncodingConfig(backend="auto", attn_backend="auto")),
                         ("plain", EncodingConfig(backend="xla", attn_backend="xla"))):
        for k in kernels.values():
            k.launches = 0
        eng = engine_lib.Engine(p_dev, cfg, enc_s, device=dev,
                                config=EngineConfig(slots=4, max_seq=512, block_size=16))
        for i, p in enumerate(prompts):
            eng.submit(engine_lib.Request(uid=i, prompt=p, max_new_tokens=8))
        tokens[label] = {r.uid: r.generated for r in eng.run()}
        launched[label] = {name: k.launches for name, k in kernels.items() if k.launches}
    need = ("fused_gemv", "fused_pack_mmt4d", "flash_prefill_attention", "paged_decode_attention")
    log(f"[train] trained weights served: kernel tokens == plain tokens: "
        f"{tokens['kernels'] == tokens['plain']}; kernel launches {launched['kernels']}, "
        f"plain run {launched['plain']}")
    if tokens["kernels"] != tokens["plain"]:
        raise AssertionError(f"trained weights: kernel tokens {tokens['kernels']} != plain "
                             f"{tokens['plain']}")
    if any(not launched["kernels"].get(n) for n in need) or launched["plain"]:
        raise AssertionError(f"serving launches: {launched}")
    out.update(served_tokens=tokens["kernels"], served_launches=launched["kernels"])

    ck = os.path.join(HERE, "build", "phase14_ckpt")
    shutil.rmtree(ck, ignore_errors=True)
    state = {"params": p_dev, "opt": o_dev}
    saver = ckpt_lib.AsyncCheckpointer(ck)
    t1 = time.perf_counter()
    saver.save(state, 1)
    snap_s = time.perf_counter() - t1
    saver.wait()
    save_s = time.perf_counter() - t1
    restored = ckpt_lib.restore(ck, 1, state, device=dev)
    shutil.rmtree(ck)
    bad = [tree.keystr(path) for (path, a), b in zip(tree.leaves_with_path(state),
                                                     tree.leaves(restored))
           if a.dtype != b.dtype or not torch.equal(_bits(torch, a), _bits(torch, b))]
    if bad:
        raise AssertionError(f"checkpoint round trip changed {bad}")
    b1 = data_lib.to_torch(data.batch(1), dev)
    la = float(step(p_dev, o_dev, b1)[2]["loss"])
    lb = float(step(restored["params"], restored["opt"], b1)[2]["loss"])
    rel = abs(la - lb) / abs(la)
    log(f"[train] checkpoint round trip: {len(tree.leaves(state))} leaves bit for bit "
        f"(snapshot {snap_s:.2f}s, written {save_s:.2f}s); next loss {la!r} uninterrupted, "
        f"{lb!r} restored (bit for bit: {la == lb}, rel {rel:.1e})")
    if rel > 1e-6:
        raise AssertionError(f"restored run's loss {lb} differs from {la}")
    out.update(ckpt_leaves=len(tree.leaves(state)), ckpt_next_loss=[la, lb],
               ckpt_bitwise_next_loss=la == lb, ckpt_snapshot_s=snap_s, ckpt_save_s=save_s)
    del params_cpu, p_cpu, params, p_dev, o_dev, grads, state, restored
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_full(torch, dev, seed: int, smi: str, *, cfg=None, batch: int = 8, seq: int = 1024,
               steps: int = 20) -> dict:
    """Phase 14 (b), (c): Llama-3.2-1B at full width and depth (16 layers),
    bf16 params, f32 moments, SyntheticPacked(seed=0), batch 8 x 1024,
    `steps` steps at lr 1e-3 (warmup max(5, steps // 20), decay over
    `steps`: launch/train.py's rule).  Each step ends in a synchronize.
    Gate: every loss and grad norm finite, the mean of the last 5 losses
    below the first 5's.  Reports step ms p50 after 2 warm steps, tokens/s,
    the peak device memory and 6 N tokens/s as a share of the bf16 peak;
    then one more step under the profiler (device busy ms, the kernels
    that take it).  (c): no hand-written kernel launches in the timed
    steps (their launch counts, set to 0 before, read after)."""
    import collections
    import math

    import numpy as np
    from torch.profiler import DeviceType, ProfilerActivity, profile

    from repro_torch.configs import registry as cfg_registry
    from repro_torch.core import targets
    from repro_torch.core.packed import EncodingConfig
    from repro_torch.data import pipeline as data_lib
    from repro_torch.models import transformer as T
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import trainer as trainer_lib

    cfg = cfg or cfg_registry.get_config("llama3.2-1b")
    enc = EncodingConfig(backend="xla")
    t0 = time.perf_counter()
    params = T.model_init(cfg, enc, seed=seed, device=dev)
    opt = opt_lib.init(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    opt_cfg = opt_lib.OptimizerConfig(peak_lr=1e-3, warmup_steps=max(5, steps // 20),
                                      decay_steps=steps)
    data = data_lib.Prefetcher(data_lib.SyntheticPacked(
        data_lib.DataConfig(cfg.vocab_size, seq, batch, seed=0)))
    step = trainer_lib.make_train_step(cfg, enc, opt_cfg)
    kernels = kernel_fns()
    for k in kernels.values():
        k.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    start_gib = torch.cuda.memory_allocated(dev) / 2**30
    rows, ms = [], []
    for i in range(steps):
        b = data_lib.to_torch(next(data), dev)
        t1 = time.perf_counter()
        params, opt, m, _ = step(params, opt, b)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t1))
        rows.append({k: float(v) for k, v in m.items()})
        log(f"[train] {cfg.name} step {i}: loss {rows[-1]['loss']:.4f} grad_norm "
            f"{rows[-1]['grad_norm']:.4f} lr {rows[-1]['lr']:.2e} {ms[-1]:.1f} ms")
    launches = {name: k.launches for name, k in kernels.items() if k.launches}
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    losses = [r["loss"] for r in rows]
    finite = all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in rows)
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    p50 = float(np.median(ms[2:]))
    tokens = batch * seq
    n = cfg.param_count()
    share = 6 * n * tokens / (p50 / 1e3) / targets.H100.peak_flops_bf16

    b = data_lib.to_torch(next(data), dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        params, opt, _, _ = step(params, opt, b)
        torch.cuda.synchronize()
        prof_ms = 1e3 * (time.perf_counter() - t1)
    by_name, by_class, launches_dev = collections.Counter(), collections.Counter(), 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            t = e.time_range.elapsed_us() / 1e3
            by_name[e.name] += t
            low = e.name.lower()
            by_class[next((c for c in ("gemm", "elementwise", "reduce", "softmax", "index",
                                       "memcpy", "memset") if c in low), "other")] += t
            launches_dev += 1
    busy = sum(by_name.values())
    top = [(name[:80], round(t, 2)) for name, t in by_name.most_common(6)]
    classes = {c: round(t, 2) for c, t in by_class.most_common()}
    out = {"steps": steps, "batch": batch, "seq": seq, "losses": losses,
           "grad_norms": [r["grad_norm"] for r in rows], "step_ms": ms, "p50_ms": p50,
           "tok_s": tokens / (p50 / 1e3), "params": n, "flop_share_bf16": share,
           "start_gib": start_gib, "peak_gib": peak_gib, "init_s": init_s,
           "launches": launches, "profiled_step_ms": prof_ms, "busy_ms": busy,
           "device_launches": launches_dev, "by_class_ms": classes, "top_kernels_ms": top,
           "card": smi}
    log(f"[train] {cfg.name} depth {cfg.num_layers} {cfg.dtype}, batch {batch} x {seq}, {steps} "
        f"steps on {smi}: loss first-5 mean {first:.4f}, last-5 mean {last:.4f}; step p50 "
        f"{p50:.1f} ms (after 2 warm steps), {out['tok_s']:.0f} tokens/s, 6N tokens/s "
        f"{share:.2%} of {targets.H100.peak_flops_bf16 / 1e12:.0f} TFLOP/s (N = {n}); memory "
        f"{start_gib:.2f} GiB at the start, peak {peak_gib:.2f} GiB; init {init_s:.1f}s")
    log(f"[train] {cfg.name} profiled step {prof_ms:.1f} ms, device busy {busy:.1f} ms in "
        f"{launches_dev} device launches; by class (ms) {classes}; top kernels (ms) {top}")
    log(f"[train] kernel launches inside the training steps: {launches or 'none'}")
    if not finite or not last < first:
        raise AssertionError(f"training did not run clean: losses {losses}, "
                             f"grad norms {out['grad_norms']}")
    if launches:
        raise AssertionError(f"hand-written kernels launched inside training: {launches}")
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_check(torch, dev, seed: int, smi: str) -> dict:
    """Phase 14: training on the card (train_card_vs_cpu, train_full)."""
    t0 = time.perf_counter()
    out = {"card_vs_cpu": train_card_vs_cpu(torch, dev, seed),
           "llama": train_full(torch, dev, seed, smi)}
    out["phase_s"] = time.perf_counter() - t0
    log(f"[train] phase 14 in {out['phase_s']:.1f}s")
    return out


# ---- phase 15: tensor-parallel serving ------------------------------------------------

# (a)'s engines: (label, encoding kwargs, engine config, prompts), each at
# tp = 1, 2 and 4 on Llama-3.2-1B at full width, depth 2 of 16, f32.
# TP_FORCED: the cases whose tokens at tp > 1 are held to tp = 1's by their
# logits rather than by free-running tokens.  A rank's kernels plan their
# splits by the shapes they get (a GEMV's K splits by its N blocks, decode
# attention's key splits by rows x kv heads), so with fewer columns or heads
# a rank sums some outputs in another f32 order, an ulp off one card's; f32
# carries that to the tokens no further at depth 2, but the int8/int4
# activation quantizers and the kv4 codes round it across a code boundary
# now and then (the int4 GEMV also rounds each rank's exact f64 sum to f32
# before the group adds them), and a greedy stream that parts there never
# meets again.  So at tp > 1 these cases are fed tp = 1's tokens (teacher
# forced: tp_forced_drive) and gated on every position's logits: each within
# TP_LOGIT_LIMIT of tp = 1's, and the argmax equal to tp = 1's token
# wherever tp = 1's top-2 gap exceeds TP_GAP.  The limit lies between the
# sound runs' largest |difference| and that of a planted fault (TP_PLANTED:
# the same engines at tp = 2 with the activation absmax all-reduce skipped,
# each rank quantizing its K slice on its own scale), and every run checks
# that the planted fault fails the gate.  On the CPU, where the plain
# versions have no plans, these cases' tokens equal tp = 1's outright
# (tests/test_torch_tp_engine.py).
TP_FORCED = ("kv4", "w8a8", "w4a8")
TP_PLANTED = ("w8a8", "w4a8")
# Readings on the H100 (seed 0): the sound runs' largest |dlogit| 0.006
# (kv4), 0.094 (w8a8), 0.111 (w4a8), their argmax parting only where tp =
# 1's top-2 gap is at most 0.035; the planted fault 3.2 (w8a8) and 0.33
# (w4a8).  The limit sits between them; a position whose gap exceeds twice
# the limit cannot flip under it, so TP_GAP, half the limit, asks more.
TP_LOGIT_LIMIT = 0.2
TP_GAP = 0.1


def outside_tp_gate(f: dict) -> bool:
    """Whether a ForcedStream summary fails phase 15's gate for TP_FORCED."""
    gap = f["max_gap_where_differs"]
    return f["max_abs_dlogit"] > TP_LOGIT_LIMIT or (gap is not None and gap > TP_GAP)
TP_AUTO = dict(backend="auto", attn_backend="auto")
TP_CASES = (
    ("auto", TP_AUTO, {}, "shared"),
    ("pallas", dict(backend="pallas", attn_backend="auto"), {}, "shared"),
    ("spec", TP_AUTO, dict(spec_decode=True, draft_k=4), "tiled"),
    ("budget", TP_AUTO, dict(token_budget=64), "shared"),
    ("kv8", TP_AUTO, dict(kv_quant="kv8"), "shared"),
    ("kv4", TP_AUTO, dict(kv_quant="kv4"), "shared"),
    ("w8a8", dict(TP_AUTO, weight_quant="int8"), {}, "shared"),
    ("w4a8", dict(TP_AUTO, weight_quant="int4"), {}, "shared"),
)


# (d)'s engines: Mixtral-8x22B and Grok-1-314B at full width, depth 2 of 56
# / 64, f32, phase 11's trace with TP_MOE_NEW new tokens a request, at tp =
# 1, 2 and 4: a rank holds every expert's FFN columns (16384 / tp for
# Mixtral, 32768 / tp for Grok) and the whole router, and every rank routes
# alike.  "auto" is served twice at tp = 1, which must repeat itself token
# for token (idle slots and pads route and take capacity beside the live
# rows, so their cache writes must land alike every run), and is held to
# tp = 1's tokens at tp = 2 and 4; w8a8 is forced on tp = 1's and
# gated as (a)'s TP_FORCED, and at tp = 2 served again with the experts'
# stacked absmax all-reduce skipped, which must fail the gate.
TP_MOE = ("mixtral-8x22b", "grok-1-314b")
TP_MOE_CASES = (("auto", TP_AUTO), ("w8a8", dict(TP_AUTO, weight_quant="int8")))
TP_MOE_NEW = 8
# (e): Mixtral-8x22B at full width, depth 8 of 56, bf16, phase 11's run (its
# trace, 4 slots, max_seq 8192, backend "fused", 32 new) at tp = 2,
# reported against phase 11's own tp = 1 run.
TP_MOE_REPORT_LAYERS = 8
# row_parallel_check's projections: (name, K, N, experts reduced together).
TP_ROW_PARALLEL = (("wo", 2048, 2048, 1), ("w_down", 8192, 2048, 1),
                   ("experts w_down", 16384, 6144, 8))


def tp_jobs(seed: int, tp: int) -> list[dict]:
    """The runs of phase 15 at degree `tp`: (a)'s cases (at tp = 2 each of
    TP_PLANTED again, part "planted", every absmax all-reduce skipped),
    (d)'s MoE cases (at tp = 2 w8a8 again, part "planted", the experts'
    stacked absmax all-reduce skipped), then (b) at tp = 2 (Llama-3.2-1B,
    full width and depth, bf16) or (c) at tp = 4 (Yi-9B, full width and
    depth, bf16), at tp = 1 both, and (e) at tp = 2 (Mixtral at depth 8;
    its tp = 1 is phase 11's run)."""
    import numpy as np

    from repro_torch.configs import registry as cfg_registry

    llama = cfg_registry.get_config("llama3.2-1b")
    small = dataclasses.replace(llama, num_layers=2, dtype="float32")
    jobs = []
    for label, enc_kw, config, kind in TP_CASES:
        rng = np.random.RandomState(seed)
        prompts = (tiled_prompts if kind == "tiled" else shared_prefix_prompts)(
            rng, small.vocab_size)
        jobs.append(dict(part="a", label=label, cfg=small, enc=enc_kw, config=config,
                         prompts=prompts, max_new=32, forced=label in TP_FORCED, plant=None))
        if tp == 2 and label in TP_PLANTED:
            jobs.append(dict(jobs[-1], part="planted", plant="absmax"))
    for arch in TP_MOE:
        cfg = dataclasses.replace(cfg_registry.get_config(arch), num_layers=2, dtype="float32")
        prompts = moe_prompts(np.random.RandomState(seed + 11), cfg.vocab_size)
        for case, enc_kw in TP_MOE_CASES:
            jobs.append(dict(part="d", label=f"{arch} {case}", cfg=cfg, enc=enc_kw,
                             config=dict(max_seq=8192), prompts=prompts, max_new=TP_MOE_NEW,
                             forced=case in TP_FORCED, plant=None))
            if tp == 2 and case in TP_PLANTED:
                jobs.append(dict(jobs[-1], part="planted", plant="stacked absmax"))
    fused = dict(backend="fused", attn_backend="auto")
    full = [("b", llama)] if tp in (1, 2) else []
    full += [("c", cfg_registry.get_config("yi-9b"))] if tp in (1, 4) else []
    for part, cfg in full:
        jobs.append(dict(part=part, label=cfg.name, cfg=cfg, enc=fused, config={},
                         prompts=shared_prefix_prompts(np.random.RandomState(seed),
                                                       cfg.vocab_size),
                         max_new=32, forced=False, plant=None))
    if tp == 2:
        mix = cfg_registry.get_config("mixtral-8x22b")
        cfg = dataclasses.replace(mix, num_layers=TP_MOE_REPORT_LAYERS)
        jobs.append(dict(part="e", label=f"{mix.name} depth {cfg.num_layers}", cfg=cfg,
                         enc=fused, config=dict(max_seq=8192),
                         prompts=moe_prompts(np.random.RandomState(seed + 11), cfg.vocab_size),
                         max_new=32, forced=False, plant=None))
    return jobs


@contextlib.contextmanager
def planted_fault(plant: str):
    """Phase 15's planted fault: "absmax" skips every activation absmax
    all-reduce (each rank quantizes its K slice on its own scale), "stacked
    absmax" only the MoE experts' stacked one (a reduction of more than one
    projection's rows)."""
    from repro_torch.parallel import collectives

    reduce_max, reduce_each = collectives.all_reduce_max, collectives.all_reduce_max_each
    if plant == "absmax":
        collectives.all_reduce_max = lambda x, group: x
    else:
        collectives.all_reduce_max_each = (
            lambda xs, group: list(xs) if len(xs) > 1 else reduce_each(xs, group))
    try:
        yield
    finally:
        collectives.all_reduce_max, collectives.all_reduce_max_each = reduce_max, reduce_each


class ForcedStream:
    """Teacher forcing for TP_FORCED: a drive whose engine commits, for
    every request and position, tp = 1's token instead of its own argmax,
    and reads the logits of each commit.  Made with `ref` None (at tp = 1)
    it records each position's logits (`logits`, requests x max_new x
    vocab); with `ref` (tp = 1's record: its logits and tokens) it forces
    the tokens and keeps each position's largest |logit - tp = 1's| and
    argmax, on the card until summary()."""

    def __init__(self, torch, dev, n_req: int, max_new: int, vocab: int, ref=None):
        self.torch, self.vocab, self.rows = torch, vocab, []
        if ref is None:
            self.logits = torch.zeros(n_req, max_new, vocab, device=dev)
            return
        self.ref = ref["logits"].to(dev)
        self.tokens = ref["tokens"]
        top2 = self.ref.topk(2, dim=-1).values
        self.gap = top2[..., 0] - top2[..., 1]

    def drive(self, prompts, max_new):
        inner = submit_all(prompts, max_new)

        def drive(eng):
            commit = eng._commit

            def forced(slots_sel, nxt, bad=frozenset()):
                logits = eng._last_logits
                if logits.dim() != 2:
                    raise AssertionError(f"a forced case ran a window step: {logits.shape}")
                for s in slots_sel:
                    req = eng.slot_req[s]
                    if req is None or s in bad:
                        continue
                    i = len(req.generated)
                    row = logits[s, :self.vocab].float()
                    if not hasattr(self, "ref"):
                        self.logits[req.uid, i] = row
                        continue
                    self.rows.append(((row - self.ref[req.uid, i]).abs().max(), row.argmax(),
                                      req.uid, i))
                    nxt[s] = self.tokens[req.uid][i]
                return commit(slots_sel, nxt, bad)
            eng._commit = forced
            return inner(eng)
        return drive

    def summary(self) -> dict:
        """Over every forced position: the largest |logit - tp = 1's|, the
        positions whose argmax is not tp = 1's token, the largest top-2 gap
        of tp = 1's logits among them, and tp = 1's largest |logit|."""
        torch = self.torch
        d = torch.stack([r[0] for r in self.rows]).cpu()
        am = torch.stack([r[1] for r in self.rows]).cpu()
        uid = torch.tensor([r[2] for r in self.rows])
        pos = torch.tensor([r[3] for r in self.rows])
        want = torch.tensor([self.tokens[int(u)][int(i)] for u, i in zip(uid, pos)])
        gap = self.gap[uid.to(self.gap.device), pos.to(self.gap.device)].cpu()
        differ = am != want
        return {"positions": len(self.rows), "max_abs_dlogit": d.max().item(),
                "argmax_differs": int(differ.sum()),
                "max_gap_where_differs": gap[differ].max().item() if differ.any() else None,
                "min_gap": gap.min().item(),
                "ref_logit_absmax": self.ref.abs().max().item()}


def row_parallel_check(torch, dev, seed: int, tp: int, rank: int) -> dict:
    """wo (K = 2048) and w_down (K = 8192) at Llama-3.2-1B's widths, N =
    2048, row-parallel on this rank's K slice (linear_apply's row_group)
    against one card's product of the whole weight on the same rows, at
    decode (M = 4) and prefill (M = 64) on the "auto" route; then 8
    experts' w_down at Mixtral's widths (K = 16384, N = 6144)
    through one linear_apply_row_parallel (the experts' stacked reduction)
    against one card's linear_apply of each: w8a8 must be one card's bit
    for bit (the ranks' exact integer sums added in f64, one card's
    epilogue); w4a8 and f32 (auto and the plain reference rung, a
    quarantine's last) are reported.  Returns the largest |difference| by
    format and projection."""
    import torch.distributed as dist

    from repro_torch.core import packed
    from repro_torch.core.encoding import Phase
    from repro_torch.parallel import sharding

    out = {}
    group = dist.group.WORLD
    for fmt, backend in (("int8", "auto"), ("int4", "auto"), ("none", "auto"),
                         ("none", "reference")):
        enc = packed.EncodingConfig(backend=backend, attn_backend="auto", weight_quant=fmt)
        gen = torch.Generator(device=dev).manual_seed(seed)
        for name, k, n, experts in TP_ROW_PARALLEL:
            ws = [packed.linear_init(gen, k, n, enc=enc, device=dev) for _ in range(experts)]
            lo, hi = rank * k // tp, (rank + 1) * k // tp
            parts = [sharding.shard_linear(w, n, k, "cols", lo, hi, group=enc.quant_group)
                     for w in ws]
            for phase, m in ((Phase.DECODE, 4), (Phase.PREFILL, 64)):
                xs = [torch.randn(m, k, generator=gen, device=dev) for _ in ws]
                one = [packed.linear_apply(w, x, n=n, phase=phase, enc=enc)
                       for w, x in zip(ws, xs)]
                if experts == 1:
                    got = [packed.linear_apply(parts[0], xs[0][:, lo:hi], n=n, phase=phase,
                                               enc=enc, row_group=group)]
                else:
                    got = packed.linear_apply_row_parallel(
                        parts, [x[:, lo:hi] for x in xs], n=n, phase=phase, enc=enc,
                        row_group=group)
                err = max((g - o).abs().max().item() for g, o in zip(got, one))
                if fmt == "int8" and err:
                    raise AssertionError(f"w8a8 {name} row-parallel at tp={tp} rank {rank} "
                                         f"{phase.value}: {err} from one card's")
                label = f"{fmt} {backend} {name}"
                out[label] = max(out.get(label, 0.0), err)
            del ws, parts
    return out


def tp_serve(torch, dev, seed: int, tp: int, rank: int, ref_dir: str) -> list[dict]:
    """Serve every job of tp_jobs at degree `tp` in this process (rank
    `rank` of a group of tp, or alone at tp = 1): each model made as this
    rank's shard of the seed's weights (transformer.model_init(shard=)),
    the job's trace (4 slots) through counted_run.  Forced cases record
    their logits into `ref_dir` at tp = 1 and are forced on that record at
    tp > 1 (ForcedStream); a "planted" job serves its case again, forced,
    under its planted_fault, outside counted_run (its ranks' logits part,
    as a fault's would)."""
    from repro_torch.core import tree
    from repro_torch.core.packed import EncodingConfig
    from repro_torch.models import transformer as T
    from repro_torch.parallel import sharding
    from repro_torch.serving import engine as engine_lib
    from repro_torch.serving.config import EngineConfig

    out, params, made = [], None, None
    for job in tp_jobs(seed, tp):
        enc = EncodingConfig(**job["enc"])
        cfg = job["cfg"]
        key = (cfg.name, cfg.num_layers, enc.weight_quant)
        if made != key:
            params = None
            gc.collect()
            torch.cuda.empty_cache()
            shard = sharding.plan(cfg, enc, tp, rank) if tp > 1 else None
            params, init_s = in_turn(torch, tp, rank, lambda: T.model_init(
                cfg, enc, seed=seed, device=dev, shard=shard))
            made = key
        config = dict(slots=4, mesh_shape=(tp,), **job["config"])
        label = f"{job['part']} {job['label']} tp={tp} rank {rank}"
        max_new = job["max_new"]
        drive = submit_all(job["prompts"], max_new)
        forced = None
        if job["forced"]:
            path = os.path.join(ref_dir, f"{job['label']}.pt")
            ref = torch.load(path) if tp > 1 else None
            forced = ForcedStream(torch, dev, len(job["prompts"]), max_new, cfg.vocab_size, ref)
            drive = forced.drive(job["prompts"], max_new)
        if job["part"] == "planted":
            eng = engine_lib.Engine(params, cfg, enc, device=dev, config=EngineConfig(
                **{"max_seq": 1024, "block_size": 16, **config}))
            with planted_fault(job["plant"]):
                drive(eng)
            torch.cuda.synchronize()
            out.append(dict(part="planted", label=job["label"], tp=tp, rank=rank,
                            plant=job["plant"], forced=forced.summary(),
                            tokens_by_uid={r.uid: list(r.generated) for r in eng.finished}))
            del eng
            continue
        eng, run = counted_run(torch, dev, params, cfg, enc, config, drive, label, "tp")
        tokens_by_uid = {r.uid: list(r.generated) for r in eng.finished}
        if tp == 1 and job["part"] == "d" and not job["forced"]:
            del eng
            eng, _ = counted_run(torch, dev, params, cfg, enc, config,
                                 submit_all(job["prompts"], max_new), f"{label} again", "tp")
            again = {r.uid: list(r.generated) for r in eng.finished}
            if again != tokens_by_uid:
                raise AssertionError(f"{label}: served twice, the tokens differ: "
                                     f"{tokens_by_uid} then {again}")
            log(f"[tp] {label}: served twice, the same tokens")
        run.update(part=job["part"], label=job["label"], tp=tp, rank=rank, init_s=init_s,
                   tokens_by_uid=tokens_by_uid,
                   model_cfg=dict(heads=eng.model_cfg.num_heads,
                                  kv_heads=eng.model_cfg.num_kv_heads,
                                  d_ff=eng.model_cfg.d_ff, experts=eng.model_cfg.num_experts))
        if forced is not None and tp == 1:
            torch.save({"logits": forced.logits.cpu(),
                        "tokens": {int(u): [int(t) for t in toks]
                                   for u, toks in run["tokens_by_uid"].items()}}, path)
        elif forced is not None:
            run["forced"] = forced.summary()
        if job["part"] not in ("a", "d"):
            run["weight_gib"] = sum(t.numel() * t.element_size() for t in tree.leaves(params)
                                    if isinstance(t, torch.Tensor)) / 2**30
        del eng, forced
        out.append(run)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def in_turn(torch, tp: int, rank: int, make):
    """(make(), its seconds), the ranks of the group making theirs one
    after another: they share one card, and the transients of their inits
    together (each rank quantizes every whole weight it draws, Grok's f32
    head of 3.2 GB among them) would not fit it.  The memory a rank's
    caching allocator freed goes back to the card before the next turn."""
    import torch.distributed as dist

    out = seconds = None
    for turn in range(tp):
        if turn == rank:
            t0 = time.perf_counter()
            out = make()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            gc.collect()
            torch.cuda.empty_cache()
        if tp > 1:
            dist.barrier()
    return out, seconds


def tp_rank(rank: int, world: int, device: str, seed: int, ref_dir: str) -> dict:
    """One spawned rank of phase 15 (launch/mesh.launch_ranks runs it): the
    row-parallel projections, then the serving runs."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    return {"row_parallel": row_parallel_check(torch, dev, seed, world, rank),
            "runs": tp_serve(torch, dev, seed, world, rank, ref_dir)}


def nccl_rank(rank: int, world: int, device: str, seed: int) -> dict:
    """A rank of a world of one on NCCL: one decode step of a depth-2 f32
    Llama, then each collective the forward uses run on that step's logits
    through the NCCL group (reduce_in_group and gather_in_group skip the
    size-1 shortcut), each equal to its input."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import registry as cfg_registry
    from repro_torch.core.packed import EncodingConfig
    from repro_torch.models import transformer as T
    from repro_torch.parallel import collectives
    from repro_torch.serving import engine as engine_lib
    from repro_torch.serving.config import EngineConfig

    del rank, world
    dev = torch.device(device)
    cfg = dataclasses.replace(cfg_registry.get_config("llama3.2-1b"), num_layers=2,
                              dtype="float32")
    enc = EncodingConfig(**TP_AUTO)
    eng = engine_lib.Engine(T.model_init(cfg, enc, seed=seed, device=dev), cfg, enc,
                            device=dev, config=EngineConfig(slots=1, max_seq=256))
    prompt = np.random.RandomState(seed).randint(1, cfg.vocab_size, 40).astype(np.int32)
    eng.submit(engine_lib.Request(uid=0, prompt=prompt, max_new_tokens=2))
    eng.run()
    logits = eng._last_logits
    group = dist.group.WORLD
    backend = dist.get_backend(group)
    same = {op: bool(torch.equal(collectives.reduce_in_group(logits, group, op), logits))
            for op in ("sum", "max")}
    same["gather"] = bool(torch.equal(collectives.gather_in_group(logits, group), logits))
    torch.cuda.synchronize()
    return {"backend": backend, "equal": same, "host_copies": collectives.counts["host_copies"]}


def serve_tp(torch, dev, seed: int, smi: str, moe_tp1: dict) -> dict:
    """Phase 15: tensor-parallel serving with every rank on this one card
    (gloo between them, card tensors staged through the host: NCCL refuses
    two ranks on one device).  tp = 1 here, then 2 and 4 ranks spawned by
    launch/mesh.launch_ranks after the kernels are built.  (a) and (d)
    gate: (d)'s "auto" tp = 1 serves repeating themselves (tp_serve), every
    case's tokens at tp = 2 and 4 equal to tp = 1's, on every
    rank, and the forced cases' logits, fed tp = 1's tokens, within
    TP_LOGIT_LIMIT and TP_GAP of tp = 1's, a gate every planted fault must
    fail; each rank's w8a8 wo, w_down and stacked expert w_down
    row-parallel equal one card's bit for bit; (b) Llama-3.2-1B at tp = 2,
    (c) Yi-9B at tp = 4, full width and depth, and (e) Mixtral-8x22B at
    depth 8 at tp = 2 (against `moe_tp1`, phase 11's bf16 run) report
    tokens/s, the decode p50, launches and collectives a step, peak memory
    per rank and the share of tokens equal to tp = 1's (bf16 sums in
    another order: reported, not gated).  A world of one on NCCL runs a
    step and its collectives.  Ranks sharing one card time a rehearsal,
    not tensor-parallel speed."""
    import shutil
    import tempfile

    from repro_torch.launch import mesh as mesh_lib

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    ref_dir = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    degree_s = {}
    try:
        t0 = time.perf_counter()
        runs = {1: tp_serve(torch, dev, seed, 1, 0, ref_dir)}
        degree_s[1] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        row_parallel = {}
        for tp in (2, 4):
            t0 = time.perf_counter()
            ranks = mesh_lib.launch_ranks(tp_rank, tp, seed, ref_dir, device=dev.type,
                                          timeout_s=900, collective_timeout_s=300)
            degree_s[tp] = time.perf_counter() - t0
            log(f"[tp] {tp} ranks on one card: {mesh_lib.rank_backend(tp, dev.type)[0]}, "
                f"{degree_s[tp]:.1f}s with their start")
            runs[tp] = [run for r in ranks for run in r["runs"]]
            row_parallel[tp] = [r["row_parallel"] for r in ranks]
    finally:
        shutil.rmtree(ref_dir, ignore_errors=True)
    log(f"[tp] wo / w_down / the experts' stacked w_down row-parallel against one "
        f"card's, largest |difference| a rank: {row_parallel} (w8a8 gated bit for bit)")

    jobs2 = tp_jobs(seed, 2)
    moe_tp1 = dict(moe_tp1, part="e", weight_gib=moe_tp1["weights_gib"],
                   label=next(j["label"] for j in jobs2 if j["part"] == "e"))
    base = {(r["part"], r["label"]): r for r in [*runs[1], moe_tp1]}
    summary = {"a": {}, "d": {}, "full": {}, "forced": {}, "planted": {},
               "row_parallel": row_parallel, "degree_s": degree_s,
               "limits": {"logit": TP_LOGIT_LIMIT, "gap": TP_GAP}}
    differ, forced_fail = [], []
    for tp in (2, 4):
        for r in runs[tp]:
            where = f"tp={tp} rank {r['rank']}"
            if r["part"] == "planted":
                summary["planted"].setdefault(r["label"], {})[where] = r["forced"]
                continue
            ref = base[(r["part"], r["label"])]
            pos = sum(len(t) for t in ref["tokens_by_uid"].values())
            eq = sum(a == b for u, t in ref["tokens_by_uid"].items()
                     for a, b in zip(t, r["tokens_by_uid"][u]))
            if r["part"] in ("a", "d"):
                summary[r["part"]].setdefault(r["label"], {})[where] = {
                    "collectives": r["collectives"], "host_copies": r["host_copies"],
                    "launches": {k: v for k, v in r["launches"].items() if v},
                    "model_cfg": r["model_cfg"], "init_s": r["init_s"],
                    "wall_s": r["wall_s"], "token_match_share": eq / pos}
                if r["tokens_by_uid"] != ref["tokens_by_uid"]:
                    differ.append(f"{r['label']} {where} ({eq}/{pos} tokens equal)")
                if "forced" in r:
                    f = r["forced"]
                    summary["forced"].setdefault(r["label"], {})[where] = f
                    if outside_tp_gate(f):
                        forced_fail.append(f"{r['label']} {where}: {f}")
                continue
            dec = r["step_ms"].get("decode", {})
            row = {k: r[k] for k in ("tok_s", "wall_s", "steps", "dispatches", "peak_gib",
                                     "start_gib", "weight_gib", "init_s", "collectives",
                                     "host_copies", "model_cfg", "step_ms")}
            row.update(decode_p50_ms=dec.get("p50_ms"), token_match_share=eq / pos,
                       requests_identical=sum(r["tokens_by_uid"][u] == t
                                              for u, t in ref["tokens_by_uid"].items()),
                       launches_per_step=sum(r["launches"].values()) / r["steps"],
                       collectives_per_dispatch={k: v / sum(r["dispatches"].values())
                                                 for k, v in r["collectives"].items()
                                                 if k.startswith("all_")})
            summary["full"].setdefault(r["label"], {})[f"tp={tp} rank {r['rank']}"] = row
            log(f"[tp] ({r['part']}) {r['label']} tp={tp} rank {r['rank']}: "
                f"{row['tok_s']:.1f} tok/s, decode p50 {row['decode_p50_ms']:.2f} ms, "
                f"{row['launches_per_step']:.0f} launches a step, collectives a dispatch "
                f"{row['collectives_per_dispatch']}, peak {row['peak_gib']:.2f} GiB "
                f"(weights {row['weight_gib']:.2f} GiB), tokens equal to tp=1's "
                f"{row['token_match_share']:.3f}, requests identical "
                f"{row['requests_identical']}/{len(ref['tokens_by_uid'])} ({smi}; ranks share "
                f"the card: a rehearsal)")
    for r in base.values():
        if r["part"] in ("b", "c", "e"):
            dec = r["step_ms"].get("decode", {})
            label = r["label"]
            summary["full"].setdefault(label, {})["tp=1"] = {
                "tok_s": r["tok_s"], "decode_p50_ms": dec.get("p50_ms"),
                "peak_gib": r["peak_gib"], "weight_gib": r["weight_gib"], "steps": r["steps"],
                "launches_per_step": sum(r["launches"].values()) / r["steps"]}
            log(f"[tp] ({r['part']}) {label} tp=1: {r['tok_s']:.1f} tok/s, decode p50 "
                f"{dec.get('p50_ms', float('nan')):.2f} ms, peak {r['peak_gib']:.2f} GiB")
    for label, ranks in summary["d"].items():
        log(f"[tp] (d) {label}: " + "; ".join(
            f"{where} {v['model_cfg']['d_ff']} FFN columns an expert, init {v['init_s']:.1f}s, "
            f"served in {v['wall_s']:.1f}s, collectives {v['collectives']}"
            for where, v in ranks.items()))
    for label, ranks in summary["forced"].items():
        log(f"[tp] {label}, fed tp=1's tokens: " + "; ".join(
            f"{where} max |dlogit| {f['max_abs_dlogit']:.4g}, argmax != tp=1's at "
            f"{f['argmax_differs']}/{f['positions']} (largest tp=1 top-2 gap there "
            f"{f['max_gap_where_differs']})" for where, f in ranks.items())
            + f" (tp=1's smallest top-2 gap {next(iter(ranks.values()))['min_gap']:.4g}, "
            f"largest |logit| {next(iter(ranks.values()))['ref_logit_absmax']:.4g})")
    plants = {j["label"]: j["plant"] for j in jobs2 if j["part"] == "planted"}
    for label, ranks in summary["planted"].items():
        log(f"[tp] planted fault, {label} without the {plants.get(label)} all-reduce, fed "
            f"tp=1's tokens: " + "; ".join(
                f"{where} max |dlogit| {f['max_abs_dlogit']:.4g}, argmax != tp=1's at "
                f"{f['argmax_differs']}/{f['positions']} (largest tp=1 top-2 gap there "
                f"{f['max_gap_where_differs']})" for where, f in ranks.items()))
    log(f"[tp] gate for the forced cases {sorted(summary['forced'])}: every logit within "
        f"{TP_LOGIT_LIMIT} of tp=1's, the argmax tp=1's wherever its top-2 gap exceeds {TP_GAP}")
    if differ:
        raise AssertionError(f"(a), (d) tokens differ from tp=1: {differ}")
    if forced_fail:
        raise AssertionError(f"forced logits outside the gate: {forced_fail}")
    missed = [label for label, ranks in summary["planted"].items()
              if not any(outside_tp_gate(f) for f in ranks.values())]
    if sorted(summary["planted"]) != sorted(plants) or missed:
        raise AssertionError(f"the gate does not catch the planted fault in {missed} "
                             f"(planted runs: {sorted(summary['planted'])})")
    # The ranks of one group hold the same logits, so emit the same tokens.
    lockstep = all(r["tokens_by_uid"] == s["tokens_by_uid"]
                   for tp in (2, 4) for r in runs[tp] for s in runs[tp]
                   if (s["part"], s["label"]) == (r["part"], r["label"]))
    if not lockstep:
        raise AssertionError("(a)-(e): the ranks of one group emitted different tokens")
    log(f"[tp] (a) {len(TP_CASES) - len(TP_FORCED)} Llama cases and (d) "
        f"{len(TP_MOE)} MoE models unquantized at tp=2 and 4 on every rank: tokens == tp=1; "
        f"{sorted(summary['forced'])} fed tp=1's tokens within the gate, which every planted "
        f"fault fails; every case: every rank the same tokens, launches and collectives == "
        f"tallied")
    launches = {}
    for tp_runs in runs.values():
        for r in tp_runs:
            for name, n in r.get("launches", {}).items():
                launches[name] = launches.get(name, 0) + n
    nccl = mesh_lib.launch_ranks(nccl_rank, 1, seed, device=dev.type, timeout_s=300)[0]
    log(f"[tp] world of one on {nccl['backend']}: a decode step's logits through each "
        f"collective unchanged {nccl['equal']}")
    if nccl["backend"] != "nccl" or not all(nccl["equal"].values()):
        raise AssertionError(f"NCCL world of one: {nccl}")
    summary.update(launches=launches, nccl=nccl, phase_s=time.perf_counter() - t_phase)
    log(f"[tp] phase 15 in {summary['phase_s']:.1f}s")
    return summary


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script runs on a GPU",
              file=sys.stderr)
        return 1
    src = os.path.join(HERE, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it from the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)

    from repro_torch.core import targets
    from repro_torch.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log(f"[build] card {smi}; python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    reports = build.build_all()
    build_s = time.perf_counter() - t0
    log(f"[build] nvcc sm_90a: {len(reports)} of {len(build.sources())} sources built "
        f"in {build_s:.1f}s")
    for name, report in reports.items():
        for line in report.splitlines():
            if "Used" in line or "spill" in line:
                log(f"[ptxas] {name}: {line.strip()}")

    results: dict = {}
    timer = Timer(torch, dev)
    t0 = time.perf_counter()
    check_kernels(torch, dev, targets.H100, timer, results)
    check_quant_kernels(torch, dev, targets.H100, timer, results)
    identity = check_decode_kernels(torch, dev, targets.H100, timer, results)
    t1 = time.perf_counter()
    identity.update(check_dense_family_attention(torch, dev, targets.H100, timer, results))
    check_dense_family_projections(torch, dev, targets.H100, timer, results)
    log(f"[kernel] dense-family shapes checked in {time.perf_counter() - t1:.1f}s")
    t1 = time.perf_counter()
    check_moe_shapes(torch, dev, targets.H100, timer, results)
    log(f"[kernel] Mixtral shapes checked in {time.perf_counter() - t1:.1f}s")
    t1 = time.perf_counter()
    check_recurrent_shapes(torch, dev, targets.H100, timer, results)
    log(f"[kernel] recurrent shapes (head dim 256) checked in {time.perf_counter() - t1:.1f}s")
    t1 = time.perf_counter()
    check_encdec_vlm_shapes(torch, dev, targets.H100, timer, results)
    log(f"[kernel] Whisper and InternVL shapes checked in {time.perf_counter() - t1:.1f}s")
    t1 = time.perf_counter()
    check_tp_shapes(torch, dev, targets.H100, timer, results)
    log(f"[kernel] tensor-parallel shard shapes checked in {time.perf_counter() - t1:.1f}s")
    check_pack_kernels(torch, dev, targets.H100, timer, results)
    sampler = check_sampler(torch, dev, timer)
    log(f"[kernel] checks done in {time.perf_counter() - t0:.1f}s")
    del timer
    torch.cuda.empty_cache()
    forward_check(torch, dev, args.seed)
    quant_forward_check(torch, dev, args.seed)
    kv_forward_check(torch, dev, args.seed)
    sampled_forward_check(torch, dev, args.seed)
    dense_forward = dense_family_forward_check(torch, dev, args.seed)
    moe_forward = moe_forward_check(torch, dev, args.seed)
    recurrent_forward = recurrent_forward_check(torch, dev, args.seed)
    encdec_vlm_forward = encdec_vlm_forward_check(torch, dev, args.seed)
    loads = len(WEIGHT_PACKS)  # models made before the serving phases
    served = serve(torch, dev, args.seed)
    windows = serve_windows(torch, dev, args.seed)
    quant = serve_quantized(torch, dev, args.seed)
    kv = serve_kv(torch, dev, args.seed)
    sampled = serve_sampled(torch, dev, args.seed, sampler)
    dense = serve_dense_family(torch, dev, args.seed)
    moe = serve_moe(torch, dev, args.seed)
    recurrent = serve_recurrent(torch, dev, args.seed)
    encdec_vlm = serve_encdec_vlm(torch, dev, args.seed)
    served_packs = sum(WEIGHT_PACKS[loads:])  # the weight packs of the served models
    chaos = chaos_check(torch, dev, args.seed)
    train = train_check(torch, dev, args.seed, smi)
    tp = serve_tp(torch, dev, args.seed, smi, moe["bf16 trace"])
    launches = {name: served["launches"][name] + tp["launches"].get(name, 0)
                + sum(r["launches"][name] for r in (*windows.values(), *quant.values(),
                                                    *kv.values(), *sampled.values(),
                                                    *dense.values(), *moe.values(),
                                                    *recurrent.values(),
                                                    *encdec_vlm.values()))
                for name in REPLACES}
    if launches["pack"] or launches["unpack"]:
        raise AssertionError(f"serving runs launched activation packs or unpacks: {launches}")
    launches["pack"] = served_packs
    idle = [name for name, n in launches.items() if n == 0 and name not in NOT_ON_SERVING_PATHS]
    if idle:
        raise AssertionError(f"kernels never launched on the serving paths: {idle}")

    table = []
    for name in REPLACES:
        row = results[name][HEADLINE[name]]
        table.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in results[name].values()),
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": HEADLINE[name],
        })
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"card": smi, "kind": kind, "build_s": build_s, "kernels": results,
                   "identity": identity, "sampler": sampler, "serve": served,
                   "windows": windows, "quant": quant, "kv": kv, "sampled": sampled,
                   "dense_forward": dense_forward, "dense": dense, "chaos": chaos,
                   "moe_forward": moe_forward, "moe": moe,
                   "recurrent_forward": recurrent_forward, "recurrent": recurrent,
                   "encdec_vlm_forward": encdec_vlm_forward, "encdec_vlm": encdec_vlm,
                   "train": train, "tp": tp, "table": table}, f, indent=1)
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
