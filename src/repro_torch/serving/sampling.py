"""Temperature sampling (counterpart of what repro/serving/engine.py takes
from jax.random for make_decode_step(sample="temperature")).

The JAX engine draws its noise from Threefry-2x32 keys: a base key
PRNGKey(seed), one fold_in(base, step) key per decode dispatch, and
categorical() over the (B, V) logits, which adds low-mode Gumbel noise made
from the partitionable random bits of the (B, V) shape and takes the
argmax.  This module reproduces those functions bit for bit:

    prng_key(seed)          (0, seed & 0xFFFFFFFF), JAX's 32-bit mode
    fold_in(key, d)         threefry2x32(key, (0, d))
    random_bits(key, shape) x0 ^ x1 of threefry2x32(key, (i >> 32, i & M))
                            over the flat index i of every element
    uniform(key, shape)     the top 23 bits as a float in [1, 2), minus 1,
                            scaled to [minval, maxval) and clipped at minval
    gumbel(key, shape)      -log(-log(uniform(minval=tiny, maxval=1))), each log
                            taken in float64 and rounded to float32
    categorical(key, l)     argmax(gumbel(key, l.shape) + l, axis=-1)

Keys are pairs of Python ints (fold_in costs no device work); the bits are
computed in int64 tensors holding uint32 values, on the logits' device, so
the card and the CPU give the same integers.  Only the two logs may differ
from XLA's in the last bit: each is taken in float64 and rounded to float32
(XLA's order of two float32 logs, each correctly rounded but for the double
rounding), so the noise does not hang on the float32 log of the process's
math library or its state.  This is plain PyTorch: JAX computes it outside
any Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
TINY = float(np.finfo(np.float32).tiny)

Key = tuple[int, int]


def _rotl(x, r: int):
    return ((x << r) & M32) | (x >> (32 - r))


def threefry2x32(key: Key, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of the counter pairs (x0, x1)
    under `key`; Python ints or int64 tensors holding uint32 values."""
    ks = (key[0], key[1], key[0] ^ key[1] ^ _PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def prng_key(seed: int) -> Key:
    """jax.random.PRNGKey(seed) with 32-bit integers (JAX's default): the
    key holds the seed's low 32 bits."""
    return (0, int(seed) & M32)


def fold_in(key: Key, data: int) -> Key:
    """jax.random.fold_in(key, data)."""
    return threefry2x32(key, 0, int(data) & M32)


def random_bits(key: Key, shape: tuple[int, ...], device="cpu") -> torch.Tensor:
    """The 32-bit random bits jax.random.bits(key, shape) gives with
    jax_threefry_partitionable, as int64 values in [0, 2**32)."""
    idx = torch.arange(int(np.prod(shape)), dtype=torch.int64, device=device)
    x0, x1 = threefry2x32(key, idx >> 32, idx & M32)
    return (x0 ^ x1).reshape(shape)


def uniform(key: Key, shape: tuple[int, ...], *, minval: float = 0.0, maxval: float = 1.0,
            device="cpu") -> torch.Tensor:
    """jax.random.uniform(key, shape, float32, minval, maxval)."""
    bits = random_bits(key, shape, device)
    one = 0x3F800000  # the bits of 1.0f
    floats = ((bits >> 9) | one).to(torch.int32).view(torch.float32) - 1.0
    lo = np.float32(minval)
    span = float(np.float32(maxval) - lo)
    if span == 1.0:  # floats * 1 + lo rounds once in f32, as XLA's fused form
        scaled = floats + float(lo)
    else:  # XLA fuses the multiply-add: one rounding of the exact value
        scaled = (floats.double() * span + float(lo)).float()
    return torch.clamp_min(scaled, float(lo))


def gumbel(key: Key, shape: tuple[int, ...], device="cpu") -> torch.Tensor:
    """jax.random.gumbel(key, shape, float32) in its default "low" mode:
    -log(-log(u)) with each log in float64, rounded to float32 before the
    next step."""
    u = uniform(key, shape, minval=TINY, maxval=1.0, device=device)
    inner = torch.log(u.double()).float()
    return -torch.log(-inner.double()).float()


def categorical(key: Key, logits: torch.Tensor) -> torch.Tensor:
    """jax.random.categorical(key, logits, axis=-1) of float32 logits."""
    return torch.argmax(gumbel(key, tuple(logits.shape), logits.device) + logits, dim=-1)


def sample_rows(logits: torch.Tensor, temp: torch.Tensor, key: Key) -> torch.Tensor:
    """Next token of every row, the body of JAX's decode_sampled: rows with
    temp > 0 sample softmax(logits / temp), the others take the argmax.
    logits (B, V); temp (B,) float32 on the logits' device; returns (B,)
    int64."""
    last = logits.float()
    greedy = torch.argmax(last, dim=-1)
    scaled = last / torch.clamp_min(temp, 1e-6)[:, None]
    sampled = categorical(key, scaled)
    return torch.where(temp > 0, sampled, greedy)
