"""Deterministic synthetic data pipeline with per-host sharding (copy of
repro/data/pipeline.py; the port imports nothing of the JAX package).

The "corpus" is a seeded synthetic token stream: documents of random length
whose tokens follow a fixed random bigram table, so the loss actually
falls.  (seed, host_id, num_hosts, step) fully determines a batch: a
restart replays the identical stream, and no two hosts overlap.  Documents
are packed into fixed-length rows with EOS separators; labels are the
tokens shifted by one.  The batches are numpy, bit for bit the JAX
package's; `to_torch` moves one onto the trainer's device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    mean_doc_len: int = 64
    eos_id: int = 0


class SyntheticPacked:
    """Iterator of {'tokens', 'labels'} with deterministic per-step content."""

    def __init__(self, cfg: DataConfig, *, host_id: int = 0, num_hosts: int = 1):
        if cfg.global_batch % num_hosts:
            raise ValueError(f"global_batch {cfg.global_batch} is not a multiple of "
                             f"num_hosts {num_hosts}")
        self.cfg = cfg
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.local_batch = cfg.global_batch // num_hosts
        # A fixed random bigram table gives the stream learnable structure.
        rng = np.random.RandomState(cfg.seed)
        self._succ = rng.randint(1, cfg.vocab_size, size=(min(cfg.vocab_size, 4096),),
                                 dtype=np.int64)

    def _doc(self, rng: np.random.RandomState) -> np.ndarray:
        n = max(2, int(rng.exponential(self.cfg.mean_doc_len)))
        start = rng.randint(1, self.cfg.vocab_size)
        toks = [start]
        t = len(self._succ)
        for _ in range(n - 1):
            nxt = (self._succ[toks[-1] % t] + rng.randint(0, 3)) % self.cfg.vocab_size
            toks.append(max(1, int(nxt)))
        return np.asarray(toks, np.int32)

    def batch(self, step: int) -> dict:
        c = self.cfg
        rows = np.zeros((self.local_batch, c.seq_len + 1), np.int32)
        for r in range(self.local_batch):
            rng = np.random.RandomState(
                ((c.seed * 1_000_003 + step) * 65_537 + (self.host_id * self.local_batch + r))
                % (2**32 - 1)
            )
            fill = 0
            while fill < c.seq_len + 1:
                doc = self._doc(rng)
                take = min(len(doc), c.seq_len + 1 - fill)
                rows[r, fill:fill + take] = doc[:take]
                fill += take
                if fill < c.seq_len + 1:
                    rows[r, fill] = c.eos_id
                    fill += 1
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:].astype(np.int32)}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class Prefetcher:
    """One-batch lookahead on a worker thread (hides host data latency)."""

    def __init__(self, it):
        import queue
        import threading

        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._it = iter(it)

        def work():
            for item in self._it:
                self._q.put(item)

        self._t = threading.Thread(target=work, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self):
        return self._q.get()


def to_torch(batch: dict, device: torch.device | str) -> dict:
    """A numpy batch as tensors on `device`: integer leaves (tokens, labels)
    as int64, the index type of the embedding gather and the loss's
    gather; float leaves (frames, patches) as they are."""
    out = {}
    for key, arr in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(arr))
        out[key] = (t.long() if not t.is_floating_point() else t).to(device)
    return out
