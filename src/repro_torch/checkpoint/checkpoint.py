"""Fault-tolerant checkpointing (counterpart of repro/checkpoint/checkpoint.py).

  * atomic: leaves are written into a tmp dir, the manifest (shape, dtype
    and sha256 of every leaf) last, then the dir is renamed into place, so
    a crash mid-save never corrupts the latest checkpoint;
  * async: AsyncCheckpointer.save copies the state to host memory before
    it returns and writes it on a daemon thread, overlapping the I/O with
    the next train steps;
  * keys: each leaf is stored under its tree path (core/tree.keystr), and
    `restore` fills the structure of `like` by those keys.

numpy has no bfloat16: a bf16 leaf is stored as its uint16 bit view, with
the true dtype in the manifest, so a restore is bit for bit.  JAX's
`shardings=` restore (save on one mesh, restore on another) waits for the
port's tensor parallelism.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch.core import tree
from repro_torch.models.transformer import resolve_device


def _leaf_file(i: int) -> str:
    return f"leaf_{i:05d}.npy"


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """A leaf as a numpy array and its true dtype's name."""
    if not isinstance(leaf, torch.Tensor):
        arr = np.asarray(leaf)
        return arr, str(arr.dtype)
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), str(t.dtype).removeprefix("torch.")


def _sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def save(ckpt_dir: str, state, step: int) -> str:
    """Atomic synchronous save.  Returns the final checkpoint path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    manifest = {"step": step, "leaves": []}
    for i, (path, leaf) in enumerate(tree.leaves_with_path(state)):
        arr, dtype = _to_numpy(leaf)
        fname = _leaf_file(i)
        with open(os.path.join(tmp, fname), "wb") as f:
            np.save(f, arr)
        manifest["leaves"].append({"key": tree.keystr(path), "file": fname,
                                   "shape": list(arr.shape), "dtype": dtype,
                                   "sha256": _sha256(os.path.join(tmp, fname))})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


class AsyncCheckpointer:
    """Snapshot to host memory synchronously, write to disk on a thread; at
    most one save in flight."""

    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = ckpt_dir
        self._thread: threading.Thread | None = None

    def save(self, state, step: int) -> None:
        self.wait()
        host_state = tree.tree_map(
            lambda x: x.detach().to("cpu", copy=True) if isinstance(x, torch.Tensor) else x,
            state)
        self._thread = threading.Thread(target=save, args=(self.ckpt_dir, host_state, step),
                                        daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
                steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like, *, device: torch.device | str = "cuda",
            verify: bool = True):
    """The checkpoint of `step`, in the structure of `like` (its values are
    ignored), each leaf a tensor on `device`.  With `verify`, a leaf whose
    sha256 differs from the manifest's raises IOError."""
    device = resolve_device(device)
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    by_key = {e["key"]: e for e in manifest["leaves"]}

    out = []
    for leaf_path, _ in tree.leaves_with_path(like):
        key = tree.keystr(leaf_path)
        entry = by_key[key]
        fpath = os.path.join(path, entry["file"])
        if verify and _sha256(fpath) != entry["sha256"]:
            raise IOError(f"checksum mismatch for {key} in {path}")
        t = torch.from_numpy(np.load(fpath))
        if entry["dtype"] == "bfloat16":
            t = t.view(torch.int16).view(torch.bfloat16)
        out.append(t.to(device))
    return tree.unflatten(like, out)
