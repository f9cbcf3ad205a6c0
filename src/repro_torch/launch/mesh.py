"""Serving meshes over torch.distributed (counterpart of repro/launch/mesh.py).

A rank is one process.  `build_serving_mesh` turns EngineConfig.mesh_shape
into this process's place in the mesh: the trailing axis is the
tensor-parallel axis ("model", the name parallel/sharding.py's rules key
on), the leading axes are ("data",) or ("pod", "data") replicas, each
replica a tensor-parallel group of its own.  It raises ValueError, never a
silent mesh=1, when the process group's world size cannot cover the shape,
and says how to start that many ranks.

`launch_ranks` starts the ranks itself (torch.multiprocessing with the spawn
start method, the only one safe once CUDA is initialised; no torchrun):
each child initialises the process group on a file under a fresh temporary
directory and runs `fn(rank, world, device, *args)`.  The backend is NCCL
where each rank has a GPU of its own, gloo on the CPU, and gloo where
several ranks share one card (NCCL refuses two ranks on one device).  A
mesh on NCCL also gets a gloo group for host decisions (clock readings,
allocator stats).  Every group is made with a timeout of seconds, and the
parent waits for its ranks with one, so a deadlock fails fast.

`make_mesh_for`, `data_axes` and `model_axes` are the JAX module's, for the
elastic re-mesh of a later slice; they describe a mesh's shape and make no
group.  JAX's `make_production_mesh` (a TPU pod's 16 x 16 or 2 x 16 x 16
grid) has no counterpart here.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
import queue as queue_lib
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# Axis naming per mesh rank: the trailing axis is always the TP axis.
_SERVING_AXES = {1: (), 2: ("data",), 3: ("pod", "data")}

# Seconds a collective may wait before the group raises.
DEFAULT_TIMEOUT_S = 120.0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A mesh's axes and their sizes (JAX's Mesh.axis_names and Mesh.shape)."""

    axis_names: tuple[str, ...]
    shape: dict


@dataclasses.dataclass(frozen=True)
class ServingMesh(Mesh):
    """This rank's place in a serving mesh: its tensor-parallel group (None
    at tp = 1), its index in it, and the group host decisions go over
    (gloo; the tensor-parallel group itself when that is gloo)."""

    tp_group: object = None
    host_group: object = None
    tp_rank: int = 0
    tp_size: int = 1
    backend: str = "none"


def _launch_hint(need: int) -> str:
    return (f"start {need} ranks: `python -m repro_torch.launch.serve --mesh-shape {need}` "
            f"spawns them, as does repro_torch.launch.mesh.launch_ranks(fn, {need}); or call "
            f"torch.distributed.init_process_group(world_size={need}, rank=r, ...) in each "
            f"of {need} processes")


def build_serving_mesh(mesh_shape: tuple[int, ...], *, tp_axis: str = "model") -> ServingMesh:
    """This process's serving mesh of shape `mesh_shape` over the default
    process group.  The world size must equal the mesh's size: one rank a
    device.  A one-device mesh needs no process group."""
    shape = tuple(int(n) for n in mesh_shape)
    if not shape or any(n < 1 for n in shape):
        raise ValueError(f"mesh_shape must be a non-empty tuple of positive ints, "
                         f"got {mesh_shape!r}")
    if len(shape) > 3:
        raise ValueError(f"mesh_shape supports at most 3 axes, got {mesh_shape!r}")
    axes = _SERVING_AXES[len(shape)] + (tp_axis,)
    sizes = dict(zip(axes, shape))
    need = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if need != world:
        where = ("this process is in no process group (world size 1)"
                 if not dist.is_initialized() else f"the process group has {world} ranks")
        raise ValueError(f"mesh_shape {shape} needs {need} ranks but {where}; "
                         + _launch_hint(need))
    if need == 1:
        return ServingMesh(axes, sizes)
    tp = shape[-1]
    rank = dist.get_rank()
    backend = dist.get_backend()
    timeout = datetime.timedelta(seconds=DEFAULT_TIMEOUT_S)
    tp_group = host_group = None
    # Every rank makes every group, in the same order (torch.distributed's rule).
    for r in range(need // tp):
        ranks = list(range(r * tp, (r + 1) * tp))
        g = dist.group.WORLD if tp == need else dist.new_group(ranks, timeout=timeout)
        h = g if backend == "gloo" else dist.new_group(ranks, backend="gloo", timeout=timeout)
        if rank in ranks:
            tp_group, host_group = g, h
    return ServingMesh(axes, sizes, tp_group=tp_group, host_group=host_group,
                       tp_rank=rank % tp, tp_size=tp, backend=backend)


def make_mesh_for(devices: int, *, model_parallel: int = 1) -> Mesh:
    """Elastic mesh: the largest (data, model) grid for the surviving device
    count (runtime/elastic.py, when a slice comes back with fewer cards)."""
    model_parallel = max(1, min(model_parallel, devices))
    while devices % model_parallel:
        model_parallel -= 1
    return Mesh(("data", "model"), {"data": devices // model_parallel, "model": model_parallel})


def data_axes(mesh) -> tuple[str, ...]:
    """Axes carrying the batch (DP/FSDP): ('pod','data') on multi-pod."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def model_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a == "model")


# ---- starting ranks -----------------------------------------------------------------


def rank_backend(world: int, device: str) -> tuple[str, list[str]]:
    """(backend, each rank's device) for `world` ranks on `device` ("cpu" or
    "cuda"): NCCL with a card per rank where there are enough cards, else
    gloo (the CPU, or ranks sharing cuda:0)."""
    if torch.device(device).type != "cuda":
        return "gloo", ["cpu"] * world
    if torch.cuda.device_count() >= world:
        return "nccl", [f"cuda:{r}" for r in range(world)]
    return "gloo", ["cuda:0"] * world


def _rank_main(rank: int, world: int, backend: str, device: str, init_file: str,
               timeout_s: float, results, fn, args) -> None:
    """A child's body: join the group, run fn, report (rank, ok, value)."""
    try:
        if device.startswith("cuda"):
            torch.cuda.set_device(torch.device(device))
        else:  # ranks on the CPU share its cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // (2 * world)))
        dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=timeout_s))
        try:
            value = fn(rank, world, device, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, value))
    except BaseException:  # the parent raises it with this traceback
        results.put((rank, False, traceback.format_exc()))
        raise


def launch_ranks(fn, world: int, *args, device: str = "cpu", timeout_s: float = 600.0,
                 collective_timeout_s: float = DEFAULT_TIMEOUT_S) -> list:
    """Run fn(rank, world, device, *args) in `world` spawned ranks of one
    process group and return their values in rank order.  `fn` must be
    importable by the children (a module-level function) and return plain
    data (numbers, lists, dicts, numpy arrays): a torch tensor would travel
    as shared memory of a process that has exited.  Raises
    RuntimeError with the child's traceback if a rank fails, TimeoutError
    if the ranks have not all returned within `timeout_s` (the others are
    then terminated); every child is joined before this returns."""
    backend, devices = rank_backend(world, device)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    root = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    init_file = os.path.join(root, "init")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, backend, devices[r], init_file, collective_timeout_s,
                               results, fn, args), daemon=True)
             for r in range(world)]
    out: dict[int, object] = {}
    clean = False
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while len(out) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{world - len(out)} of {world} ranks had not returned "
                                   f"after {timeout_s:.0f}s (ranks done: {sorted(out)})")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue_lib.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} and no result")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{value}")
            out[rank] = value
        clean = True
    finally:
        for p in procs:  # a failed launch stops the ranks still blocked in a collective
            p.join(timeout=10 if clean else 0)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        shutil.rmtree(root, ignore_errors=True)
    return [out[r] for r in range(world)]
