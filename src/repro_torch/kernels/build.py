"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` source is compiled by nvcc into its own shared library with
a plain C interface, for Hopper only:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/<name>-<hash>.so csrc/<name>.cu

The libraries land in `build/kernels/` at the root of the checkout (listed in
.gitignore), named by a hash of the sources and flags so an edited source is
never served by a stale library.  All sources build at first use, one nvcc
process each, started together.  Libraries are loaded with ctypes: pointers
and the CUDA stream pass as `c_void_p`, and each C entry returns
`cudaGetLastError()`, which `check` turns into an exception.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(PKG_DIR)), "build", "kernels")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: dict[str, ctypes.CDLL] = {}


def sources() -> dict[str, str]:
    """{library name: .cu path} for every kernel source in the package."""
    return {
        os.path.splitext(os.path.basename(p))[0]: p
        for p in sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    }


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels build only where the CUDA "
        "toolkit is installed (on the PATH or under /usr/local/cuda)"
    )


def _lib_path(name: str, src: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src] + sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build_all() -> dict[str, str]:
    """Compile every source whose library is missing, all nvcc processes at
    once.  Returns nvcc's output per compiled source (the -Xptxas -v report:
    registers, shared memory, spills); raises with it if any compile fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for name, src in sources().items():
        out = _lib_path(name, src)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", CSRC_DIR, "-o", tmp, src]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    failed = []
    reports = {}
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name} (exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The shared library built from csrc/<name>.cu, building all at first use."""
    lib = _libs.get(name)
    if lib is None:
        src = sources()[name]
        path = _lib_path(name, src)
        if not os.path.exists(path):
            build_all()
        lib = ctypes.CDLL(path)
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def entry(lib_name: str, fn_name: str, argtypes: list) -> ctypes._CFuncPtr:
    """A C entry point with its argument types declared (c_void_p for every
    pointer and the stream, so ctypes never truncates one to 32 bits)."""
    fn = getattr(load(lib_name), fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(err: int, lib_name: str, what: str) -> None:
    if err != 0:
        msg = load(lib_name).error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def dtype_code(dtype) -> int:
    """The C entries' dtype argument: 0 float32, 1 bfloat16 (csrc/common.cuh)."""
    import torch

    codes = {torch.float32: 0, torch.bfloat16: 1}
    if dtype not in codes:
        raise TypeError(f"kernels take float32 or bfloat16 inputs, got {dtype}")
    return codes[dtype]


def stream_ptr(device) -> int:
    """PyTorch's current CUDA stream on `device`, as the integer the C
    entries take (kernels launch on it and never synchronise)."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def aligned(t):
    """`t` contiguous with a 16-byte aligned base, the kernels' vector loads'
    contract (a contiguous view into a larger tensor may start anywhere)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()
