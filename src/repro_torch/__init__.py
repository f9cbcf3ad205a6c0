"""PyTorch/CUDA port of the `repro` package for NVIDIA Hopper (H100).

The module layout mirrors `repro` so that each module has a named
counterpart; `repro` stays the reference the port is tested against.  This
package imports torch, numpy and the standard library only.  Its kernels are
CUDA C++ sources under `csrc/`, built with nvcc at first use
(`kernels/build.py`).
"""
