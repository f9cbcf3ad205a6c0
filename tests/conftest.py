"""Shared pytest fixtures.

The tier-1 suite runs as ONE process and jit-compiles thousands of XLA
executables (every engine config x phase x shape bucket keeps its own).
Each live executable holds several memory mappings, and a long run walks
the process into the kernel's vm.max_map_count ceiling (65530 by default)
— at which point an mmap inside XLA's compiler fails and the process
segfaults mid-compile, tens of minutes in.  Executables are only ever
shared within a test module (each module builds its own engines), so
dropping the jit caches at module boundaries bounds the peak map count at
"one module's worth" for the cost of re-tracing a handful of common
shapes per module.
"""

import jax
import pytest


@pytest.fixture(autouse=True, scope="module")
def _bound_xla_executable_footprint():
    yield
    jax.clear_caches()


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU (the port's CUDA kernels); skips where "
        "torch.cuda.is_available() is False",
    )
