"""Architecture registry: ``--arch <id>`` resolution (counterpart of
repro/configs/registry.py).  Only the paper's own model is ported so far;
the other families wait for their slices (ROADMAP)."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, reduced

_ARCH_MODULES = {
    "llama3.2-1b": "repro_torch.configs.llama3_2_1b",
}


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; ported so far: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch]).CONFIG


def get_reduced(arch: str, **overrides) -> ModelConfig:
    return reduced(get_config(arch), **overrides)
