"""Architecture registry: ``--arch <id>`` resolution (counterpart of
repro/configs/registry.py): the JAX package's eleven configs, the paper's
own model (Llama-3.2-1B), the dense family, the MoE family (Mixtral-8x22B,
Grok-1-314B), the recurrent families (RWKV6-1.6B, RecurrentGemma-9B), the
encoder-decoder Whisper-tiny and the VLM InternVL2-26B.  The last two run
through models/transformer.forward (frames or patches beside the tokens);
the serving engine takes tokens only and refuses them."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, reduced

_ARCH_MODULES = {
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    "grok-1-314b": "repro_torch.configs.grok_1_314b",
    "qwen2.5-14b": "repro_torch.configs.qwen2_5_14b",
    "qwen2.5-32b": "repro_torch.configs.qwen2_5_32b",
    "qwen2-1.5b": "repro_torch.configs.qwen2_1_5b",
    "yi-9b": "repro_torch.configs.yi_9b",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
    "rwkv6-1.6b": "repro_torch.configs.rwkv6_1_6b",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
    "internvl2-26b": "repro_torch.configs.internvl2_26b",
    "llama3.2-1b": "repro_torch.configs.llama3_2_1b",
}


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; ported so far: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch]).CONFIG


def get_reduced(arch: str, **overrides) -> ModelConfig:
    return reduced(get_config(arch), **overrides)
