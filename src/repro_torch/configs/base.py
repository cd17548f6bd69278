"""Architecture config registry — the port's copy of ``repro.configs.base``
(the port imports nothing of the JAX package, so it keeps its own).

Each assigned architecture lives in its own module exposing ``config()``
(the exact published numbers) and ``reduced()`` (a same-family miniature for
CPU smoke tests: few layers, small width, tiny vocab/experts).  Select with
``--arch <id>`` in the launchers.
"""

from __future__ import annotations

import importlib

from repro_torch.models.model_api import ArchConfig

ARCH_IDS = (
    "whisper-base",
    "grok-1-314b",
    "deepseek-moe-16b",
    "qwen2-1.5b",
    "chatglm3-6b",
    "command-r-plus-104b",
    "llama3-405b",
    "rwkv6-1.6b",
    "jamba-1.5-large-398b",
    "llava-next-mistral-7b",
)

_MODULES = {
    "whisper-base": "whisper_base",
    "grok-1-314b": "grok1_314b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "qwen2-1.5b": "qwen2_1_5b",
    "chatglm3-6b": "chatglm3_6b",
    "command-r-plus-104b": "command_r_plus_104b",
    "llama3-405b": "llama3_405b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
}


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise ValueError(f"unknown arch {arch_id!r}; available: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def get_config(arch_id: str) -> ArchConfig:
    return _module(arch_id).config()


def get_reduced_config(arch_id: str) -> ArchConfig:
    return _module(arch_id).reduced()
