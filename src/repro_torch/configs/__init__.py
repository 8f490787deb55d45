"""Model configurations the port runs (``--arch <id>``).

Each module defines ``CONFIG`` (the full-scale configuration, as in the JAX
package's ``repro.configs``) and ``reduced()`` (a tiny configuration of the
same family for CPU tests).  ``ARCHS`` is the JAX package's list, in its
order: the dense GQA decoders (gemma3-12b with its local / global windows,
qwen2.5-14b, minitron-8b, nemotron-4-340b), the MoE decoders
granite-moe-3b-a800m and deepseek-v2-lite-16b (MLA, shared experts, a
leading dense layer), the encoder-decoder whisper-medium, pixtral-12b with
its stub patch prefix, RWKV6 (rwkv6-1.6b), and the hybrid hymba-1.5b
(windowed GQA attention beside SSD heads in every layer).
"""
from __future__ import annotations

import importlib

from ..models.config import ModelConfig

ARCHS = ["gemma3-12b", "qwen2.5-14b", "minitron-8b", "nemotron-4-340b",
         "granite-moe-3b-a800m", "deepseek-v2-lite-16b", "whisper-medium",
         "pixtral-12b", "rwkv6-1.6b", "hymba-1.5b"]

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCHS}


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; the port runs: {ARCHS}")
    return importlib.import_module(f".{_MODULES[name]}", __package__).CONFIG


def get_reduced_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; the port runs: {ARCHS}")
    return importlib.import_module(f".{_MODULES[name]}", __package__).reduced()
