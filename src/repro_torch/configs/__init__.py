"""Model configurations the port runs (``--arch <id>``).

Each module defines ``CONFIG`` (the full-scale configuration, as in the JAX
package's ``repro.configs``) and ``reduced()`` (a tiny configuration of the
same family for CPU tests).  ``ARCHS`` lists only what the port supports:
the dense GQA decoder (qwen2.5-14b) and RWKV6 (rwkv6-1.6b).
"""
from __future__ import annotations

import importlib

from ..models.config import ModelConfig

ARCHS = ["qwen2.5-14b", "rwkv6-1.6b"]

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCHS}


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; the port runs: {ARCHS}")
    return importlib.import_module(f".{_MODULES[name]}", __package__).CONFIG


def get_reduced_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; the port runs: {ARCHS}")
    return importlib.import_module(f".{_MODULES[name]}", __package__).reduced()
