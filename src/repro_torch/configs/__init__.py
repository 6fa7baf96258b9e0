"""Architecture registry: one module per assigned architecture (``--arch <id>``).

Each module exposes ``build()`` (the exact published config) and ``smoke()``
(a reduced same-family config for CPU tests).  ``get_config`` / ``get_smoke``
resolve canonical dash-separated ids.  The same registry and modules as
``repro.configs``, on the port's own ``ModelConfig``.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from ..models.config import ModelConfig

_ARCH_MODULES: Dict[str, str] = {
    "phi3-medium-14b": "phi3_medium_14b",
    "yi-6b": "yi_6b",
    "h2o-danube-3-4b": "h2o_danube_3_4b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "mixtral-8x22b": "mixtral_8x22b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "zamba2-2.7b": "zamba2_2_7b",
    "internvl2-1b": "internvl2_1b",
    "musicgen-medium": "musicgen_medium",
    "mamba2-2.7b": "mamba2_2_7b",
}

ARCH_IDS: List[str] = list(_ARCH_MODULES)


def _module(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCH_IDS}")
    return importlib.import_module(f".{_ARCH_MODULES[arch]}", __package__)


def get_config(arch: str) -> ModelConfig:
    return _module(arch).build()


def get_smoke(arch: str) -> ModelConfig:
    return _module(arch).smoke()
