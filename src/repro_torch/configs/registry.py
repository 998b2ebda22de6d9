"""Architecture registry: ``--arch <id>`` resolution for every arch of the
reference package, ferrari-web (the paper's own system as a servable
cell) included."""
from __future__ import annotations

import importlib
from typing import Dict

_MODULES: Dict[str, str] = {
    "llama3-8b": "llama3_8b",
    "smollm-360m": "smollm_360m",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b",
    "gcn-cora": "gcn_cora",
    "graphsage-reddit": "graphsage_reddit",
    "gatedgcn": "gatedgcn",
    "gin-tu": "gin_tu",
    "mind": "mind",
    "ferrari-web": "ferrari_web",
}

ARCHS = tuple(_MODULES)
ASSIGNED_ARCHS = tuple(a for a in ARCHS if a != "ferrari-web")


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: {ARCHS}")
    return importlib.import_module(f"{__package__}.{_MODULES[arch]}")


def get_config(arch: str):
    return _module(arch).CONFIG


def get_smoke(arch: str):
    return _module(arch).SMOKE
