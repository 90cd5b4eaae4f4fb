"""Architecture registry: ``get_config("--arch id")`` resolution.

The port carries every configuration of the reference registry: the five
LMs of ``launch.serve --arch`` (dense ``llama3-8b`` and ``minitron-8b``,
sliding-window ``h2o-danube-3-4b``, MoE ``olmoe-1b-7b`` and
``granite-moe-3b-a800m``), the off-path models (``graphsage-reddit``, and
the recsys ``mind``, ``wide-deep``, ``bert4rec`` and ``fm``) and MeMemo's
own retrieval setting."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    ArchConfig,
    GNNConfig,
    LMConfig,
    MoEConfig,
    RecsysConfig,
    RetrievalConfig,
    ShapeSpec,
    GNN_SHAPES,
    LM_SHAPES,
    RECSYS_SHAPES,
)

_MODULES = {
    "llama3-8b": "llama3_8b",
    "h2o-danube-3-4b": "h2o_danube3_4b",
    "minitron-8b": "minitron_8b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "granite-moe-3b-a800m": "granite_moe_3b",
    "graphsage-reddit": "graphsage_reddit",
    "mind": "mind",
    "wide-deep": "wide_deep",
    "bert4rec": "bert4rec",
    "fm": "fm",
    "mememo": "mememo",
}

# every model configuration; mememo is the retrieval setting, not a model
ASSIGNED_ARCHS = tuple(a for a in _MODULES if a != "mememo")
ALL_ARCHS = tuple(_MODULES)


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def get_config(arch_id: str) -> ArchConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str):
    return _module(arch_id).smoke_config()


def list_archs() -> list[str]:
    return list(ALL_ARCHS)
