"""Architecture registry: ``get_config("--arch id")`` resolution.

The port carries the configurations its slices serve: the five LMs of
``launch.serve --arch`` (dense ``llama3-8b`` and ``minitron-8b``,
sliding-window ``h2o-danube-3-4b``, MoE ``olmoe-1b-7b`` and
``granite-moe-3b-a800m``) and MeMemo's own retrieval setting. The
reference registry's non-LM architectures wait for the off-path models
of ROADMAP.md §1 item 5 and raise ``NotImplementedError`` here."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    ArchConfig,
    LMConfig,
    MoEConfig,
    RetrievalConfig,
    ShapeSpec,
    LM_SHAPES,
)

_MODULES = {
    "llama3-8b": "llama3_8b",
    "h2o-danube-3-4b": "h2o_danube3_4b",
    "minitron-8b": "minitron_8b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "granite-moe-3b-a800m": "granite_moe_3b",
    "mememo": "mememo",
}

# reference architectures not ported yet: the off-path models
# (ROADMAP.md §1, item 5)
_NOT_PORTED = ("graphsage-reddit", "mind", "wide-deep", "bert4rec", "fm")

ALL_ARCHS = tuple(_MODULES)


def _module(arch_id: str):
    if arch_id in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported yet (ROADMAP.md §1 item 5)")
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def get_config(arch_id: str) -> ArchConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str):
    return _module(arch_id).smoke_config()


def list_archs() -> list[str]:
    return list(ALL_ARCHS)
