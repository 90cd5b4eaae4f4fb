"""Architecture registry: ``get_config("--arch id")`` resolution.

The port carries the configurations its slices serve: the dense
``llama3-8b`` LM and MeMemo's own retrieval setting. The other
architectures of the reference registry wait for the off-path item of
ROADMAP.md §1 (item 12) and raise ``NotImplementedError`` here."""
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
    "mememo": "mememo",
}

# reference architectures not ported yet (ROADMAP.md §1, item 12)
_NOT_PORTED = ("h2o-danube-3-4b", "minitron-8b", "olmoe-1b-7b",
               "granite-moe-3b-a800m", "graphsage-reddit", "mind",
               "wide-deep", "bert4rec", "fm")

ALL_ARCHS = tuple(_MODULES)


def _module(arch_id: str):
    if arch_id in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported yet (ROADMAP.md §1 item 12)")
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def get_config(arch_id: str) -> ArchConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str):
    return _module(arch_id).smoke_config()


def list_archs() -> list[str]:
    return list(ALL_ARCHS)
