"""Small shared utilities: logging and device resolution."""
from __future__ import annotations

import logging

import torch

logger = logging.getLogger("repro_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter(
        "[%(asctime)s repro_torch] %(message)s", "%H:%M:%S"))
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` (the current card)
    unless the caller names another. A CUDA device without a card raises — the port never carries
    on silently on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        if dev.index is None:           # "cuda" means the current card
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
