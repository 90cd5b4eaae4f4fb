"""Shared model building blocks: RMSNorm and RoPE (``repro/models/common.py``)."""
from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * gamma.float()).to(dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies [head_dim//2]."""
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, Dh]; positions: broadcastable to [..., S]. Half-split
    convention: the first and second halves of Dh form the rotated pairs."""
    dh = x.shape[-1]
    inv = rope_freqs(dh, theta, device=x.device)          # [dh/2]
    ang = positions[..., None].float() * inv              # [..., S, dh/2]
    cos = torch.cos(ang)[..., None, :]                    # [..., S, 1, dh/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
