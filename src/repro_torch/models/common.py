"""Shared model building blocks (``repro/models/common.py``): the norms,
RoPE, initialisation from a ``torch.Generator``, the losses, and the
products at a compute dtype.

The reference casts each weight to the compute dtype where it is used
(``_w``: ``lp[name].astype(dtype)``) and multiplies with
``preferred_element_type=float32``: products of ``dtype`` operands summed
in fp32, the result fp32 until the caller casts it. ``weight`` is that
cast, and ``linear_f32``/``bmm_f32`` that product: on the card one
``torch.mm``/``torch.bmm`` with an fp32 output where PyTorch has the
``out_dtype`` overload, else (and on the CPU, which has no kernel for it)
the operands widened to fp32, which is exact for bf16 and fp16.
``linear`` is the product the reference casts straight back to
``dtype``: on the card one 16-bit ``F.linear`` (cuBLAS sums in fp32 and
rounds once, as the fp32 product and a cast would, in one launch less;
``scripts/time_bf16_products.py``), elsewhere ``linear_f32`` and the
cast. fp32 operands take the plain fp32 product, so an fp32 model runs
as before.

PyTorch gives the ``out_dtype`` overload no derivative, so on the card
that product runs inside ``_ProductF32``, an autograd ``Function`` whose
backward computes what autograd computes on the widened operands: the
fp32 gradient of the fp32 result multiplied by the other operand widened
to fp32, then rounded to the operand's own dtype.
"""
from __future__ import annotations

import copy

import torch
from torch.nn import functional as F

# PyTorch's mm/bmm with an fp32 output from 16-bit operands (CUDA only)
_OUT_DTYPE = ("dtype" in torch.ops.aten.mm.overloads()
              and "dtype" in torch.ops.aten.bmm.overloads())


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * gamma.float()).to(dtype)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis in fp32 (the population variance, as
    ``jnp.var``), cast back to ``x``'s dtype."""
    dtype = x.dtype
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * gamma.float() + beta.float()).to(dtype)


def normal_init(generator: torch.Generator, shape, scale: float = 0.02
                ) -> torch.Tensor:
    """N(0, scale^2) fp32 draws from ``generator``, on its device."""
    return scale * torch.randn(shape, generator=generator,
                               device=generator.device)


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


def weight(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A weight in the compute dtype (the reference's ``_w``): itself when
    it already is, else a rounded copy."""
    return w if w.dtype == dtype else w.to(dtype)


def _f32_out(a: torch.Tensor, b: torch.Tensor) -> bool:
    """True when ``a @ b`` can run as one product with an fp32 output: on
    the card, and on ``meta``, where a dry run counts the card's ops."""
    return a.device.type in ("cuda", "meta") and _OUT_DTYPE and \
        a.dtype == b.dtype and \
        a.dtype in (torch.bfloat16, torch.float16)


class _ProductF32(torch.autograd.Function):
    """``a @ b`` of two 16-bit operands as one ``torch.mm`` (2-D) or
    ``torch.bmm`` (3-D) with an fp32 output. The backward is the widened
    path's: grad_a = (g @ b.float()ᵀ) in a's dtype, grad_b = (a.float()ᵀ
    @ g) in b's dtype, the products in fp32."""

    @staticmethod
    def forward(ctx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(a, b)
        mm = torch.mm if a.dim() == 2 else torch.bmm
        return mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = (g @ b.float().transpose(-1, -2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = (a.float().transpose(-1, -2) @ g).to(b.dtype)
        return ga, gb


def linear_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., in] times w [out, in] transposed -> [..., out] fp32."""
    if x.dtype == w.dtype == torch.float32:
        return F.linear(x, w)
    if _f32_out(x, w):
        out = _ProductF32.apply(x.reshape(-1, x.shape[-1]), w.t())
        return out.reshape(*x.shape[:-1], w.shape[0])
    return F.linear(x.float(), w.float())


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., in] times w [out, in] transposed -> [..., out] in x's dtype
    (w already in it), summed in fp32 and rounded once."""
    if x.dtype == torch.float32 or _f32_out(x, w):
        return F.linear(x, w)
    return linear_f32(x, w).to(x.dtype)


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [E, C, D] times b [E, D, F] -> [E, C, F] fp32."""
    if a.dtype == b.dtype == torch.float32:
        return torch.bmm(a, b)
    if _f32_out(a, b):
        return _ProductF32.apply(a, b)
    return torch.bmm(a.float(), b.float())


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean cross-entropy; logits [..., V], labels [...] integer; with
    ``mask``, the mean over the positions it weights."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return torch.mean(nll)


def sigmoid_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logits = logits.float()
    labels = labels.float()
    return torch.mean(torch.clamp_min(logits, 0) - logits * labels
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    xf = x.float()
    n = torch.sqrt(torch.sum(torch.square(xf), dim=dim, keepdim=True))
    return (xf / torch.clamp_min(n, eps)).to(x.dtype)


def named_tensors(tree, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """(name, tensor) for each tensor of a parameter tree, in order: an
    ``nn.Module``'s named parameters (an ``LM``'s names are its
    ``state_dict`` keys), the leaves of nested dicts and lists named by
    their keys and indices joined with dots (``deep.0.w``)."""
    if isinstance(tree, torch.nn.Module):
        return [(prefix + n, p) for n, p in tree.named_parameters()]
    if isinstance(tree, torch.Tensor):
        return [(prefix[:-1], tree)]
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    return [nt for k, v in items
            for nt in named_tensors(v, f"{prefix}{k}.")]


def tree_tensors(tree) -> list[torch.Tensor]:
    """The tensors of a parameter tree: an ``nn.Module``'s parameters, or
    the leaves of nested dicts and lists (of tensors and modules)."""
    return [t for _, t in named_tensors(tree)]


def count_params(tree) -> int:
    return sum(t.numel() for t in tree_tensors(tree))


def tree_map(fn, tree):
    """The same nesting of dicts and lists with ``fn`` applied to each
    leaf (a tensor, an array or a module)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_to(tree, device):
    """The parameter tree on ``device``: each tensor moved, each module
    copied and moved."""
    return tree_map(lambda t: (copy.deepcopy(t) if isinstance(
        t, torch.nn.Module) else t).to(device), tree)
