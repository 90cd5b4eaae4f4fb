"""Top-k token-choice MoE with capacity dropping (GShard/Switch style),
ported from ``repro/models/moe.py``.

Dispatch is the reference's scatter/gather form: each (token, k)
assignment's position within its expert comes from the one-hot cumsum
over the flattened (token, k) order, an assignment at position >= C (the
expert's capacity) is dropped to the sink slot E * C, and each expert
multiplies its [C, D] buffer of gathered tokens. The expert products are
``torch.bmm`` over the expert axis (plain matrix products, which the
reference leaves to XLA).

Dtypes, as the reference's at a compute dtype: the router runs in fp32;
the gathered rows are in the tokens' dtype and the expert weights are
cast to it where they are used; h1, h3 and the expert outputs are fp32
(``models.common.bmm_f32``), silu(h1)·h3 is cast to the tokens' dtype
before the second product, the combine is fp32, and the output is cast
to the tokens' dtype.

Differences from the reference, by design:

  * Groups. The reference routes ``G`` token groups with local capacity,
    G the data-parallel shard count of its mesh (``_dp_groups``, 1
    without a mesh). The port is one process with no mesh, so G = 1.
  * Top k. A stable descending sort and a slice, so that equal
    probabilities keep the lower expert first, as ``lax.top_k`` does
    (``torch.topk`` gives no tie order on the card).
  * Combine. The reference scatter-adds each slot's weighted output into
    its token. Here each token gathers its kept assignments' expert rows
    and sums them over k in a fixed order: no float atomics, so two runs
    on the card give the same bits. The result is the same up to the
    order of that sum.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.models.common import bmm_f32, weight


class MoE(nn.Module):
    """One layer's MoE weights in the reference's layout (``x @ W``):
    router [D, E], we1/we3 [E, D, F], we2 [E, F, D], E = ``cfg.n_slots``
    (dead experts past ``n_experts`` included)."""

    def __init__(self, d_model: int, cfg: MoEConfig, device=None,
                 dtype=torch.float32):
        super().__init__()
        E, D, Fh = cfg.n_slots, d_model, cfg.d_ff
        kw = dict(device=device, dtype=dtype)
        self.router = nn.Parameter(torch.empty(D, E, **kw))
        self.we1 = nn.Parameter(torch.empty(E, D, Fh, **kw))
        self.we3 = nn.Parameter(torch.empty(E, D, Fh, **kw))
        self.we2 = nn.Parameter(torch.empty(E, Fh, D, **kw))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator,
                         n_layers: int) -> None:
        """The reference's ``init_moe_layer`` scheme: router, we1, we3
        N(0, 0.02); we2 N(0, 0.02 / sqrt(2 L))."""
        for w in (self.router, self.we1, self.we3):
            w.normal_(0.0, 0.02, generator=generator)
        self.we2.normal_(0.0, 0.02 / (2 * n_layers) ** 0.5,
                         generator=generator)


def moe_layer_axes() -> dict:
    """The reference's logical axes of one layer's ``MoE`` weights, keyed
    as its parameters: one module a layer, so without ``layers``."""
    return {
        "router": ("embed", "expert"),
        "we1": ("expert", "embed", "expert_mlp"),
        "we3": ("expert", "embed", "expert_mlp"),
        "we2": ("expert", "expert_mlp", "embed"),
    }


def capacity(n_tokens: int, cfg: MoEConfig) -> int:
    c = int(cfg.capacity_factor * n_tokens * cfg.top_k / cfg.n_experts)
    return max(8 * ((c + 7) // 8), 8)


def route(p: MoE, cfg: MoEConfig, x: torch.Tensor):
    """x [T, D] -> (probs [T, E], gate_w [T, K], ids [T, K], pos [T*K],
    keep [T*K]): the router's probabilities in fp32, each token's top-k
    experts and renormalized gates, and each assignment's position within
    its expert in flattened (token, k) order, kept below capacity."""
    T = x.shape[0]
    E, K = cfg.n_slots, cfg.top_k
    C = capacity(T, cfg)
    logits = x.float() @ p.router.float()
    if cfg.n_slots > cfg.n_experts:     # EP padding: dead experts never route
        alive = torch.arange(E, device=x.device) < cfg.n_experts
        logits = torch.where(alive[None, :], logits, -1e30)
    probs = torch.softmax(logits, dim=-1)                        # [T, E]
    order = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    ids = order[:, :K]
    gate_w = torch.gather(probs, -1, ids)
    gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9)
    onehot = F.one_hot(ids.reshape(T * K), E).to(torch.int32)   # [A, E]
    pos = ((torch.cumsum(onehot, dim=0) - 1) * onehot).sum(-1)
    return probs, gate_w, ids, pos, pos < C


def moe_ffn(p: MoE, cfg: MoEConfig, x: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [T, D] tokens -> (out [T, D] in x's dtype, the Switch aux loss,
    an fp32 scalar)."""
    T, D = x.shape
    E, K = cfg.n_slots, cfg.top_k
    C = capacity(T, cfg)
    probs, gate_w, ids, pos, keep = route(p, cfg, x)
    flat_ids = ids.reshape(T * K)
    slot = torch.where(keep, flat_ids * C + pos, E * C)          # sink slot
    token_idx = torch.arange(T * K, device=x.device) // K
    # each slot's token (0 where empty): kept slots are distinct, dropped
    # assignments all land on the sink, which is cut off. A scatter, as
    # the reference's, where a boolean mask would sync with the host
    slot_to_token = torch.zeros(E * C + 1, dtype=torch.long, device=x.device)
    slot_to_token[slot] = token_idx

    # --- dispatch and expert compute (SwiGLU) ---------------------------
    dt = x.dtype
    gathered = x[slot_to_token[:E * C]].reshape(E, C, D)
    h = F.silu(bmm_f32(gathered, weight(p.we1, dt))) \
        * bmm_f32(gathered, weight(p.we3, dt))
    expert_out = bmm_f32(h.to(dt), weight(p.we2, dt))             # [E, C, D]

    # --- combine: each token gathers its kept rows, summed over k in order
    rows = torch.cat([expert_out.reshape(E * C, D),
                      expert_out.new_zeros(1, D)])[slot].reshape(T, K, D)
    w = (gate_w * keep.reshape(T, K)).unsqueeze(-1)
    out = rows[:, 0] * w[:, 0]
    for j in range(1, K):
        out = out + rows[:, j] * w[:, j]

    # --- load-balancing aux loss (Switch): E * sum_e f_e * P_e ----------
    f_e = (F.one_hot(flat_ids, E).float()
           * keep[:, None].float()).mean(dim=0)
    p_e = probs.mean(dim=0)
    aux = cfg.aux_loss_weight * E * torch.sum(f_e * p_e)
    return out.to(dt), aux
