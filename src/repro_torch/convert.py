"""Carry state from the JAX package's layouts into the port's.

The caller hands in numpy arrays (this module never imports JAX):

  * ``lm_params_from_jax`` — the reference's LM parameter tree (layers
    stacked along a leading [L] axis, matrices laid out for ``x @ W``) ->
    a ``state_dict`` for ``models.transformer.LM`` (one module per layer,
    ``nn.Linear`` weights ``[out, in]``, hence the transposes);
  * ``encoder_params_from_jax``, ``recsys_params_from_jax`` and
    ``sage_params_from_jax`` — the reference's encoder, recsys and
    GraphSAGE trees -> the port's: the same tensors in the same layout
    (``x @ W``, the encoder's blocks stacked along [L]), the encoder an
    ``models.encoder.Encoder``;
  * ``opt_state_from_jax`` — the reference's AdamW ``OptState`` (m, v,
    step) -> the port's ``train.optimizer.OptState`` for the parameters
    it is given (``like``): an LM's m and v through
    ``lm_params_from_jax``'s mapping, any other tree's by its dotted leaf
    names (``named_from_jax``, which carries any tree shaped as the
    parameters);
  * ``tree_from_checkpoint`` — the members of a reference checkpoint
    (``repro.train.checkpoint``'s ``step_N.npz``: "/"-joined leaf paths)
    -> the nested tree, which ``lm_params_from_jax``,
    ``opt_state_from_jax`` and the other converters then carry over;
  * ``device_graph_from_host`` — any host HNSW graph with the reference's
    fields (vectors, neighbors0, upper, levels, entry, max_level, metric)
    -> a ``DeviceGraph`` on ``device``. The graph is this system's
    "weights": a graph built by the reference's numpy builder searches
    here unchanged.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import hnsw as thnsw
from repro_torch.core.hnsw_build import HNSWGraph
from repro_torch.models import encoder as enc_lib
from repro_torch.models.common import named_tensors, tree_map
from repro_torch.models.recsys import _bert4rec_enc_cfg
from repro_torch.models.transformer import LM
from repro_torch.train.optimizer import OptState

_ATTN = ("wq", "wk", "wv", "wo")
_DENSE_FFN = ("w1", "w3", "w2")
_MOE = ("router", "we1", "we2", "we3")


def lm_params_from_jax(params: dict, dtype=None) -> dict[str, torch.Tensor]:
    """Nested dict of numpy arrays in the reference's ``init_lm`` layout
    (fp32, fp16 or bf16, the latter as ``ml_dtypes.bfloat16`` arrays) ->
    ``LM.state_dict()``-shaped dict of CPU tensors of the same dtype, bit
    for bit, or cast to ``dtype``. Linear weights are transposed; an MoE
    layer's router and expert weights keep the reference's layout
    (``layers.<i>.moe.<name>``)."""
    def t(a) -> torch.Tensor:
        a = np.ascontiguousarray(a)
        if a.dtype.name == "bfloat16":       # numpy has no bf16: its bits
            w = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
        else:
            w = torch.from_numpy(a)
        return w if dtype is None else w.to(dtype)

    layers = params["layers"]
    moe = "router" in layers
    sd = {"embed.weight": t(params["embed"]),
          "final_norm": t(params["final_norm"])}
    n_layers = np.asarray(layers["attn_norm"]).shape[0]
    for i in range(n_layers):
        sd[f"layers.{i}.attn_norm"] = t(np.asarray(layers["attn_norm"])[i])
        sd[f"layers.{i}.ffn_norm"] = t(np.asarray(layers["ffn_norm"])[i])
        for name in _ATTN + (() if moe else _DENSE_FFN):
            sd[f"layers.{i}.{name}.weight"] = t(np.asarray(layers[name])[i].T)
        for name in _MOE if moe else ():
            sd[f"layers.{i}.moe.{name}"] = t(np.asarray(layers[name])[i])
    if "out_head" in params:
        sd["out_head.weight"] = t(np.asarray(params["out_head"]).T)
    return sd


def _tensors(tree):
    """Nested dicts and lists of numpy arrays -> the same tree of fp32
    CPU tensors."""
    return tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)),
                    tree)


def encoder_params_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """The reference's ``init_encoder`` tree of numpy arrays ->
    ``Encoder.state_dict()``-shaped dict of CPU tensors."""
    sd = {k: params[k] for k in ("embed", "pos", "final_g", "final_b")}
    sd.update({f"layers.{k}": v for k, v in params["layers"].items()})
    return _tensors(sd)


def recsys_params_from_jax(kind: str, params: dict, cfg=None) -> dict:
    """The reference's ``recsys.INIT[kind]`` tree of numpy arrays -> the
    port's on the CPU: the same dicts and MLP lists of tensors; for
    ``bert4rec`` (which needs its ``RecsysConfig`` ``cfg``) the encoder as
    an ``Encoder``."""
    if kind != "bert4rec":
        return _tensors(params)
    enc = enc_lib.Encoder(_bert4rec_enc_cfg(cfg), device="cpu")
    enc.load_state_dict(encoder_params_from_jax(params["encoder"]))
    return {"encoder": enc.requires_grad_(False).eval()}


def sage_params_from_jax(params: dict) -> dict:
    """The reference's ``init_sage`` tree -> the port's on the CPU."""
    return _tensors(params)


def _flat(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dicts and lists of arrays -> {dotted name: array}, the
    names of ``models.common.named_tensors``."""
    if not isinstance(tree, (dict, list, tuple)):
        return {prefix[:-1]: np.asarray(tree)}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    return {n: a for k, v in items for n, a in _flat(v, f"{prefix}{k}.")
            .items()}


def named_from_jax(tree, like) -> dict[str, torch.Tensor]:
    """A reference tree of numpy arrays shaped as the parameters ``like``
    (an ``LM`` or a recsys / GraphSAGE tree) -> {name: CPU tensor} keyed
    as ``named_tensors(like)``: an LM's through ``lm_params_from_jax``,
    any other tree's by its dotted leaf names."""
    sd = (lm_params_from_jax(tree) if isinstance(like, LM) else
          {n: torch.from_numpy(np.array(a)) for n, a in _flat(tree).items()})
    names = [n for n, _ in named_tensors(like)]
    if sorted(sd) != sorted(names):
        raise ValueError("the tree does not match the parameters' leaves")
    return {n: sd[n] for n in names}


def opt_state_from_jax(opt_state, like) -> OptState:
    """The reference's ``OptState`` (m, v and step, as numpy arrays) ->
    the port's ``OptState`` for the parameters ``like``, on their device:
    fp32 m and v keyed as ``named_tensors(like)``, the step an int32
    scalar."""
    m, v, step = opt_state
    dev = named_tensors(like)[0][1].device

    def conv(tree) -> dict[str, torch.Tensor]:
        return {n: t.to(device=dev, dtype=torch.float32)
                for n, t in named_from_jax(tree, like).items()}

    return OptState(conv(m), conv(v), torch.tensor(
        int(np.asarray(step)), dtype=torch.int32, device=dev))


def tree_from_checkpoint(members) -> dict:
    """{"a/b/c": array} (an ``np.load`` of a reference checkpoint; its
    ``__meta__`` member is left out) -> {"a": {"b": {"c": array}}}. List
    indices stay string keys ("0", "1"), which the dotted leaf names of
    ``named_from_jax`` read as the reference's; ``opt`` holds the
    ``OptState``'s fields ``m``, ``v`` and ``step``."""
    tree: dict = {}
    for key in members:
        if key == "__meta__":
            continue
        *path, leaf = key.split("/")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = np.asarray(members[key])
    return tree


def device_graph_from_host(g, deleted: np.ndarray | None = None, *,
                           device) -> thnsw.DeviceGraph:
    """Upload a host HNSW graph (the port's ``HNSWGraph`` or any object
    with the same fields) to ``device``."""
    host = HNSWGraph(vectors=np.asarray(g.vectors, np.float32),
                     neighbors0=np.asarray(g.neighbors0, np.int32),
                     upper=np.asarray(g.upper, np.int32),
                     levels=np.asarray(g.levels, np.int32),
                     entry=int(g.entry), max_level=int(g.max_level),
                     metric=str(g.metric), n=int(getattr(g, "n", 0)))
    return thnsw.to_device_graph(host, deleted, device=device)
