"""Distributed retrieval on the PyTorch port: the corpus sharded over a
(pod, data, model) mesh of 8 devices, a per-shard top-k and the
hierarchical merge — the pod-scale version of the paper's on-device
search.

    PYTHONPATH=src python examples/torch_distributed_retrieval.py
    PYTHONPATH=src python examples/torch_distributed_retrieval.py --device cpu

The mesh puts one shard on each card when the machine has 8, and all 8
on ``cuda:0`` otherwise (``distributed/sharding.py:Mesh``); under
``--device cpu`` all 8 go on the CPU. Each shard's scan is one
``distance_topk`` launch on the card. In place of counting the
all-gathers of a compiled program, the run is counted by
``launch/op_analysis.py``, whose ``collectives`` are the bytes copied
between two distinct cards: 0 when every shard shares one device.
``main`` returns what it prints as a dict.
"""
import argparse

import numpy as np
import torch

from repro_torch.core.distributed import sharded_flat_topk
from repro_torch.data.synthetic import make_corpus
from repro_torch.distributed.sharding import Mesh
from repro_torch.kernels import ref
from repro_torch.launch.op_analysis import analyze
from repro_torch.utils import resolve_device

N, DIM, B, K = 64_000, 64, 8, 10


def corpus(device) -> tuple[torch.Tensor, torch.Tensor]:
    """The normalised [N, DIM] rows and the B queries near the first B."""
    db = torch.as_tensor(make_corpus(N, DIM, seed=0)).to(device)
    db = db / torch.linalg.norm(db, dim=1, keepdim=True)
    return db, db[:B] + 0.01


def main(device: str = "cuda") -> dict:
    device = resolve_device(device)
    # a card: Mesh's own placement (a card a coordinate when there are 8)
    mesh = Mesh((2, 2, 2), ("pod", "data", "model"),
                device=None if device.type == "cuda" else device)
    devices = list(mesh.devices.flat)
    db, q = corpus(devices[0])

    counts = analyze(sharded_flat_topk, devices, db, q, K)
    d, i = counts["out"]
    d_exp, i_exp = ref.distance_topk_ref(db, q, K)
    i, i_exp = i.cpu().numpy(), i_exp.cpu().numpy()
    match = float((np.sort(i) == np.sort(i_exp)).mean())
    print(f"mesh {mesh.shape}  db {N}x{DIM} sharded over {mesh.size} "
          f"devices ({len(set(devices))} distinct: "
          f"{sorted(str(x) for x in set(devices))})")
    print(f"top-{K} ids match exact search: {match:.1%}")
    print("first query ->", i[0][:5], np.round(d[0].cpu().numpy()[:5], 4))
    cards = len({x for x in devices if x.type == "cuda"})
    print(f"collective bytes between cards: {counts['collective_bytes']:.0f} "
          f"({counts['collectives'] or 'no peer copy'}; "
          f"{'every shard on one device' if cards <= 1 else f'{cards} cards'})"
          f", hand kernels {counts['kernels']}")
    return {"device": str(device), "mesh": dict(mesh.shape),
            "devices": [str(x) for x in devices], "match": match,
            "ids": i, "dists": d.cpu().numpy(),
            "collective_bytes": counts["collective_bytes"],
            "collectives": counts["collectives"],
            "kernels": counts["kernels"]}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for the plain versions")
    main(**vars(ap.parse_args()))
