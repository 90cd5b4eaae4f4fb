"""Quickstart on the PyTorch port: the MeMemo API (paper §2.1, Code 1)
plus the unified mutable ``VectorIndex`` layer (full CRUD across
flat/ivf/hnsw/tiered), and the two-tier traffic of §3.2.

    PYTHONPATH=src python examples/torch_quickstart.py              # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

On the card the HNSW queries run the ``greedy_descent`` and
``beam_search`` kernels, ``exact_query`` and the flat backend
``distance_topk``, and the IVF backend the ``gather_distance`` hop
kernel. ``main`` returns what it prints as a dict.
"""
import argparse
import os
import tempfile

import numpy as np

from repro_torch.core.index import make_index
from repro_torch.core.interface import HNSW
from repro_torch.core.tiered import auto_prefetch_p, simulate_search_traffic
from repro_torch.data.synthetic import make_corpus
from repro_torch.utils import resolve_device

BACKENDS = ("flat", "ivf", "hnsw", "tiered")


def _hits(keys, distances) -> dict:
    return {"keys": list(keys), "distances": [float(d) for d in distances]}


def main(device: str = "cuda") -> dict:
    device = resolve_device(device)
    out = {"device": str(device)}
    # --- Code 1: create an index, bulk-insert, query ------------------------
    n, dim = 2000, 64
    values = make_corpus(n, dim, seed=0)
    keys = [f"doc-{i}" for i in range(n)]

    index = HNSW(distance_function="cosine", M=16, ef_construction=100,
                 device=device)
    index.bulk_insert(keys, values)                      # await index.bulkInsert(...)

    query = values[123] + 0.05 * np.random.default_rng(1).normal(size=dim)
    found_keys, distances = index.query(query, k=5)      # await index.query(...)
    print("query ->", list(zip(found_keys, np.round(distances, 4))))
    assert found_keys[0] == "doc-123"
    out["query"] = _hits(found_keys, distances)

    # --- full CRUD: update + delete (the privacy operation) -----------------
    index.update("doc-124", values[123])                 # re-embed in place
    index.delete("doc-123")                              # retract: tombstoned
    k2, d2 = index.query(query, k=5)
    print("after delete/update ->", k2)
    assert "doc-123" not in k2 and k2[0] == "doc-124"
    assert index.size == n - 1
    out["after_delete"] = _hits(k2, d2)
    out["size"] = index.size

    # --- exact oracle comparison (recall) -----------------------------------
    exact_keys, exact_d = index.exact_query(query, k=5)
    print("exact keys:", exact_keys[:5])
    assert "doc-123" not in exact_keys                   # oracle honors deletes
    out["exact"] = _hits(exact_keys, exact_d)

    # --- export / load (persistent index incl. tombstones, §2.1) ------------
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "index.npz")
        index.export_index(path)
        loaded = HNSW.load_index(path, device=device)
        k3, _ = loaded.query(query, k=5)
        assert k3 == k2
        out["export_mb"] = os.path.getsize(path) / 1e6
        print(f"export/load roundtrip OK ({out['export_mb']:.1f} MB)")
    out["roundtrip_keys"] = k3

    # --- one protocol, four backends ----------------------------------------
    out["backends"] = {}
    for kind in BACKENDS:
        idx = make_index(kind, dim=dim, metric="cosine", M=8,
                         ef_construction=60, device=device)
        idx.bulk_insert(keys[:500], values[:500])
        got, got_d = idx.query(values[42], k=1)
        assert got[0] == "doc-42", (kind, got)
        out["backends"][kind] = _hits(got, got_d)
        print(f"make_index({kind!r:>9}) -> top-1 self-query OK")

    # --- the two-tier memory story (§3.2) ------------------------------------
    g = index._builder.graph()
    queries = make_corpus(50, dim, seed=2)
    p = auto_prefetch_p(dim)
    with_pref = simulate_search_traffic(g, queries, ef=32, cache_rows=256,
                                        prefetch_p=16)
    without = simulate_search_traffic(g, queries, ef=32, cache_rows=256,
                                      prefetch_p=1, use_graph_prefetch=False)
    saved = without.transactions / max(with_pref.transactions, 1)
    print(f"auto prefetch p for dim={dim}: {p}")
    print(f"slow-tier transactions  with prefetch: {with_pref.transactions}  "
          f"without: {without.transactions}  ({saved:.2f}x saved)")
    out.update(prefetch_p=p, transactions_with=with_pref.transactions,
               transactions_without=without.transactions, saved_x=saved)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for the plain versions")
    main(**vars(ap.parse_args()))
