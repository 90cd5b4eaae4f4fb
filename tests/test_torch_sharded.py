"""Port parity for the sharded index (CPU): ``n_shards > 1`` for every
backend, against ``repro`` on the same numpy inputs and the reference's
``MUTATE`` sequence (``tests/test_sharded.py``).

The reference's own contract (``tests/test_sharded.py``) is what the port
is held to, with the reference at one shard or at S as the oracle:

  * flat and IVF: the port at S returns the reference's 1-shard keys,
    distances within 1e-5 of it (the frameworks sum in another order) and
    within 1 ulp of the port's own 1-shard index, and its ``state_dict``
    equals the reference's bit for bit, epoch included;
  * HNSW and tiered: each child graph equals the reference's child (the
    host builder, ``seed + j``) bit for bit; ``query_batch`` equals the
    reference's fan-out over those children (its loop oracle for fp32),
    and ``exact_query`` does not depend on S;
  * a snapshot reshards on restore: the same state restored at another
    shard count equals the reference's restore bit for bit, and stores
    the reference wrote at 8 shards (in a subprocess, the only place it
    needs fake devices) restore in the port at 1 and 4 with the same
    keys, while the port writes the same WAL and manifest bytes at 8.

Every shard lies on the CPU here (``shard_devices``), where the kernels'
plain versions run.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.core import make_index as jmake_index
from repro.core import sharded as jsharded
from repro.data.synthetic import make_corpus
from repro.store import IndexStore as JIndexStore
from repro_torch.core import sharded as tsharded
from repro_torch.core import stacked as tstacked
from repro_torch.core.codec import effective_rerank, rerank_exact
from repro_torch.core.index import make_index as tmake_index
from repro_torch.launch import serve as tserve
from repro_torch.serve.retrieval import RetrievalEngine
from repro_torch.store import IndexStore

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
SHARDS = [2, 3, 4, 8]
CODECS = ["fp32", "bf16", "int8"]
DIM = 16
DATA = make_corpus(120, DIM, seed=0)
EXTRA = make_corpus(8, DIM, seed=1)
Q = make_corpus(6, DIM, seed=2)
GRAPH = dict(M=8, ef_construction=60, ef_search=48)
IVF = dict(nlist=16, nprobe=4)
INF = np.float32(3e38)

MUTATE = """
def mutate(idx, data, extra):
    idx.bulk_insert([f"d{i}" for i in range(len(data))], data)
    for j in range(4):
        idx.insert(f"x{j}", extra[j])
    idx.update("d5", extra[4])
    idx.update("x1", extra[5])
    idx.delete("d7"); idx.delete("x0"); idx.delete("d63")
"""
exec(MUTATE)


def _state_equal(a, b):
    """Bit-identical ``state_dict``s (arrays by bytes, meta by value)."""
    (aa, am), (ba, bm) = a.state_dict(), b.state_dict()
    assert am == bm
    assert set(aa) == set(ba)
    for name in aa:
        x, y = np.asarray(aa[name]), np.asarray(ba[name])
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert x.tobytes() == y.tobytes(), name


_REF = {}


def _ref(kind, codec, n_shards=1, **cfg):
    """The reference index after MUTATE, built once a configuration."""
    key = (kind, codec, n_shards, tuple(sorted(cfg.items())))
    if key not in _REF:
        j = jmake_index(kind, dim=DIM, metric="cosine", dtype=codec,
                        n_shards=n_shards, **cfg)
        mutate(j, DATA, EXTRA)
        if kind == "ivf":
            j.query_batch(Q, 10)                 # trains the quantiser
        _REF[key] = j
    return _REF[key]


def _port(kind, codec, n_shards, **cfg):
    t = tmake_index(kind, device="cpu", dim=DIM, metric="cosine",
                    dtype=codec, n_shards=n_shards, **cfg)
    mutate(t, DATA, EXTRA)
    return t


# ---------------------------------------------------------------------------
# flat and IVF: the reference's 1-shard keys and state at every S
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("kind", ["flat", "ivf"])
def test_flat_ivf_match_reference_one_shard(kind, codec, s):
    cfg = IVF if kind == "ivf" else {}
    j = _ref(kind, codec, **cfg)
    t1 = _port(kind, codec, 1, **cfg)
    ts = _port(kind, codec, s, **cfg)
    assert ts.shard_count == s and len(ts.shard_stats()) == s
    assert sum(x["live"] for x in ts.shard_stats()) == ts.size == j.size
    if kind == "ivf":
        # the reference's trained quantiser (its k-means draws from
        # jax.random; tests/test_torch_ivf.py holds the port's training)
        for t in (t1, ts):
            t._centroids = j._centroids.copy()
            t._invalidate()
    jk, jd = j.query_batch(Q, 10)
    for t in (t1, ts):
        tk, td = t.query_batch(Q, 10)
        assert tk == jk
        np.testing.assert_allclose(td, np.asarray(jd), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ts.query_batch(Q, 10)[1],
                               t1.query_batch(Q, 10)[1], rtol=1e-6, atol=0)
    assert ts.exact_query(Q, 12)[0] == j.exact_query(Q, 12)[0]
    assert ts.query_batch(Q[:1], 400)[0] == j.query_batch(Q[:1], 400)[0]
    _state_equal(ts, j)
    assert ts.mutation_epoch == j.mutation_epoch
    assert ts.keys() == j.keys()


@pytest.mark.parametrize("s", [3, 8])
def test_ivf_trains_the_same_quantiser_at_any_shard_count(s, monkeypatch):
    """Trained by the port itself (one draw), S shards and one shard land
    on the same centroids, lists and keys."""
    t1 = _port("ivf", "int8", 1, **IVF)
    ts = _port("ivf", "int8", s, **IVF)
    k1, d1 = t1.query_batch(Q, 10)
    ks, ds = ts.query_batch(Q, 10)
    assert ks == k1
    np.testing.assert_allclose(ds, d1, rtol=1e-6, atol=0)
    assert ts._centroids.tobytes() == t1._centroids.tobytes()
    _state_equal(ts, t1)
    plan = ts.probe_plan()
    assert len(plan["shard_caps"]) == s and plan["nlist"] == 16
    assert plan["probe_k"] == 4 * max(plan["shard_caps"])


# ---------------------------------------------------------------------------
# HNSW and tiered: per-shard graphs
# ---------------------------------------------------------------------------
def _ref_fanout(j, q, k, ef=None):
    """The reference's sharded ``query_batch`` (its stacked fan-out)
    computed child by child, without a mesh: each child's search at
    k · rerank_factor, gid = s · cap + node, the (d, gid) merge, and the
    fp32 rerank over the gid-aligned rows."""
    from repro.core import hnsw as jhnsw
    rf = effective_rerank(j._codec, j.rerank_factor)
    kf = k * rf
    ef = max(ef or j.ef_search, kf)
    graphs = [c._dg() if c._builder is not None else None
              for c in j._shards]
    cap = max(g.n for g in graphs if g is not None)
    ds, gs = [], []
    for s, g in enumerate(graphs):
        if g is not None:
            ids, d = map(np.asarray, jhnsw.search_graph(
                g, q, k=kf, ef=ef, beam_impl=j.beam_impl))
            ds.append(np.where(ids >= 0, d, INF))
            gs.append(np.where(ids >= 0, s * cap + ids, -1))
    d, g = np.concatenate(ds, 1), np.concatenate(gs, 1)
    o = np.lexsort((g, d), axis=-1)[:, :kf]
    d, g = np.take_along_axis(d, o, 1), np.take_along_axis(g, o, 1)
    if rf > 1:
        rows = np.zeros((len(graphs) * cap, q.shape[1]), np.float32)
        for s, c in enumerate(j._shards):
            if c._builder is not None:
                rows[s * cap:s * cap + c._builder.n] = \
                    c._builder.vectors[:c._builder.n]
        d, g = rerank_exact(rows, q, g, k, metric=j.metric)
    keys = [[j._shards[x // cap]._keys[x % cap] if x >= 0 else None
             for x in row] for row in g]
    return keys, d


@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("codec", CODECS)
def test_hnsw_children_and_search_match_reference(codec, s):
    j = _ref("hnsw", codec, s, **GRAPH)
    t = _port("hnsw", codec, s, **GRAPH)
    assert len(t._shards) == s
    for tc, jc in zip(t._shards, j._shards):
        assert tc.seed == jc.seed and tc.device.type == "cpu"
        _state_equal(tc, jc)                   # each child graph, bit for bit
    _state_equal(t, j)
    assert t.mutation_epoch == j.mutation_epoch and t.keys() == j.keys()
    assert t.shard_stats() == j.shard_stats()
    tk, td = t.query_batch(Q, 5)
    jk, jd = _ref_fanout(j, Q, 5)
    assert tk == jk
    np.testing.assert_allclose(td, jd, rtol=0, atol=1e-5)
    assert all("d7" not in row for row in tk)
    if codec == "fp32":
        lk, ld = j._query_batch_sharded_loop(Q, 5, 48)
        assert tk == lk
        np.testing.assert_allclose(td, ld, rtol=0, atol=1e-5)
    # the exact phase does not depend on the shard count
    ek, ed = t.exact_query(Q, 10)
    one = _ref("hnsw", codec, 1, **GRAPH)
    assert ek == one.exact_query(Q, 10)[0]
    np.testing.assert_allclose(ed, np.asarray(one.exact_query(Q, 10)[1]),
                               rtol=0, atol=1e-5)
    assert t.exact_query(Q[0], 3)[0] == ek[0][:3]


@pytest.mark.parametrize("s", SHARDS)
def test_tiered_matches_reference_loop(s):
    j = _ref("tiered", "fp32", s, **GRAPH)
    t = _port("tiered", "fp32", s, **GRAPH)
    _state_equal(t, j)
    tk, td = t.query_batch(Q, 5)
    jk, jd = j._query_batch_sharded_loop(Q, 5, 48)
    assert tk == jk
    np.testing.assert_allclose(td, jd, rtol=0, atol=1e-5)
    # the host accounting model: bit for bit, traffic included
    lk, ld = t._query_batch_sharded_loop(Q, 5, 48)
    assert lk == jk and ld.tobytes() == jd.tobytes()
    assert t.stats.as_dict() == j.stats.as_dict()
    assert t.exact_query(Q, 8)[0] == _ref("tiered", "fp32", 1,
                                          **GRAPH).exact_query(Q, 8)[0]
    t.compact()
    j2 = jmake_index("tiered", dim=DIM, metric="cosine", n_shards=s, **GRAPH)
    mutate(j2, DATA, EXTRA)
    j2.compact()
    assert t.mutation_epoch == j2.mutation_epoch and t.keys() == j2.keys()


def test_per_hop_route_matches_reference_fanout():
    """``beam_impl="jnp"``: each shard's layer-0 beam on the per-hop
    route, against the reference's children searched the same way."""
    cfg = dict(GRAPH, beam_impl="jnp")
    j = _ref("hnsw", "int8", 3, **cfg)
    t = _port("hnsw", "int8", 3, **cfg)
    tk, td = t.query_batch(Q, 5)
    jk, jd = _ref_fanout(j, Q, 5)
    assert tk == jk
    np.testing.assert_allclose(td, jd, rtol=0, atol=1e-5)


def test_fanout_is_one_search_and_counts_each_shard():
    t = _port("hnsw", "fp32", 3, **GRAPH)
    before = tstacked.DISPATCH_COUNT
    t.query_batch(Q, 5)
    t.query_batch(Q, 5)
    assert tstacked.DISPATCH_COUNT == before + 2


# ---------------------------------------------------------------------------
# resharding on restore (in process) and the placed-block caches
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("codec", ["fp32", "int8"])
@pytest.mark.parametrize("kind", ["hnsw", "tiered"])
@pytest.mark.parametrize("src,dst", [(4, 1), (1, 3), (4, 2)])
def test_reshard_restore_matches_reference(kind, codec, src, dst):
    """The live rows replay into fresh builders in canonical order; a lossy
    row keeps its recorded encoding. The result equals the reference's
    restore of the same state bit for bit."""
    state = _ref(kind, codec, src, **GRAPH).state_dict()
    j = jmake_index(kind, dim=DIM, metric="cosine", dtype=codec,
                    n_shards=dst, **GRAPH)
    j.restore_state(*state)
    t = tmake_index(kind, device="cpu", dim=DIM, metric="cosine",
                    dtype=codec, n_shards=dst, **GRAPH)
    t.restore_state(*state)
    _state_equal(t, j)
    assert t.keys() == j.keys() and t.mutation_epoch == j.mutation_epoch
    ek = _ref(kind, codec, 1, **GRAPH).exact_query(Q, 8)[0]
    assert t.exact_query(Q, 8)[0] == ek


def test_reshard_restore_bulk_adoption_matches_reference():
    """``use_bulk_build`` and fp32 rows: each target shard adopts one
    bulk-built graph; epoch parity holds across the reshard."""
    cfg = dict(GRAPH, use_bulk_build=True)
    src = tmake_index("hnsw", device="cpu", metric="cosine", **cfg)
    src.bulk_insert([f"d{i}" for i in range(120)], DATA)
    src.delete("d7")
    for dst in (4, 1):
        t = tmake_index("hnsw", device="cpu", metric="cosine", n_shards=dst,
                        **cfg)
        t.restore_state(*src.state_dict())
        j = jmake_index("hnsw", metric="cosine", n_shards=dst, **cfg)
        j.restore_state(*src.state_dict())
        assert t.mutation_epoch == j.mutation_epoch == 2
        assert t.size == 119 and "d7" not in t
        assert t.keys() == j.keys()
        assert t.exact_query(Q, 8)[0] == src.exact_query(Q, 8)[0]


def test_exact_block_cache_invalidation():
    """Epoch-keyed exact-phase blocks: built once, no block upload on the
    steady state, rebuilt by every mutation class — a stale cache never
    serves a retracted row."""
    t = tmake_index("hnsw", device="cpu", metric="cosine", n_shards=4,
                    **GRAPH)
    t.bulk_insert([f"d{i}" for i in range(120)], DATA)
    q = DATA[7][None] + 0.001
    p0 = tsharded.PLACE_COUNT
    assert t.exact_query(q, 5)[0][0][0] == "d7"
    assert tsharded.PLACE_COUNT == p0 + 1
    for _ in range(3):
        t.exact_query(q, 5)
        t.query_batch(q, 5)
    assert tsharded.PLACE_COUNT == p0 + 1
    t.delete("d7")
    assert "d7" not in t.exact_query(q, 5)[0][0]
    assert tsharded.PLACE_COUNT == p0 + 2
    t.insert("z0", DATA[7])
    assert t.exact_query(q, 5)[0][0][0] == "z0"
    t.compact()
    ek = t.exact_query(q, 5)[0][0]
    assert ek[0] == "z0" and "d7" not in ek


@pytest.mark.parametrize("kind", ["flat", "ivf"])
def test_steady_state_search_places_no_blocks(kind):
    t = _port(kind, "int8", 4, **(IVF if kind == "ivf" else {}))
    t.query_batch(Q, 5)
    p0 = tsharded.PLACE_COUNT
    for _ in range(3):
        t.query_batch(Q, 5)
        t.exact_query(Q, 5)
    assert tsharded.PLACE_COUNT == p0
    t.delete("d3")
    t.query_batch(Q, 5)
    assert tsharded.PLACE_COUNT == p0 + 1


@pytest.mark.parametrize("codec", CODECS)
def test_blocks_hold_each_shards_own_slots(codec):
    """Each shard's block holds its own slot count, unpadded, and its
    over-fetch is its own free slots: none after a bulk insert, the
    quantized count of the shard's deletes after churn."""
    t = tmake_index("flat", device="cpu", dtype=codec, n_shards=4)
    t.bulk_insert([f"d{i}" for i in range(120)], DATA)
    placed = t._rows.pack()
    stats = t.shard_stats()
    assert [b.shape[0] for b in placed.blocks] == [x["slots"] for x in stats]
    assert [g.shape[0] for g in placed.gids] == [x["slots"] for x in stats]
    assert placed.slack == [0, 0, 0, 0]
    for i in range(0, 20, 2):
        t.delete(f"d{i}")
    placed = t._rows.pack()
    assert placed.slack == [tsharded._quantize_slack(x["free"])
                            for x in t.shard_stats()]
    assert any(placed.slack)


def test_fanout_exact_topk_over_row_groups():
    """The one-shot sharded exact search over explicit per-shard groups
    is the exact search over their union (integer l2 rows: exact); all
    empty groups answer (INF, -1) without placing anything."""
    rng = np.random.default_rng(3)
    rows = rng.integers(-4, 5, size=(50, 8)).astype(np.float32)
    gids = rng.permutation(50).astype(np.int32)
    q = rng.integers(-4, 5, size=(4, 8)).astype(np.float32)
    cut = [0, 13, 13, 50]                      # one empty shard
    groups = [(rows[a:b], gids[a:b]) for a, b in zip(cut, cut[1:])]
    cpu = [torch.device("cpu")] * 3
    d, g = tsharded.fanout_exact_topk(groups, q, 7, cpu, metric="l2")
    full = ((q[:, None] - rows[None]) ** 2).sum(-1)
    o = np.lexsort((np.broadcast_to(gids, full.shape), full), axis=-1)[:, :7]
    np.testing.assert_array_equal(g, gids[o])
    np.testing.assert_array_equal(d, np.take_along_axis(full, o, 1))
    p0 = tsharded.PLACE_COUNT
    empty = [(np.zeros((0, 8), np.float32), np.zeros(0, np.int32))] * 2
    d, g = tsharded.fanout_exact_topk(empty, q, 3, cpu[:2], metric="l2")
    assert (g == -1).all() and (d == INF).all()
    assert tsharded.PLACE_COUNT == p0


def test_quantize_slack_bounded():
    assert tsharded._quantize_slack(0) == 0
    assert all(tsharded._quantize_slack(r) >= r for r in range(5000))
    assert len({tsharded._quantize_slack(r) for r in range(5000)}) <= 15
    assert all(tsharded._quantize_slack(r) == jsharded._quantize_slack(r)
               for r in range(5000))


def test_churn_relayout_and_slack_keep_exact_keys():
    """Free slots past ``REPACK_FREE_FRACTION`` re-derive a dense layout;
    below it the fan-out over-fetches ``k + slack`` and masks the free
    slots. Keys stay the 1-shard index's either way."""
    for frac in (0.1, 0.5):
        t1, t4 = (tmake_index("flat", device="cpu", n_shards=s)
                  for s in (1, 4))
        for t in (t1, t4):
            t.bulk_insert([f"d{i}" for i in range(120)], DATA)
            for i in range(int(120 * frac)):
                t.delete(f"d{2 * i % 120}")
        assert t4.query_batch(Q, 10)[0] == t1.query_batch(Q, 10)[0]
        free = sum(x["free"] for x in t4.shard_stats())
        slots = sum(x["slots"] for x in t4.shard_stats())
        assert free / slots <= tsharded.REPACK_FREE_FRACTION


def test_shard_devices_on_the_cpu():
    cpu = torch.device("cpu")
    assert tsharded.shard_devices(3, "cpu") == [cpu, cpu, cpu]
    assert tsharded.max_shards("cpu") is None
    t = tmake_index("flat", device="cpu", n_shards=3)
    assert t._rows.devices == [cpu] * 3


def test_engine_epoch_invalidation_under_shard_routed_mutations():
    idx = tmake_index("flat", device="cpu", dim=DIM, n_shards=8)
    idx.bulk_insert([f"d{i}" for i in range(100)], DATA[:100])
    eng = RetrievalEngine(idx, max_batch=16)
    assert eng.shards == 8
    r1 = eng.retrieve_one(DATA[7], k=3)
    assert r1.keys[0] == "d7" and not r1.from_cache
    assert eng.retrieve_one(DATA[7], k=3).from_cache
    idx.delete("d7")                           # routes to one shard...
    r3 = eng.retrieve_one(DATA[7], k=3)        # ...but flushes the LRU
    assert not r3.from_cache and "d7" not in r3.keys
    assert eng.stats.invalidations == 1


def test_sharded_secure_delete_compaction(tmp_path):
    rng = np.random.default_rng(0)
    data = rng.normal(size=(60, DIM)).astype(np.float32)
    store = IndexStore(str(tmp_path))
    idx = tmake_index("flat", device="cpu", dim=DIM, n_shards=8, store=store)
    idx.bulk_insert([f"doc-{i}" for i in range(60)], data)
    secret = np.asarray(idx.state_dict()[0]["vectors"][13]).tobytes()
    idx.delete("doc-13")
    store.compact(idx)
    hits = []
    for root, _, files in os.walk(tmp_path):
        for f in files:
            blob = open(os.path.join(root, f), "rb").read()
            if secret in blob or b"doc-13" in blob:
                hits.append(f)
    assert not hits, hits
    assert idx.query_batch(data[14][None], 3)[0][0][0] == "doc-14"
    assert sum(s["live"] for s in idx.shard_stats()) == 59


def test_launch_serve_shards_on_cpu(caplog):
    import logging
    caplog.set_level(logging.INFO, logger="repro_torch")
    out = tserve.main(["--rag", "--index", "hnsw", "--index-dtype", "int8",
                       "--shards", "3", "--device", "cpu", "--requests",
                       "2", "--max-new", "2", "--max-len", "96", "--slots",
                       "2"])
    assert out["rag"].index.shard_count == 3
    assert all(r.done and len(r.docs) == 3 for r in out["reqs"])
    assert "index sharded over 3 devices" in caplog.text


# ---------------------------------------------------------------------------
# stores written by the reference at 8 shards
# ---------------------------------------------------------------------------
STORE_RUN = MUTATE + """
import json, os, sys
import numpy as np
from repro.core import make_index
from repro.data.synthetic import make_corpus
from repro.store import IndexStore
root = sys.argv[1]
data = make_corpus(120, 16, seed=0)
extra = make_corpus(8, 16, seed=1)
q = make_corpus(6, 16, seed=2)
out = {}
for kind in ("flat", "ivf", "hnsw"):
    st = IndexStore(os.path.join(root, kind))
    cfg = {"nlist": 16, "nprobe": 4} if kind == "ivf" else {}
    idx = make_index(kind, dim=16, metric="cosine", M=8, ef_construction=60,
                     n_shards=8, store=st, **cfg)
    mutate(idx, data, extra)
    idx.query_batch(q, 5)                  # IVF trains its centroids
    st.snapshot(idx)
    idx.insert("late", extra[6])           # rides the WAL only
    st.wal.close()
    out[kind] = {"exact": idx.exact_query(q, 8)[0],
                 "ann": idx.query_batch(q, 5)[0], "keys": idx.keys(),
                 "epoch": idx.mutation_epoch}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_stores(tmp_path_factory):
    """The reference's 8-shard stores of flat, IVF and HNSW and the keys
    they answer, written in one subprocess with 8 fake XLA devices."""
    root = tmp_path_factory.mktemp("ref8")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(STORE_RUN),
                          str(root)], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return root, json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("kind", ["flat", "ivf", "hnsw"])
def test_reference_8_shard_store_restores_at_1_and_4(reference_stores,
                                                     kind):
    root, want = reference_stores
    for n in (1, 4):
        idx = IndexStore(str(root / kind)).load_index(n_shards=n,
                                                      device="cpu")
        assert idx.shard_count == n
        assert idx.exact_query(Q, 8)[0] == want[kind]["exact"]
        assert idx.keys() == want[kind]["keys"] and "late" in idx
        assert idx.mutation_epoch == want[kind]["epoch"]
        if kind != "hnsw":                     # fully sharded: ANN too
            assert idx.query_batch(Q, 5)[0] == want[kind]["ann"]
    # no override on the CPU: the stored 8 shards
    assert IndexStore(str(root / kind)).load_index(
        device="cpu").shard_count == 8


@pytest.mark.parametrize("kind", ["flat", "ivf", "hnsw"])
def test_port_writes_the_reference_wal_and_manifest_at_8(reference_stores,
                                                         kind, tmp_path):
    root, _ = reference_stores
    ref = JIndexStore(str(root / kind))
    ref.wal.close()
    st = IndexStore(str(tmp_path / kind))
    idx = tmake_index(kind, device="cpu", dim=DIM, metric="cosine",
                      M=8, ef_construction=60, n_shards=8, store=st,
                      **(IVF if kind == "ivf" else {}))
    mutate(idx, DATA, EXTRA)
    idx.query_batch(Q, 5)
    st.snapshot(idx)
    idx.insert("late", EXTRA[6])
    st.wal.close()
    assert st.snapshots() == ref.snapshots() and len(st.snapshots()) == 1
    for name in ("wal.log", "config.json",
                 os.path.join(st.snapshots()[0], "manifest.json")):
        with open(os.path.join(ref.root, name), "rb") as a, \
                open(os.path.join(st.root, name), "rb") as b:
            assert a.read() == b.read(), name
