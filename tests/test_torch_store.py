"""Port parity for the durable index store (CPU): the cases of
``tests/test_store.py`` that apply at one shard, re-run against
``repro_torch`` for the ``flat`` and ``hnsw`` kinds (and each row codec
where the case is about stored rows), then the same operations through
both packages: WAL files equal byte for byte, each snapshot's
``manifest.json`` equal byte for byte, its page arrays equal array for
array, and a store written by either package restoring in the other with
the same keys on the same queries and the same ``mutation_epoch``. Last,
the served warm path: ``launch.serve`` run twice over one ``--store-dir``.

Tolerances: restored state is bit for bit (array bytes, keys, epochs, RNG
state). Across packages, keys are equal and distances agree within 1e-5
(the two frameworks sum in another order); on integer-valued l2 rows the
distances are exact and must be equal.
"""
import json
import logging
import os

import numpy as np
import pytest

from repro.core import make_index as jmake_index
from repro.data.synthetic import make_corpus
from repro.store import IndexStore as JIndexStore
from repro.store import read_snapshot as jread_snapshot
from repro_torch.core.hnsw_build import normalize_rows
from repro_torch.core.index import VectorIndex
from repro_torch.core.index import make_index as tmake_index
from repro_torch.launch import serve as tserve
from repro_torch.serve.retrieval import RetrievalEngine
from repro_torch.store import IndexStore, WriteAheadLog, read_snapshot
from repro_torch.store.wal import FILE_MAGIC

KINDS = ["flat", "hnsw"]
DTYPES = ["fp32", "bf16", "int8"]
DIM = 16
CFG = dict(dim=DIM, metric="cosine", M=8, ef_construction=40, ef_search=32)

DATA = make_corpus(60, DIM, seed=0)
EXTRA = make_corpus(12, DIM, seed=1)


def fresh(kind, td, dtype="fp32", **store_kw):
    store = IndexStore(os.path.join(td, "store"), **store_kw)
    return tmake_index(kind, store=store, device="cpu", dtype=dtype,
                       **CFG), store


def load(root):
    return IndexStore(root).load_index(device="cpu")


def seed_mutations(idx):
    """Phase 1: the mutation history a snapshot will cover."""
    idx.bulk_insert([f"d{i}" for i in range(60)], DATA)
    idx.insert("solo", EXTRA[0])
    idx.update("d5", EXTRA[1])
    idx.delete("d9")
    idx.delete("d40")


def tail_mutations(idx):
    """Phase 2: the WAL tail replay must reproduce."""
    for j in range(2, 8):
        idx.insert(f"e{j}", EXTRA[j])
    idx.update("e3", EXTRA[8])
    idx.insert("d5", EXTRA[9])           # upsert of an existing key
    idx.delete("d17")


def assert_bit_for_bit(a, b):
    """Identical mutation-determined host state (array bytes, keys, epoch,
    HNSW RNG state) AND identical queries."""
    assert type(a) is type(b)
    aa, am = a.state_dict()
    ba, bm = b.state_dict()
    assert set(aa) == set(ba)
    for name in aa:
        x, y = np.asarray(aa[name]), np.asarray(ba[name])
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert x.tobytes() == y.tobytes(), f"array {name!r} differs"
    assert am == bm
    assert a.mutation_epoch == b.mutation_epoch
    assert a.keys() == b.keys()
    if a.size:
        ka, da = a.query_batch(DATA[:5], 6)
        kb, db = b.query_batch(DATA[:5], 6)
        assert ka == kb
        assert np.asarray(da).tobytes() == np.asarray(db).tobytes()


def walk_bytes(root):
    for dp, _, fns in os.walk(root):
        for fn in fns:
            p = os.path.join(dp, fn)
            with open(p, "rb") as f:
                yield p, f.read()


# ---------------------------------------------------------------------------
# snapshot + WAL replay == live index, bit for bit
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", KINDS)
def test_snapshot_plus_wal_replay_bit_for_bit(kind, dtype, tmp_path):
    idx, store = fresh(kind, tmp_path, dtype)
    seed_mutations(idx)
    store.snapshot(idx)
    tail_mutations(idx)
    restored = load(store.root)
    assert restored.storage_dtype == dtype
    assert_bit_for_bit(idx, restored)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", KINDS)
def test_wal_only_restore_without_any_snapshot(kind, dtype, tmp_path):
    idx, store = fresh(kind, tmp_path, dtype)
    seed_mutations(idx)
    assert store.snapshots() == []
    assert_bit_for_bit(idx, load(store.root))


@pytest.mark.parametrize("dtype", ["fp32", "int8"])
def test_hnsw_bulk_build_path_replays_deterministically(dtype, tmp_path):
    store = IndexStore(os.path.join(tmp_path, "store"))
    idx = tmake_index("hnsw", store=store, use_bulk_build=True, dtype=dtype,
                      device="cpu", **CFG)
    idx.bulk_insert([f"d{i}" for i in range(60)], DATA)
    idx.delete("d7")
    assert_bit_for_bit(idx, load(store.root))          # WAL replay
    store.snapshot(idx)
    idx.insert("late", EXTRA[0])                       # appends to the graph
    assert_bit_for_bit(idx, load(store.root))          # snapshot + WAL


def test_restored_epoch_not_zero_and_monotonic(tmp_path):
    idx, store = fresh("flat", tmp_path)
    seed_mutations(idx)
    e = idx.mutation_epoch
    assert e > 0
    restored = load(store.root)
    assert restored.mutation_epoch == e
    restored.insert("post", EXTRA[0])
    assert restored.mutation_epoch == e + 1


# ---------------------------------------------------------------------------
# crash recovery
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", KINDS)
def test_kill_mid_wal_append_truncated_record(kind, tmp_path):
    """A torn tail record: replay stops at the last intact record and the
    file is repaired for later appends."""
    idx, store = fresh(kind, tmp_path)
    seed_mutations(idx)
    wal_path = store.wal.path
    size_before = os.path.getsize(wal_path)
    idx.insert("torn", EXTRA[2])         # the op whose record we mangle
    store.wal.close()
    with open(wal_path, "r+b") as f:     # cut mid-record: frame + 10 bytes
        f.truncate(size_before + 10)

    ref, _ = fresh(kind, tmp_path / "ref")
    seed_mutations(ref)

    restored = load(store.root)
    assert_bit_for_bit(ref, restored)
    assert "torn" not in restored
    restored.insert("after-crash", EXTRA[3])
    assert_bit_for_bit(restored, load(store.root))


def test_kill_between_snapshot_and_wal_truncation(tmp_path):
    """Snapshot published, WAL not yet cut: replay skips the records the
    snapshot covers by epoch."""
    idx, store = fresh("hnsw", tmp_path)
    seed_mutations(idx)
    with open(store.wal.path, "rb") as f:
        full_wal = f.read()              # as if truncation never happened
    store.snapshot(idx)
    store.wal.close()
    with open(store.wal.path, "wb") as f:
        f.write(full_wal)
    assert_bit_for_bit(idx, load(store.root))


@pytest.mark.parametrize("kind", KINDS)
def test_replay_is_idempotent(kind, tmp_path):
    idx, store = fresh(kind, tmp_path)
    seed_mutations(idx)
    store.snapshot(idx)
    tail_mutations(idx)
    wal_size = os.path.getsize(store.wal.path)
    r1 = load(store.root)
    r2 = load(store.root)
    assert os.path.getsize(store.wal.path) == wal_size   # loading logs nothing
    assert_bit_for_bit(r1, r2)


def test_crashed_snapshot_tmp_dir_is_ignored_and_collected(tmp_path):
    idx, store = fresh("flat", tmp_path)
    seed_mutations(idx)
    store.snapshot(idx)
    junk = os.path.join(store.root, "snap_999999999999.tmp")
    os.makedirs(junk)
    with open(os.path.join(junk, "vectors.00000.npz"), "wb") as f:
        f.write(b"partial garbage")
    restored = load(store.root)
    assert_bit_for_bit(idx, restored)
    restored._store.snapshot(restored)   # GC sweeps the crash debris
    assert not os.path.exists(junk)


def test_torn_first_wal_write_recovers_to_empty(tmp_path):
    _, store = fresh("flat", tmp_path)   # attach: config.json
    store.wal.close()
    with open(store.wal.path, "wb") as f:
        f.write(FILE_MAGIC[:2])          # crash during the very first write
    restored = load(store.root)
    assert restored.size == 0 and restored.mutation_epoch == 0
    restored.insert("first", EXTRA[0])
    assert load(store.root).keys() == ["first"]


def test_wal_record_framing_roundtrip(tmp_path):
    wal = WriteAheadLog(os.path.join(tmp_path, "w.log"))
    vec = np.arange(8, dtype=np.float32)
    wal.append("insert", epoch=3, meta={"key": "k\n1"},  # newline in key
               arrays={"vec": vec})
    wal.append("delete", epoch=4, meta={"key": "k2"})
    recs = list(wal.records())
    assert [h["op"] for h, _ in recs] == ["insert", "delete"]
    assert recs[0][0]["meta"]["key"] == "k\n1"
    assert np.array_equal(recs[0][1]["vec"], vec)
    assert recs[1][0]["epoch"] == 4 and recs[1][1] == {}


# ---------------------------------------------------------------------------
# secure-delete compaction
# ---------------------------------------------------------------------------
def _stored_forms(idx, key):
    """The bytes of ``key``'s row as the index holds it: the fp32 row and,
    under a lossy codec, its encoded row and scale."""
    if idx.kind == "flat":
        row = idx._rows.key2row[key]
        vec, enc, scl = (idx._rows.vectors, idx._rows.encoded,
                         idx._rows.scales)
    else:
        row = idx._key2id[key]
        vec, enc, scl = idx._builder.vectors, idx._enc, idx._scales
    forms = [vec[row].tobytes()]
    if enc is not None:
        forms.append(enc[row].tobytes())
    if scl is not None:
        forms.append(scl[row].tobytes())
    return forms


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", KINDS)
def test_secure_delete_bytes_absent(kind, dtype, tmp_path):
    """After compaction a deleted row's bytes — the raw WAL payload, every
    normalized fp32 form, its encoded row and its scale — appear in no
    file under the store, and neither does its key."""
    v = DATA[7]
    targets = {v.tobytes(),
               normalize_rows(DATA[7:8])[0].astype(np.float32).tobytes(),
               (v / max(float(np.linalg.norm(v)), 1e-12)
                ).astype(np.float32).tobytes()}
    idx, store = fresh(kind, tmp_path, dtype, page_bytes=1024)
    idx.bulk_insert([f"d{i}" for i in range(60)], DATA)
    store.snapshot(idx)
    idx.insert("late", EXTRA[0])         # keeps a live record in the WAL
    forms = _stored_forms(idx, "d7")
    targets |= set(forms)
    assert all(any(f in b for _, b in walk_bytes(store.root))
               for f in forms[1:])       # encoded forms are on disk now

    idx.delete("d7")
    store.compact(idx)

    for path, blob in walk_bytes(store.root):
        for t in targets:
            assert t not in blob, f"bytes of d7 survive in {path}"
        assert b'"d7"' not in blob, f"key d7 survives in {path}"
    restored = load(store.root)
    assert_bit_for_bit(idx, restored)
    assert restored.size == 60           # 60 - d7 + late
    keys, _ = restored.query(DATA[8], k=5)
    assert keys[0] == "d8" and "d7" not in keys


@pytest.mark.parametrize("kind", KINDS)
def test_compact_preserves_live_set_and_bumps_epoch(kind, tmp_path):
    idx, store = fresh(kind, tmp_path)
    seed_mutations(idx)
    live_before = set(idx.keys())
    epoch_before = idx.mutation_epoch
    store.compact(idx)
    assert idx.mutation_epoch > epoch_before
    assert set(idx.keys()) == live_before
    assert idx._row_count() == idx.size  # no tombstoned rows remain
    keys, _ = idx.query(DATA[3], k=5)
    assert keys[0] == "d3"
    assert len(store.snapshots()) == 1   # exactly the compacted snapshot


def test_compact_invalidates_retrieval_cache(tmp_path):
    idx, store = fresh("flat", tmp_path)
    seed_mutations(idx)
    eng = RetrievalEngine(idx, max_batch=8)
    r1 = eng.retrieve(DATA[3], k=3)[0]
    r2 = eng.retrieve(DATA[3], k=3)[0]
    assert r2.from_cache and r1.keys == r2.keys
    store.compact(idx)                   # epoch bump must flush the LRU
    r3 = eng.retrieve(DATA[3], k=3)[0]
    assert not r3.from_cache
    assert eng.stats.invalidations == 1


def test_failed_mutation_after_wal_append_does_not_poison_restore(tmp_path):
    idx, store = fresh("flat", tmp_path)
    idx.insert("a", EXTRA[0])
    with pytest.raises(ValueError):
        idx.insert("bad", np.ones(7, np.float32))    # dim 7 != 16
    idx.insert("b", EXTRA[1])
    restored = load(store.root)
    assert_bit_for_bit(idx, restored)
    assert restored.keys() == ["a", "b"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("op", ["insert", "bulk_insert"])
def test_replay_error_that_is_not_validation_propagates(kind, op, tmp_path,
                                                        monkeypatch):
    """Only the validation errors a live op raised may be skipped on
    replay; a device failure (here a RuntimeError from the impl) must fail
    the restore, not return an index without the record's rows."""
    idx, store = fresh(kind, tmp_path)
    idx.bulk_insert([f"d{i}" for i in range(8)], DATA[:8])
    idx.insert("solo", EXTRA[0])

    def boom(self, *args):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(type(idx), f"_{op}_impl", boom)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        load(store.root)


def test_public_compact_on_attached_index_stays_durable(tmp_path):
    idx, store = fresh("flat", tmp_path)
    seed_mutations(idx)
    idx.compact()                                    # public entry point
    idx.insert("after", EXTRA[2])                    # post-compact WAL tail
    assert_bit_for_bit(idx, load(store.root))        # no WalCorruption
    assert len(store.snapshots()) == 1


@pytest.mark.parametrize("kind", KINDS)
def test_compact_to_empty_live_set(kind, tmp_path):
    idx, store = fresh(kind, tmp_path)
    idx.insert("only", EXTRA[0])
    idx.delete("only")
    store.compact(idx)
    assert idx.size == 0 and idx.mutation_epoch > 0
    for _, blob in walk_bytes(store.root):
        assert EXTRA[0].tobytes() not in blob
    restored = load(store.root)
    assert restored.size == 0
    assert restored.mutation_epoch == idx.mutation_epoch
    restored.insert("reborn", EXTRA[1])
    assert load(store.root).keys() == ["reborn"]


# ---------------------------------------------------------------------------
# policies + factory integration
# ---------------------------------------------------------------------------
def test_snapshot_every_policy_auto_snapshots(tmp_path):
    idx, store = fresh("flat", tmp_path, snapshot_every=5)
    for j in range(12):
        idx.insert(f"a{j}", EXTRA[j % len(EXTRA)])
    assert len(store.snapshots()) == 2   # at mutations 5 and 10, keep=2
    assert sum(1 for _ in store.wal.records()) == 2
    assert_bit_for_bit(idx, load(store.root))


def test_make_index_store_cold_then_warm(tmp_path):
    sd = os.path.join(tmp_path, "s")
    idx = tmake_index("hnsw", store=sd, device="cpu", **CFG)   # cold
    assert idx.size == 0 and os.path.exists(os.path.join(sd, "config.json"))
    seed_mutations(idx)
    warm = tmake_index("hnsw", store=sd, device="cpu",         # warm
                       **dict(CFG, M=4, ef_search=7))          # stored wins
    assert (warm.M, warm.ef_search) == (8, 32)
    assert_bit_for_bit(idx, warm)


def test_make_index_store_kind_and_dtype_mismatch_raise(tmp_path):
    sd = os.path.join(tmp_path, "s")
    idx = tmake_index("flat", store=sd, device="cpu", dtype="int8", **CFG)
    idx.insert("a", EXTRA[0])
    with pytest.raises(ValueError, match="holds a 'flat'"):
        tmake_index("hnsw", store=sd, device="cpu", **CFG)
    with pytest.raises(ValueError, match="cannot restore it as dtype"):
        tmake_index("flat", store=sd, device="cpu", dtype="fp32", **CFG)


def test_retrieval_engine_adopts_restored_epoch(tmp_path):
    idx, store = fresh("hnsw", tmp_path)
    seed_mutations(idx)
    store.snapshot(idx)
    restored = load(store.root)
    assert restored.mutation_epoch > 0
    eng = RetrievalEngine(restored, max_batch=8)
    assert eng._cache_epoch == restored.mutation_epoch
    r1 = eng.retrieve(DATA[3], k=3)[0]
    assert eng.retrieve(DATA[3], k=3)[0].from_cache
    top = r1.keys[0]
    restored.delete(top)                 # retraction after the restart
    r3 = eng.retrieve(DATA[3], k=3)[0]
    assert not r3.from_cache and top not in r3.keys


@pytest.mark.parametrize("kind", KINDS)
def test_export_load_after_deletes_matches_live(kind, tmp_path):
    idx = tmake_index(kind, device="cpu", **CFG)
    seed_mutations(idx)
    tail_mutations(idx)
    p = os.path.join(tmp_path, "idx.npz")
    idx.export(p)
    loaded = type(idx).load(p, device="cpu")
    assert_bit_for_bit(idx, loaded)
    for gone in ("d9", "d40", "d17"):
        assert gone not in loaded
        keys, _ = loaded.query(DATA[int(gone[1:])], k=10)
        assert gone not in keys
    exact, _ = loaded.exact_query(DATA[9], k=10)
    assert "d9" not in exact
    assert isinstance(VectorIndex.load(p, device="cpu"), type(idx))


# ---------------------------------------------------------------------------
# across packages: same operations, same bytes; stores load both ways
# ---------------------------------------------------------------------------
def _ops(idx, store):
    """One operation sequence for either package: snapshot mid-way, then a
    WAL tail, then a second snapshot, then another tail."""
    seed_mutations(idx)
    store.snapshot(idx)
    tail_mutations(idx)
    store.snapshot(idx)
    idx.insert("z", EXTRA[10])
    idx.delete("d3")


def _both(kind, dtype, tmp_path):
    js = JIndexStore(os.path.join(tmp_path, "jax"))
    ts = IndexStore(os.path.join(tmp_path, "torch"))
    cfg = dict(CFG, dtype=dtype)
    jidx = jmake_index(kind, store=js, **cfg)
    tidx = tmake_index(kind, store=ts, device="cpu", **cfg)
    return (jidx, js), (tidx, ts)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", KINDS)
def test_store_files_equal_to_reference(kind, dtype, tmp_path):
    (jidx, js), (tidx, ts) = _both(kind, dtype, tmp_path)
    _ops(jidx, js)
    _ops(tidx, ts)
    js.wal.close()
    ts.wal.close()
    for name in ("wal.log", "config.json"):
        with open(os.path.join(js.root, name), "rb") as a, \
                open(os.path.join(ts.root, name), "rb") as b:
            assert a.read() == b.read(), name
    assert js.snapshots() == ts.snapshots() and len(ts.snapshots()) == 2
    for snap in ts.snapshots():
        jdir, tdir = (os.path.join(js.root, snap),
                      os.path.join(ts.root, snap))
        with open(os.path.join(jdir, "manifest.json"), "rb") as a, \
                open(os.path.join(tdir, "manifest.json"), "rb") as b:
            assert a.read() == b.read(), snap
        assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir))
        (_, ja), (_, ta) = jread_snapshot(jdir), read_snapshot(tdir)
        assert set(ja) == set(ta)
        for name in ja:
            assert ja[name].dtype == ta[name].dtype, name
            np.testing.assert_array_equal(ta[name], ja[name], err_msg=name)


def _assert_same_answers(a, b, queries, exact: bool):
    ka, da = a.query_batch(queries, 6)
    kb, db = b.query_batch(queries, 6)
    assert ka == kb
    if exact:
        np.testing.assert_array_equal(np.asarray(db), np.asarray(da))
    else:
        np.testing.assert_allclose(np.asarray(db), np.asarray(da),
                                   rtol=1e-5, atol=1e-5)
    assert a.mutation_epoch == b.mutation_epoch
    assert a.keys() == b.keys()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", KINDS)
def test_stores_cross_load_between_packages(kind, dtype, tmp_path):
    """A store written by repro restores in the port and one written by
    the port restores in repro, each giving the writer's keys, distances
    and epoch."""
    (jidx, js), (tidx, ts) = _both(kind, dtype, tmp_path)
    _ops(jidx, js)
    _ops(tidx, ts)
    t_from_j = IndexStore(js.root).load_index(device="cpu")
    j_from_t = JIndexStore(ts.root).load_index()
    _assert_same_answers(jidx, t_from_j, DATA[:5], exact=False)
    _assert_same_answers(j_from_t, tidx, DATA[:5], exact=False)


@pytest.mark.parametrize("kind", KINDS)
def test_cross_load_exact_on_integer_l2_rows(kind, tmp_path):
    rng = np.random.default_rng(4)
    rows = rng.integers(-4, 5, size=(50, DIM)).astype(np.float32)
    q = rng.integers(-4, 5, size=(6, DIM)).astype(np.float32)
    cfg = dict(CFG, metric="l2")
    js = JIndexStore(os.path.join(tmp_path, "jax"))
    ts = IndexStore(os.path.join(tmp_path, "torch"))
    for idx, st in ((jmake_index(kind, store=js, **cfg), js),
                    (tmake_index(kind, store=ts, device="cpu", **cfg), ts)):
        idx.bulk_insert([f"r{i}" for i in range(50)], rows)
        st.snapshot(idx)
        idx.delete("r4")
        idx.insert("r50", rows[7] + 1)
    _assert_same_answers(JIndexStore(ts.root).load_index(),
                         IndexStore(js.root).load_index(device="cpu"), q,
                         exact=True)


def test_sharded_store_raises_not_implemented(tmp_path):
    """A store whose config records n_shards 2 (as the reference writes
    one) restores at 2 shards; the name is kept from when it raised."""
    sd = os.path.join(tmp_path, "s")
    idx = tmake_index("flat", store=sd, device="cpu", **CFG)
    idx.insert("a", EXTRA[0])
    cfgp = os.path.join(sd, "config.json")
    with open(cfgp) as f:
        cfg = json.load(f)
    cfg["params"]["n_shards"] = 2
    with open(cfgp, "w") as f:
        json.dump(cfg, f)
    back = IndexStore(sd).load_index(device="cpu")
    assert back.shard_count == 2 and back.keys() == ["a"]
    again = tmake_index("flat", store=sd, device="cpu", **CFG)
    assert again.shard_count == 2 and again.keys() == ["a"]


def test_n_shards_override_raises_not_implemented(tmp_path):
    """The ``n_shards`` override reshards on restore (the name is kept
    from when it raised)."""
    sd = os.path.join(tmp_path, "s")
    idx = tmake_index("hnsw", store=sd, device="cpu", **CFG)
    seed_mutations(idx)
    two = IndexStore(sd).load_index(n_shards=2, device="cpu")
    assert two.shard_count == 2 and two.size == idx.size
    assert two.keys() == idx.keys()
    assert two.mutation_epoch == idx.mutation_epoch
    assert two.exact_query(DATA[:3], 5)[0] == idx.exact_query(DATA[:3], 5)[0]
    assert IndexStore(sd).load_index(n_shards=1, device="cpu").size == \
        idx.size


# ---------------------------------------------------------------------------
# the served warm path on the CPU
# ---------------------------------------------------------------------------
def test_launch_serve_store_dir_restores_warm(tmp_path, caplog):
    sd = str(tmp_path / "store")
    argv = ["--rag", "--index", "hnsw", "--index-dtype", "int8",
            "--store-dir", sd, "--device", "cpu", "--requests", "3",
            "--max-new", "2", "--max-len", "96", "--slots", "2"]
    cold = tserve.main(argv)
    wal = os.path.getsize(os.path.join(sd, "wal.log"))
    epoch = cold["rag"].index.mutation_epoch
    assert epoch > 0 and len(IndexStore(sd).snapshots()) == 1
    with caplog.at_level(logging.INFO, logger="repro_torch"):
        warm = tserve.main(argv)
    assert "warm restore from" in caplog.text
    idx = warm["rag"].index
    assert idx.mutation_epoch == epoch and idx.size == cold["rag"].index.size
    assert os.path.getsize(os.path.join(sd, "wal.log")) == wal
    assert len(IndexStore(sd).snapshots()) == 1
    got = [[d.key for d in r.docs] for r in warm["reqs"]]
    assert got == [[d.key for d in r.docs] for r in cold["reqs"]]
    assert all(len(k) == 3 for k in got)
    assert idx.config_dict() == cold["rag"].index.config_dict()


@pytest.mark.parametrize("kind", KINDS)
def test_replay_skips_a_live_type_error_as_the_reference(kind, tmp_path):
    """An insert with an unhashable key raises TypeError live after its
    WAL record landed; replay skips that record as the reference's does,
    so both packages restore the 21 rows, and each restores the other's
    store."""
    (jidx, js), (tidx, ts) = _both(kind, "fp32", tmp_path)
    for idx in (jidx, tidx):
        idx.bulk_insert([f"d{i}" for i in range(20)], DATA[:20])
        with pytest.raises(TypeError):
            idx.insert(["x"], EXTRA[0])
        idx.insert("after", EXTRA[1])
    j_back = JIndexStore(js.root).load_index()
    t_back = IndexStore(ts.root).load_index(device="cpu")
    t_from_j = IndexStore(js.root).load_index(device="cpu")
    j_from_t = JIndexStore(ts.root).load_index()
    for got in (t_back, t_from_j, j_from_t):
        assert got.size == 21
        _assert_same_answers(j_back, got, DATA[:5], exact=False)
    assert_bit_for_bit(tidx, t_back)


# ---------------------------------------------------------------------------
# IVF and tiered: trained centroids through the WAL, stores across packages
# ---------------------------------------------------------------------------
IVF_CFG = dict(dim=DIM, metric="cosine", nlist=8, nprobe=3)


def _ops_trained(idx, store):
    """A history whose restore needs both IVF centroid paths: trained
    centroids inside a snapshot, then (after a compaction drops them) a
    ``derived.centroids`` record in the WAL tail."""
    seed_mutations(idx)
    idx.query(DATA[0], 3)                  # trains IVF: a derived record
    store.snapshot(idx)
    tail_mutations(idx)
    idx.compact()                          # snapshot; centroids dropped
    idx.query(DATA[1], 3)                  # retrains: a record in the WAL
    idx.insert("z", EXTRA[10])
    idx.delete("d3")


def _derived_records(root):
    wal = WriteAheadLog(os.path.join(root, "wal.log"))
    try:
        return [(h, a) for h, a in wal.records()
                if h["op"].startswith("derived.")]
    finally:
        wal.close()


@pytest.mark.parametrize("dtype", DTYPES)
def test_ivf_warm_restore_replays_trained_centroids(dtype, tmp_path):
    store = IndexStore(os.path.join(tmp_path, "store"))
    idx = tmake_index("ivf", store=store, device="cpu", dtype=dtype,
                      **IVF_CFG)
    _ops_trained(idx, store)
    (head, arrays), = _derived_records(store.root)
    assert head["op"] == "derived.centroids"
    assert head["epoch"] == idx.mutation_epoch - 2
    np.testing.assert_array_equal(arrays["centroids"], idx._centroids)
    back = load(store.root)
    assert_bit_for_bit(idx, back)
    assert back._centroids.tobytes() == idx._centroids.tobytes()


def test_ivf_store_files_equal_to_reference(tmp_path, monkeypatch):
    """The same history through both packages, the port's k-means started
    from the reference's draw on integer-valued l2 rows (exact sums, so
    equal centroids): WAL (its derived.centroids record included),
    config.json and every manifest.json equal byte for byte, the pages
    array for array."""
    import jax

    from repro_torch.core import ivf as tivf
    monkeypatch.setattr(tivf, "init_rows", lambda n, k, seed: np.asarray(
        jax.random.choice(jax.random.PRNGKey(seed), n, (k,), replace=False)))
    rng = np.random.default_rng(8)
    centers = rng.integers(-30, 31, size=(5, DIM)) * 4
    rows = (centers[rng.integers(0, 5, 80)]
            + rng.integers(-2, 3, size=(80, DIM))).astype(np.float32)
    cfg = dict(IVF_CFG, metric="l2", nlist=5)
    js = JIndexStore(os.path.join(tmp_path, "jax"))
    ts = IndexStore(os.path.join(tmp_path, "torch"))
    wal_mid = []
    for idx, st in ((jmake_index("ivf", store=js, **cfg), js),
                    (tmake_index("ivf", store=ts, device="cpu", **cfg), ts)):
        idx.bulk_insert([f"r{i}" for i in range(70)], rows[:70])
        st.snapshot(idx)
        idx.query(rows[0], 3)                       # trains
        idx.insert("r70", rows[70])
        idx.delete("r4")
        with open(os.path.join(st.root, "wal.log"), "rb") as f:
            wal_mid.append(f.read())
        st.snapshot(idx)
        idx.update("r5", rows[71])
        idx.insert("r72", rows[72])
        st.wal.close()
    assert b"derived.centroids" in wal_mid[1] and wal_mid[0] == wal_mid[1]
    for name in ("wal.log", "config.json"):
        with open(os.path.join(js.root, name), "rb") as a, \
                open(os.path.join(ts.root, name), "rb") as b:
            assert a.read() == b.read(), name
    assert js.snapshots() == ts.snapshots() and len(ts.snapshots()) == 2
    for snap in ts.snapshots():
        jdir, tdir = (os.path.join(js.root, snap),
                      os.path.join(ts.root, snap))
        with open(os.path.join(jdir, "manifest.json"), "rb") as a, \
                open(os.path.join(tdir, "manifest.json"), "rb") as b:
            assert a.read() == b.read(), snap
        (_, ja), (_, ta) = jread_snapshot(jdir), read_snapshot(tdir)
        assert set(ja) == set(ta)
        for name in ja:
            assert ja[name].dtype == ta[name].dtype, name
            np.testing.assert_array_equal(ta[name], ja[name], err_msg=name)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["ivf", "tiered"])
def test_ivf_and_tiered_stores_cross_load(kind, dtype, tmp_path):
    """A store written by repro restores in the port with the reference's
    centroids (replayed from its WAL) and keys, and one written by the
    port restores in repro with the port's."""
    cfg = dict(IVF_CFG, dtype=dtype) if kind == "ivf" else dict(CFG,
                                                              dtype=dtype)
    js = JIndexStore(os.path.join(tmp_path, "jax"))
    ts = IndexStore(os.path.join(tmp_path, "torch"))
    jidx = jmake_index(kind, store=js, **cfg)
    tidx = tmake_index(kind, store=ts, device="cpu", **cfg)
    _ops_trained(jidx, js)
    _ops_trained(tidx, ts)
    t_from_j = IndexStore(js.root).load_index(device="cpu")
    j_from_t = JIndexStore(ts.root).load_index()
    if kind == "ivf":
        assert len(_derived_records(js.root)) == 1
        assert t_from_j._centroids.tobytes() == jidx._centroids.tobytes()
        assert j_from_t._centroids.tobytes() == tidx._centroids.tobytes()
    _assert_same_answers(jidx, t_from_j, DATA[:5], exact=False)
    _assert_same_answers(j_from_t, tidx, DATA[:5], exact=False)
