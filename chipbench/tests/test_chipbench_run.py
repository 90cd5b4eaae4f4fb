"""Runs of the search driver on the CPU at a size a test can hold, past the
harness's look for a card: a clean run is correct and its result line has
the contract's keys; the control (one precision below the
configuration's) and each fault the cell can have, planted in the program
underneath the timed path, come out not correct; the reference's HNSW
search follows the port's, and its graph check sees a broken graph."""
import time

import numpy as np
import pytest

from chipbench import control
from chipbench import run as bench_run
from chipbench.drivers import hnsw_search
from chipbench.lib import reference, spec

SEARCH_CFG = dict(name="tiny-search", rows=2000, dim=16, metric="cosine",
                  M=5, ef_construction=20, ef_search=24, dtype="fp32",
                  clusters=8, center_scale=1.5,
                  limits={"dist_gap": 1e-5, "bad_answers": 0,
                          "traversal_miss": 0.05, "graph_faults": 0})
SEARCH_MIX = dict(driver="hnsw_search", batch=32, k=5, ef=24, pool_batches=4,
                  check_batches=4, trace_at=0.4, trace_s=0.1,
                  work_launches=2)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while these timed runs share the CPU with other
    test workers; restored after the module."""
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def search(seed=3, seconds=0.3):
    return hnsw_search.run(SEARCH_CFG, SEARCH_MIX, seed=seed, seconds=seconds,
                           trace=False, t0=time.perf_counter(), device="cpu")


@pytest.fixture(scope="module")
def tiny_index(one_thread):
    import torch
    rows, pool = hnsw_search.make_inputs(SEARCH_CFG, SEARCH_MIX, 3, "cpu")
    idx = hnsw_search.build_index(SEARCH_CFG, rows.numpy(), "cpu")
    return rows, pool, idx, hnsw_search.graph_of(idx, torch.device("cpu"))


def test_search_run_is_correct_and_its_line_has_the_keys():
    rec = search()
    assert rec["correct"], rec["checks"]
    assert set(rec["checks"]) == {"dist_gap", "bad_answers",
                                  "traversal_miss", "graph_faults"}
    assert rec["info"]["judged_queries"] == 4 * 32
    bench = spec.load_benchmark()
    out = bench_run.result(bench, "mememo-1m.search-b1024", rec, False,
                           "cpu", 1)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    # the card's busy time needs the card: a CPU run has none to report
    assert set(out["metrics"]) == {"setup_s"}
    assert rec["cpu_s"] > 0
    assert out["device"]["count"] == 1
    traced = bench_run.result(bench, "mememo-1m.search-b1024", rec, True,
                              "cpu", 1)
    # the readers of what an untraced run lacks return nothing
    assert set(traced["metrics"]) == {"build.rows_per_s", "search_qps",
                                      "search.p95_ms"}
    assert list(traced)[-2:] == ["breakdown", "checks"]
    assert all(set(c) == {"value", "limit"} for c in out["checks"].values())


def test_search_control_is_not_correct():
    """The readings the limits are set from, at the test's size: the
    program passes, the TF32 control and every degraded search fail."""
    out = control.search_readings(SEARCH_CFG, SEARCH_MIX, 3, "cpu")
    assert out["program"]["correct"], out["program"]
    lim = SEARCH_CFG["limits"]
    assert out["control"]["dist_gap"] > lim["dist_gap"]
    for name in control.FAULTS:
        assert out[name]["traversal_miss"] > lim["traversal_miss"], name
        assert not out[name]["correct"], name


@pytest.mark.parametrize("fault", ["answer_altered", "half_batch_left_out",
                                   "strangers", "descent_skipped",
                                   "beam_one_hop"])
def test_search_fault_is_not_correct(monkeypatch, fault):
    from repro_torch.core.interface import HNSW
    if fault in control.FAULTS:
        with control.FAULTS[fault]():
            assert not search()["correct"]
        return
    orig = HNSW.query_batch

    def broken(self, queries, k=10, ef=None):
        keys, dists = orig(self, queries, k=k, ef=ef)
        if fault == "answer_altered":
            keys[0][0] = "r" + str((int(keys[0][0][1:]) + 1) % 2000)
        elif fault == "half_batch_left_out":
            h = len(keys) // 2
            keys[h:], dists[h:] = keys[:len(keys) - h], dists[:len(keys) - h]
        else:
            # real rows with their true distances, in order, but not the
            # neighbours: the k after the best 3k of each query
            import torch
            x = torch.as_tensor(self._builder.vectors[:self._builder.n])
            ids, d = reference.exact_topk(reference.unit_rows(x),
                                          torch.as_tensor(queries), 4 * k)
            keys = [[self._keys[i] for i in row[3 * k:]]
                    for row in ids.tolist()]
            dists = d[:, 3 * k:].numpy()
        return keys, dists
    monkeypatch.setattr(HNSW, "query_batch", broken)
    rec = search()
    assert not rec["correct"]
    if fault == "strangers":
        c = rec["checks"]
        assert c["dist_gap"]["value"] <= c["dist_gap"]["limit"]
        assert c["bad_answers"]["value"] == 0
        assert c["traversal_miss"]["value"] > 0.5


def test_reference_search_follows_the_port(tiny_index):
    """The reference's descent and beam over the port's graph return the
    port's keys, query for query (both fp32 on the CPU)."""
    rows, pool, idx, graph = tiny_index
    rows_by_id = reference.unit_rows(rows)[graph["rows"]]
    for b in range(len(pool)):
        keys, _ = idx.query_batch(pool[b].numpy(), k=5, ef=24)
        walk = reference.hnsw_search(rows_by_id, graph, pool[b], 5, 24)
        got = np.array([[int(x[1:]) for x in row] for row in keys])
        assert (graph["rows"][walk].numpy() == got).all()


def test_graph_faults_counts_each_broken_invariant(tiny_index):
    *_, graph = tiny_index
    assert graph["max_level"] > 0
    assert reference.graph_faults(graph) == 0
    top = int(graph["entry"])
    low = int((graph["levels"] == 0).nonzero()[0, 0])
    broken = {k: (v.clone() if hasattr(v, "clone") else v)
              for k, v in graph.items()}
    broken["neighbors0"][5, 0] = 5                   # a link to itself
    broken["neighbors0"][6, :2] = broken["neighbors0"][6, 0]   # repeated
    broken["upper"][0, low, 0] = top                 # above the node's level
    broken["upper"][0, top, 0] = low                 # to a node below it
    assert reference.graph_faults(broken) == 4


def test_reservoir_keeps_a_seeded_sample_of_fixed_size():
    picks = []
    for seed in (7, 7, 8):
        r = hnsw_search.Reservoir(16, seed)
        for i in range(1000):
            r.offer(i)
        assert len(r.items) == 16 and len(set(r.items)) == 16
        picks.append(sorted(r.items))
    assert picks[0] == picks[1] != picks[2]
    # the whole stream is sampled, not its start
    assert max(picks[0]) > 500
