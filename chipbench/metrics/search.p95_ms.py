"""95th percentile, over every batch the caller timed outside the traced
stretch, of the time from the call into ``HNSW.query_batch`` until its
keys are on the host: the tail the caller sees, on the host's clock."""
from chipbench.lib.arith import percentile


def read(rec):
    lat = rec.get("latencies_s")
    return percentile(lat, 95) * 1e3 if lat else None
