"""Mean wall of a traced ``query_batch`` less the device-busy time inside
it: the host's share of a batch (upload, reads back, key mapping)."""


def read(rec):
    span = (rec.get("trace") or {}).get("spans", {}).get(
        "chipbench.query_batch")
    if not span:
        return None
    return (span["wall_s"] - span["busy_s"]) * 1e3
