"""The least time a traced ``beam_search`` launch could take (the
distinct rows and lists its traversal needs at the HBM rate, or its
multiply-adds at the fp32 rate) over its profiler time a launch."""
from chipbench.lib.arith import roofline_ms


def read(rec):
    work = rec.get("beam_work")
    k = (rec.get("trace") or {}).get("kernels", {}).get("beam_search")
    if not work or not k:
        return None
    bound, _ = roofline_ms(work["bytes"], work["flops"])
    return 100.0 * bound / (k["s_per_launch"] * 1e3)
