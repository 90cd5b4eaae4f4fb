"""Queries answered in the window over the window's seconds (in the traced
run, whose profiled stretch slows part of it)."""


def read(rec):
    if "queries" not in rec:
        return None
    return rec["queries"] / rec["window_s"]
