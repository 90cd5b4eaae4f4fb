"""Rows over the wall of the set-up's bulk build, timed around the call."""


def read(rec):
    if not rec.get("build_s"):
        return None
    return rec["build_rows"] / rec["build_s"]
