"""Set-up seconds: process start to the first timed call (loading,
drawing the rows, building the index, warming every shape)."""


def read(rec):
    return rec.get("setup_s")
