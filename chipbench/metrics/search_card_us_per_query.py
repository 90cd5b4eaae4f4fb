"""Microseconds the card is busy for each query answered: the union of
every kernel, copy and set interval over the whole untraced window, from
the device-only profiler, over the queries answered in it."""


def read(rec):
    card = rec.get("card_busy")
    if not card or not rec.get("queries"):
        return None
    return card["busy_s"] * 1e6 / rec["queries"]
