"""Share of the traced stretch in which no operation ran on the card."""


def read(rec):
    tr = rec.get("trace")
    if not tr or not tr.get("window_s"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
