"""Share of the traced evaluation window in which nothing ran on the device."""


def read(rec):
    t = rec.get("trace")
    if rec["loop"] != "eval" or t is None:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
