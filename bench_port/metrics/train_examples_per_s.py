"""Examples stepped over all of the window's time (host clock)."""


def read(rec):
    return rec["examples"] / rec["window_s"] if rec["loop"] == "train" else None
