"""Utterances answered over all of the window's time (host clock)."""


def read(rec):
    return rec["utterances"] / rec["window_s"] if rec["loop"] == "eval" else None
