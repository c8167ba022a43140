"""Seconds from process start to the first timed batch or step: imports,
CUDA start, weights, the port's set-up and the warm-up (host clock)."""


def read(rec):
    return rec["setup_s"]
