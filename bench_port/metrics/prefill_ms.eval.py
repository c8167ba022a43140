"""Mean prefill time of the window's batches: the engine's ``StepEvents``
(CUDA events) from the prefill's start to its first token."""


def read(rec):
    rows = [t[0] for t in rec.get("step_ms") or [] if t]
    return sum(rows) / len(rows) if rec["loop"] == "eval" and rows else None
