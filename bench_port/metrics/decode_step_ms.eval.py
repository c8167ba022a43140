"""Mean decode step of the window: the sum of the engine's ``StepEvents``
step intervals over their count."""


def read(rec):
    steps = [ms for t in rec.get("step_ms") or [] for ms in t[1:]]
    return sum(steps) / len(steps) if rec["loop"] == "eval" and steps else None
