"""Launches of the port's hand-written kernels a training step
(``kernels.launch_counts()`` over the window)."""


def read(rec):
    if rec["loop"] != "train":
        return None
    return sum(rec["launches"].values()) / rec["steps"]
