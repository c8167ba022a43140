"""Synchronising CUDA calls a training step, counted by
``torch.cuda.set_sync_debug_mode`` over the traced window."""


def read(rec):
    if rec["loop"] != "train" or rec.get("trace") is None:
        return None
    return rec["syncs"] / rec["steps"]
