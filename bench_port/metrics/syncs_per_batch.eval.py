"""Synchronising CUDA calls a batch, counted by
``torch.cuda.set_sync_debug_mode`` over the traced window."""


def read(rec):
    if rec["loop"] != "eval" or rec.get("trace") is None:
        return None
    return rec["syncs"] / rec["batches"]
