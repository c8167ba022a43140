"""The attention's share of its roofline in a training step: the tower's
forward, the decoder's forward and backward (the run's ``opmap``:
``opmap.json`` and the family's)."""

from benchlib import roofline

OPS = ("tower_attention", "train_attention_fwd", "train_attention_bwd")


def read(rec):
    if rec["loop"] != "train" or rec.get("trace") is None:
        return None
    return roofline.share(OPS, rec["work"], rec["trace"]["kernel_s"], rec["opmap"])
