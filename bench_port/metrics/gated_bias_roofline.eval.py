"""BEATs' gated-bias attention's share of its roofline in evaluation, where
its kernel ran (the run's ``opmap``: the family's ``beats_attention``)."""

from benchlib import roofline

OPS = ("beats_attention",)


def read(rec):
    if rec["loop"] != "eval" or rec.get("trace") is None:
        return None
    return roofline.share(OPS, rec["work"], rec["trace"]["kernel_s"], rec["opmap"])
