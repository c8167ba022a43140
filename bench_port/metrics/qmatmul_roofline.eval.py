"""The weight-only quantized products' share of their roofline in
evaluation, where their kernels ran (the run's ``opmap``: ``opmap.json``
and the family's)."""

from benchlib import roofline


def read(rec):
    if rec["loop"] != "eval" or rec.get("trace") is None:
        return None
    return roofline.share(("qmatmul",), rec["work"], rec["trace"]["kernel_s"], rec["opmap"])
