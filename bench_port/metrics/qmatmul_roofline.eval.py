"""The weight-only quantized products' share of their roofline in
evaluation, where their kernels ran (``opmap.json``)."""

from benchlib import roofline


def read(rec):
    if rec["loop"] != "eval" or rec.get("trace") is None:
        return None
    return roofline.share(("qmatmul",), rec["work"], rec["trace"]["kernel_s"],
                          roofline.load_opmap())
