"""The attention's share of its roofline in evaluation: the tower's, the
prefill's and the decode's, where their kernels ran (the run's ``opmap``:
``opmap.json`` and the family's)."""

from benchlib import roofline

OPS = ("tower_attention", "prefill_attention", "decode_attention")


def read(rec):
    if rec["loop"] != "eval" or rec.get("trace") is None:
        return None
    return roofline.share(OPS, rec["work"], rec["trace"]["kernel_s"], rec["opmap"])
