"""Model flops of the window's batches (``benchlib/work.py``) over the
window's time and the card's bf16 peak, in percent."""

from benchlib.roofline import PEAK_BF16_FLOPS


def read(rec):
    if rec["loop"] != "eval":
        return None
    return 100.0 * rec["model_flops"] / (rec["window_s"] * PEAK_BF16_FLOPS)
