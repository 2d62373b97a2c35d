"""Direct-convolution model FLOPs completed in the traced window over the
window times the card's dense TF32 rate (``work.MFU_PEAK_FLOPS``), in %."""
from chipbench import work


def read(run):
    if run.trace is None or not run.rec.get("model_flops"):
        return None
    return 100.0 * run.rec["model_flops"] / (run.trace.window_s
                                             * work.MFU_PEAK_FLOPS)
