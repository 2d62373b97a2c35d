"""Mean device time of a step's backward (CUDA events around
``autograd.grad``), over the traced window's steps, in ms."""
import statistics


def read(run):
    ms = run.rec.get("bwd_ms")
    if not ms:
        return None
    return statistics.fmean(ms)
