"""The tile transforms' least time (forward and inverse tile DFTs of every
conv call of the window, and the kernel transforms a training step needs)
over the device time of the tile DFT kernels in the traced window, in %."""
from chipbench import work
from chipbench.harness import is_kernel, log


def read(run):
    if run.trace is None:
        return None
    t = run.trace.op_seconds(is_kernel("dft"))
    if t <= 0:
        log("dft_roofline: no tile DFT kernel in the trace")
        return None
    return 100.0 * work.conv_least_s(run.rec["calls"], "dft") / t
