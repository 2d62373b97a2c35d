"""Share of the device's operation time spent outside the seven hand
kernels (layout copies, pads, unfolds, elementwise passes, pools, and in
training cuDNN's weight gradient and the optimizer), in %."""
from chipbench.harness import is_kernel


def read(run):
    if run.trace is None or not run.trace.ops:
        return None
    total = run.trace.op_seconds()
    hand = run.trace.op_seconds(is_kernel("hand"))
    return 100.0 * (total - hand) / total
