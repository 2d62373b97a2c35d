"""The CGEMM stage's least time (``work.cgemm_work`` of every conv call of
the window, forward and dx) over the device time of the CGEMM kernel in
the traced window, in %."""
from chipbench import work
from chipbench.harness import is_kernel, log


def read(run):
    if run.trace is None:
        return None
    t = run.trace.op_seconds(is_kernel("cgemm"))
    if t <= 0:
        log("cgemm_roofline: no CGEMM kernel in the trace")
        return None
    return 100.0 * work.conv_least_s(run.rec["calls"], "cgemm") / t
