"""Share of the device's operation time in cuDNN's convolution kernels
(the ``direct`` backend's convs), in %.  A graph replay's kernels carry no
span of the site that launched them, so they are told by name: cuDNN's
and its implicit-GEMM kernels' names, never the hand kernels'."""
import re

from chipbench.harness import is_kernel

CUDNN = re.compile(r"cudnn|fprop|implicit_convolve|implicit_gemm|xmma_"
                   r"|winograd|conv2d_|convolve_|dgrad|wgrad"
                   r"|nchwToNhwc|nhwcToNchw")


def is_direct_conv(name: str) -> bool:
    return bool(CUDNN.search(name)) and not is_kernel("hand")(name)


def read(run):
    if run.trace is None or not run.trace.ops:
        return None
    t = run.trace.op_seconds(is_direct_conv)
    if t <= 0:
        return None
    return 100.0 * t / run.trace.op_seconds()
