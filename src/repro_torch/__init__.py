"""repro_torch — the FFT convolution engine of ``repro`` on PyTorch and CUDA.

The package mirrors ``repro``'s module layout (``core``, ``conv``,
``kernels``, ``configs``, ``models``, ``launch``) so that every module has
an obvious counterpart.  It imports ``torch`` and numpy only.  The hot
kernels are hand-written CUDA C++ for Hopper (``sm_90a``) under
``kernels/*/csrc``, built with ``nvcc`` at first use; on a CPU tensor every
kernel wrapper runs its plain PyTorch version instead.

Importing the package loads no CUDA code and starts no build.
"""

__version__ = "0.1.0"
