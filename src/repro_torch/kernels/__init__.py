"""Hand-written CUDA kernels of the port (``sm_90a``), one package each.

Every kernel package has a ``csrc/<name>.cu`` source, a ``ref.py`` plain
PyTorch version and an ``ops.py`` wrapper that runs the plain version for a
CPU tensor and launches the kernel for a CUDA tensor (or raises).  Nothing
is compiled or loaded when these modules are imported.
"""
