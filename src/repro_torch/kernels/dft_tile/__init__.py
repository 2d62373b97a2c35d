from repro_torch.kernels.dft_tile.ops import tile_irfft_epilogue_cuda
from repro_torch.kernels.dft_tile.ref import tile_irfft_epilogue_ref

__all__ = ["tile_irfft_epilogue_cuda", "tile_irfft_epilogue_ref"]
