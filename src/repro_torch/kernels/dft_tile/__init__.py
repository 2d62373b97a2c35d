from repro_torch.kernels.dft_tile.ops import (
    DEFAULT_TILES, INVERSE_TILES, image_rfft_cuda, resolve_tiles,
    tile_fft_cuda, tile_ifft_cuda, tile_ifft_epilogue_cuda, tile_irfft_cuda,
    tile_irfft_epilogue_cuda, tile_rfft_cuda,
)
from repro_torch.kernels.dft_tile.ref import (
    tile_fft_ref, tile_ifft_epilogue_ref, tile_ifft_ref,
    tile_irfft_epilogue_ref, tile_irfft_ref, tile_rfft_ref,
)

__all__ = ["tile_rfft_cuda", "image_rfft_cuda", "tile_irfft_cuda",
           "tile_irfft_epilogue_cuda", "tile_fft_cuda", "tile_ifft_cuda",
           "tile_ifft_epilogue_cuda", "tile_rfft_ref", "tile_irfft_ref",
           "tile_irfft_epilogue_ref", "tile_fft_ref", "tile_ifft_ref",
           "tile_ifft_epilogue_ref", "INVERSE_TILES", "DEFAULT_TILES",
           "resolve_tiles"]
