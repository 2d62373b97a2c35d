from repro_torch.kernels.cgemm.ops import cgemm_cuda
from repro_torch.kernels.cgemm.ref import cgemm_ref

__all__ = ["cgemm_cuda", "cgemm_ref"]
