from repro_torch.kernels.cgemm.ops import (
    Variant, cgemm_cuda, choose_variant, operand_variant, shape_for_blocks)
from repro_torch.kernels.cgemm.ref import cgemm_ref

__all__ = ["Variant", "cgemm_cuda", "cgemm_ref", "choose_variant",
           "operand_variant", "shape_for_blocks"]
