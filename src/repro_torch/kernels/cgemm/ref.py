"""Plain PyTorch version of the CUDA batched complex GEMM kernel."""
from __future__ import annotations

from repro_torch.core.cgemm import cgemm


def cgemm_ref(Dr, Di, Gr, Gi, *, three_m: bool = True):
    """Z[p] = D[p] @ G[p]; (P,M,C) x (P,C,N) -> (P,M,N) real/imag pair.

    The kernel's arithmetic: operands widened to float32 (so the 3M sums
    Dr+Di and Gr+Gi are float32 too), float32 products and accumulation,
    Z returned in the operand dtype.
    """
    Zr, Zi = cgemm(Dr.float(), Di.float(), Gr.float(), Gi.float(),
                   three_m=three_m)
    return Zr.to(Dr.dtype), Zi.to(Dr.dtype)
