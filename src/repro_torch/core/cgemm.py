"""Batched complex matrix multiplication (stage 3, the hot stage).

Z[p] = D[p] @ G[p] for every frequency point p, with complex operands kept
as separate real/imag planes (struct-of-arrays).

Two arithmetic schedules:
  * 4M: Zr = DrGr - DiGi ; Zi = DrGi + DiGr          (4 real matmuls)
  * 3M (Karatsuba): T1 = DrGr ; T2 = DiGi ; T3 = (Dr+Di)(Gr+Gi)
       Zr = T1 - T2 ; Zi = T3 - T1 - T2              (3 real matmuls)

Shapes: D (P, M, C), G (P, C, N) -> Z (P, M, N), accumulated and returned
in ``acc`` (float32).  This is the ``fft-torch`` stage 3; the CUDA kernel
of ``repro_torch.kernels.cgemm`` computes the same on the card.
"""
from __future__ import annotations

import torch


def _mm(a, b, acc):
    # operands widened to the accumulation dtype: float32 products and sums
    # whatever the operand dtype (the twin of preferred_element_type=f32)
    return torch.matmul(a.to(acc), b.to(acc))


def cgemm_4m(Dr, Di, Gr, Gi, *, acc=torch.float32):
    Zr = _mm(Dr, Gr, acc) - _mm(Di, Gi, acc)
    Zi = _mm(Dr, Gi, acc) + _mm(Di, Gr, acc)
    return Zr, Zi


def cgemm_3m(Dr, Di, Gr, Gi, *, acc=torch.float32):
    T1 = _mm(Dr, Gr, acc)
    T2 = _mm(Di, Gi, acc)
    T3 = _mm(Dr + Di, Gr + Gi, acc)
    return T1 - T2, T3 - T1 - T2


def cgemm(Dr, Di, Gr, Gi, *, three_m: bool = True, acc=torch.float32):
    f = cgemm_3m if three_m else cgemm_4m
    return f(Dr, Di, Gr, Gi, acc=acc)
