// P-batched complex GEMM for Hopper (sm_90a): Z[p] = D[p] @ G[p] for every
// frequency point p, complex numbers held as separate real/imag planes.
//
//   D (P, M, C) x G (P, C, N) -> Z (P, M, N), all contiguous row-major.
//   3M (Karatsuba): T1 = Dr Gr, T2 = Di Gi, T3 = (Dr + Di)(Gr + Gi),
//                   Zr = T1 - T2, Zi = T3 - T1 - T2
//   4M:             Zr = Dr Gr - Di Gi, Zi = Dr Gi + Di Gr
//
// Replaces: src/repro/kernels/cgemm/kernel.py:_cgemm_kernel (Pallas, TPU).
//
// Operands are float32 or bfloat16; every product and sum is taken in
// float32 and Z is written in the operand dtype.  (The Pallas kernel adds
// each K block into its output ref, in bf16 for bf16 operands; this kernel
// keeps the whole K sum in float32 registers, so in bf16 it agrees with the
// float32 reference within bf16 rounding, not bit for bit with Pallas.)
//
// Design.  The TPU kernel walks the contraction axis as the innermost
// sequential grid dimension and accumulates in its VMEM-resident output
// block.  Here blocks run in parallel in no order, so K is a loop inside
// the block and the sums stay in registers: each block owns one (p, BM x BN)
// output tile, stages BK-deep slices of D and G in shared memory (widened to
// float32, with the 3M sums Dr+Di and Gr+Gi formed once per element as the
// slice is staged), and each thread accumulates a TM x TN micro-tile per
// product plane with FMAs.  P is grid.z.  Ragged M, N and C are masked in
// the kernel (zero-filled slices, guarded stores): the wrapper never pads.
// Thread columns are interleaved (n = tc + j * BN/TN) so the shared-memory
// reads are conflict-free and the stores of a warp are contiguous.
//
// Bound on an H100.  At the VGG trunk's widths (224x224, batch 4) the whole
// forward is about 19 GFLOP of 3M products.  Vconv1.x-3.x have M >= 64 and
// are bound by arithmetic; this kernel uses the CUDA cores (67 TFLOP/s in
// float32), not the tensor cores.  From Vconv4.1 on M <= 16 and reading the
// prepared G slab sets the pace: 130 * 512 * 512 * 8 B = 273 MB at
// Vconv4.2, 81 us at 3.35 TB/s.  For those shapes a block with BM = 16 and
// BN = 128 reads each G element once per launch; a kernel that streams G
// through TMA at the full memory rate, and wgmma tiles for the large-M
// layers, are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>

namespace {

template <typename T>
struct Cvt;

template <>
struct Cvt<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ float store(float v) { return v; }
};

template <>
struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float v) {
    return __float2bfloat16(v);
  }
};

template <typename T, int BM, int BN, int BK, int TM, int TN, bool THREE_M>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    cgemm_kernel(const T* __restrict__ dr, const T* __restrict__ di,
                 const T* __restrict__ gr, const T* __restrict__ gi,
                 T* __restrict__ zr, T* __restrict__ zi, int M, int C,
                 int N) {
  constexpr int kRowThreads = BM / TM;
  constexpr int kColThreads = BN / TN;
  constexpr int kThreads = kRowThreads * kColThreads;
  constexpr int kPlanes = THREE_M ? 3 : 2;  // re, im (+ re+im for 3M)
  __shared__ float As[kPlanes][BK][BM + 1];
  __shared__ float Bs[kPlanes][BK][BN];

  const int p = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const T* dr_p = dr + (size_t)p * M * C;
  const T* di_p = di + (size_t)p * M * C;
  const T* gr_p = gr + (size_t)p * C * N;
  const T* gi_p = gi + (size_t)p * C * N;

  const int tid = threadIdx.x;
  const int tr = tid / kColThreads;
  const int tc = tid % kColThreads;

  float acc[kPlanes][TM][TN];
#pragma unroll
  for (int q = 0; q < kPlanes; ++q)
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[q][i][j] = 0.f;

  for (int k0 = 0; k0 < C; k0 += BK) {
    // D slice (BM x BK), read along C, stored K-major for the inner loop
    for (int e = tid; e < BM * BK; e += kThreads) {
      const int mm = e / BK, kk = e % BK;
      const int m = m0 + mm, k = k0 + kk;
      float a_r = 0.f, a_i = 0.f;
      if (m < M && k < C) {
        const size_t o = (size_t)m * C + k;
        a_r = Cvt<T>::load(dr_p + o);
        a_i = Cvt<T>::load(di_p + o);
      }
      As[0][kk][mm] = a_r;
      As[1][kk][mm] = a_i;
      if constexpr (THREE_M) As[2][kk][mm] = a_r + a_i;
    }
    // G slice (BK x BN), read along N
    for (int e = tid; e < BK * BN; e += kThreads) {
      const int kk = e / BN, nn = e % BN;
      const int k = k0 + kk, n = n0 + nn;
      float b_r = 0.f, b_i = 0.f;
      if (k < C && n < N) {
        const size_t o = (size_t)k * N + n;
        b_r = Cvt<T>::load(gr_p + o);
        b_i = Cvt<T>::load(gi_p + o);
      }
      Bs[0][kk][nn] = b_r;
      Bs[1][kk][nn] = b_i;
      if constexpr (THREE_M) Bs[2][kk][nn] = b_r + b_i;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[kPlanes][TM], b[kPlanes][TN];
#pragma unroll
      for (int q = 0; q < kPlanes; ++q) {
#pragma unroll
        for (int i = 0; i < TM; ++i) a[q][i] = As[q][kk][tr + i * kRowThreads];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[q][j] = Bs[q][kk][tc + j * kColThreads];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          if constexpr (THREE_M) {
            acc[0][i][j] = fmaf(a[0][i], b[0][j], acc[0][i][j]);  // T1
            acc[1][i][j] = fmaf(a[1][i], b[1][j], acc[1][i][j]);  // T2
            acc[2][i][j] = fmaf(a[2][i], b[2][j], acc[2][i][j]);  // T3
          } else {
            acc[0][i][j] = fmaf(a[0][i], b[0][j], acc[0][i][j]);
            acc[0][i][j] = fmaf(-a[1][i], b[1][j], acc[0][i][j]);
            acc[1][i][j] = fmaf(a[0][i], b[1][j], acc[1][i][j]);
            acc[1][i][j] = fmaf(a[1][i], b[0][j], acc[1][i][j]);
          }
        }
    }
    __syncthreads();
  }

  T* zr_p = zr + (size_t)p * M * N;
  T* zi_p = zi + (size_t)p * M * N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + tr + i * kRowThreads;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tc + j * kColThreads;
      if (m < M && n < N) {
        float re, im;
        if constexpr (THREE_M) {
          re = acc[0][i][j] - acc[1][i][j];
          im = acc[2][i][j] - acc[0][i][j] - acc[1][i][j];
        } else {
          re = acc[0][i][j];
          im = acc[1][i][j];
        }
        const size_t o = (size_t)m * N + n;
        zr_p[o] = Cvt<T>::store(re);
        zi_p[o] = Cvt<T>::store(im);
      }
    }
  }
}

template <typename T, int BM, int BN, int BK, int TM, int TN>
void launch_tiles(const T* dr, const T* di, const T* gr, const T* gi, T* zr,
                  T* zi, int P, int M, int C, int N, bool three_m,
                  cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, P);
  const dim3 block((BM / TM) * (BN / TN));
  if (three_m)
    cgemm_kernel<T, BM, BN, BK, TM, TN, true>
        <<<grid, block, 0, stream>>>(dr, di, gr, gi, zr, zi, M, C, N);
  else
    cgemm_kernel<T, BM, BN, BK, TM, TN, false>
        <<<grid, block, 0, stream>>>(dr, di, gr, gi, zr, zi, M, C, N);
}

template <typename T>
int run(const void* dr, const void* di, const void* gr, const void* gi,
        void* zr, void* zi, int P, int M, int C, int N, int three_m,
        void* stream) {
  if (P <= 0 || M <= 0 || N <= 0 || C < 0 || P > 65535)
    return (int)cudaErrorInvalidValue;
  cudaGetLastError();  // start from a clean error state
  const T* a_r = static_cast<const T*>(dr);
  const T* a_i = static_cast<const T*>(di);
  const T* b_r = static_cast<const T*>(gr);
  const T* b_i = static_cast<const T*>(gi);
  T* c_r = static_cast<T*>(zr);
  T* c_i = static_cast<T*>(zi);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 32)  // few tiles per frequency point: wide N tiles, one G read
    launch_tiles<T, 16, 128, 16, 4, 4>(a_r, a_i, b_r, b_i, c_r, c_i, P, M,
                                       C, N, three_m != 0, s);
  else
    launch_tiles<T, 64, 64, 16, 4, 4>(a_r, a_i, b_r, b_i, c_r, c_i, P, M, C,
                                      N, three_m != 0, s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int cgemm_f32(const void* dr, const void* di, const void* gr,
                         const void* gi, void* zr, void* zi, int P, int M,
                         int C, int N, int three_m, void* stream) {
  return run<float>(dr, di, gr, gi, zr, zi, P, M, C, N, three_m, stream);
}

extern "C" int cgemm_bf16(const void* dr, const void* di, const void* gr,
                          const void* gi, void* zr, void* zi, int P, int M,
                          int C, int N, int three_m, void* stream) {
  return run<__nv_bfloat16>(dr, di, gr, gi, zr, zi, P, M, C, N, three_m,
                            stream);
}

extern "C" const char* cgemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
