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
// float32 and Z is written in the operand dtype.  The 3M sums Dr+Di and
// Gr+Gi are formed in float32 registers from the widened operands, as
// cgemm_ref forms them.  (The Pallas kernel adds each K block into its
// output ref, in bf16 for bf16 operands; this kernel keeps the whole K sum
// in float32 registers, so in bf16 it agrees with the float32 reference
// within bf16 rounding, not bit for bit with Pallas.)
//
// What bounds it on an H100.  At the VGG trunk's widths (224x224, batch 4,
// P = 130) a served forward is 19 GFLOP of 3M products and 1.23 GB of
// operands and results.  The layers with M >= 64 (Vconv1.x-3.x) hold 13.2
// of the 19 GFLOP and are bound by arithmetic: the CUDA cores' 67 TFLOP/s
// in float32 (no tensor cores: float32 results must not go through TF32).
// The layers with M <= 32 (Vconv4.1-5) hold 716 of the 1234 MB, almost all
// of it the prepared G slab, and are bound by bytes at 3.35 TB/s.
//
// Design.  The TPU kernel walks C as the innermost sequential grid axis
// and accumulates in its VMEM-resident output block; here blocks run in
// parallel in no order, so C is a loop inside the block and the sums stay
// in registers.  One kernel template over the tile shapes of kShapes, in
// three forms chosen by the wrapper (ops.choose_variant passes its code):
//
//  (a) large M (M > 32): a 64x64 block tile, 128 threads, each holding an
//      8x4 micro-tile per product plane (96 float32 accumulators in 3M).
//      BK-deep slices of D and G go global -> shared with 16-byte cp.async
//      into a ring of 3 slots, so the loads of later slices overlap the
//      FMAs of this one.  Once a slice lands, one pass turns D's slice
//      K-major (and widens bf16 to float32), so a thread reads its 8 rows
//      and 4 columns of each k as LDS.128: 6 of them per 96 FMAs, and
//      TM + TN FADDs form the 3M sums.  Two or three blocks share an SM,
//      so one block's barriers and K-loop tail overlap another's FMAs;
//      128x64 and 64x128 tiles of 256 threads, one block per SM, were
//      slower at every layer but Vconv3.x (cgemm.sweep; PERF.md).
//  (b) small M (M <= 32): BM in {4, 8, 16, 32} covers all of M, so a block
//      owns (p, 128 columns) and reads each G element exactly once per
//      launch, streaming C through the same ring (3 or 4 slots) with D's
//      BM x BK slice riding in the same stage.  At these shapes the kernel
//      is a stream of G, bound by bytes.
//  (c) either tile with masked scalar loads instead of cp.async, for
//      operands that cp.async cannot take: a row of D or G that is not a
//      multiple of 16 bytes (C = 3 at Vconv1.1), or a pointer that is not
//      16-byte aligned.  Z keeps its vector stores wherever its rows allow.
//
// Ragged M, N and C are masked in the kernel (zero-filled copies, guarded
// stores, and the last slice of a ragged C skips its zero k): the wrapper
// never pads.  P is grid.z.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

// ---- the tile shapes; ops.py:SHAPES holds the same table ----------------

struct Shape {
  int bm, bn, bk, tm, tn, stages;
};

constexpr Shape kShapes[] = {
    {64, 64, 16, 8, 4, 3},   // 0: large M
    {4, 128, 16, 1, 4, 3},   // 1-4: small M, the least BM that covers M
    {8, 128, 16, 2, 4, 4},
    {16, 128, 16, 4, 4, 4},
    {32, 128, 16, 8, 4, 4},
};
constexpr int kNumShapes = sizeof(kShapes) / sizeof(kShapes[0]);

template <typename T, int BM, int BN, int BK, int TM, int TN, int STAGES>
struct Layout {
  static constexpr int kThreads = (BM / TM) * (BN / TN);
  static constexpr int kVec = 16 / (int)sizeof(T);  // elements per 16 bytes
  // a raw D row is padded by 16 bytes so the K-major pass reads it
  // without bank conflicts
  static constexpr int kDRow = BK + kVec;
  static constexpr int kDRaw = BM * kDRow;          // elements per plane
  static constexpr int kGRaw = BK * BN;
  static constexpr int kStage = 2 * (kDRaw + kGRaw);  // elements per slot
  static constexpr int kStageBytes = kStage * (int)sizeof(T);
  static constexpr int kAsFloats = 2 * BK * BM;     // K-major D, 2 planes
  // bf16 G widened to float32 once per slice, not once per read
  static constexpr int kBwFloats = sizeof(T) == 4 ? 0 : 2 * BK * BN;
  static constexpr int kSmem =
      STAGES * kStageBytes + 4 * (kAsFloats + kBwFloats);
  static_assert(BK % kVec == 0 && BN % kVec == 0, "16-byte chunks");
  static_assert(TM == 1 || TM == 2 || TM % 4 == 0, "A fragment loads");
  static_assert(TN % 4 == 0, "vector stores of Z");
};

template <typename T>
using Bits = typename std::conditional<sizeof(T) == 4, uint32_t,
                                       uint16_t>::type;

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = ok ? 16 : 0;  // src-size 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// one 16-byte chunk of shared memory, widened to float32
__device__ __forceinline__ void read_chunk(const uint32_t* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
}

__device__ __forceinline__ void read_chunk(const uint16_t* p, float (&v)[8]) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {  // little endian: element 2q in the low half
    v[2 * q] = __uint_as_float(w[q] << 16);
    v[2 * q + 1] = __uint_as_float(w[q] & 0xffff0000u);
  }
}

template <int W>
__device__ __forceinline__ void lds(const float* p, float (&v)[W]) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int q = 0; q < W / 4; ++q) {
      const float4 t = reinterpret_cast<const float4*>(p)[q];
      v[4 * q] = t.x, v[4 * q + 1] = t.y, v[4 * q + 2] = t.z,
            v[4 * q + 3] = t.w;
    }
  } else if constexpr (W == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x, v[1] = t.y;
  } else {
    v[0] = p[0];
  }
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p,
                                       const float (&v)[4]) {
  uint32_t w[2];
#pragma unroll
  for (int q = 0; q < 2; ++q)
    w[q] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16(v[2 * q])) |
           ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(v[2 * q + 1]))
            << 16);
  *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

constexpr int kVecLoads = 1;   // D and G through 16-byte cp.async
constexpr int kVecStores = 2;  // Z in 16-byte (8 in bf16) stores

template <typename T, int BM, int BN, int BK, int TM, int TN, int STAGES,
          bool THREE_M>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    cgemm_kernel(const T* __restrict__ dr, const T* __restrict__ di,
                 const T* __restrict__ gr, const T* __restrict__ gi,
                 T* __restrict__ zr, T* __restrict__ zi, int M, int C,
                 int N, int flags) {
  using L = Layout<T, BM, BN, BK, TM, TN, STAGES>;
  using B = Bits<T>;
  constexpr int kThreads = L::kThreads;
  constexpr int kV = L::kVec;
  constexpr int kCT = BN / TN;                 // column threads
  constexpr int kPlanes = THREE_M ? 3 : 2;     // T1, T2, T3 / re, im

  extern __shared__ __align__(16) unsigned char smem[];
  B* ring = reinterpret_cast<B*>(smem);
  float* As = reinterpret_cast<float*>(smem + STAGES * L::kStageBytes);
  float* Bw = As + L::kAsFloats;

  const int p = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const B* drp = reinterpret_cast<const B*>(dr) + (size_t)p * M * C;
  const B* dip = reinterpret_cast<const B*>(di) + (size_t)p * M * C;
  const B* grp = reinterpret_cast<const B*>(gr) + (size_t)p * C * N;
  const B* gip = reinterpret_cast<const B*>(gi) + (size_t)p * C * N;

  const int tid = threadIdx.x;
  const int tr = tid / kCT;
  const int tc = tid % kCT;
  const int KT = (C + BK - 1) / BK;

  // global -> slot s of the ring: slice kt of D (BM x BK) and G (BK x BN)
  auto load_stage = [&](int kt, int s) {
    B* st = ring + s * L::kStage;
    const int k0 = kt * BK;
    if (flags & kVecLoads) {
      constexpr int kDC = BM * (BK / kV);      // chunks per D plane
      constexpr int kGC = BK * (BN / kV);      // chunks per G plane
#pragma unroll
      for (int it = 0; it < (2 * kDC + kThreads - 1) / kThreads; ++it) {
        const int e = tid + it * kThreads;
        if ((2 * kDC) % kThreads == 0 || e < 2 * kDC) {
          const int plane = e / kDC, r = e % kDC;
          const int mm = r / (BK / kV), c = r % (BK / kV);
          const int m = m0 + mm, k = k0 + c * kV;
          const bool ok = m < M && k < C;
          const B* src = (plane ? dip : drp) + (ok ? (size_t)m * C + k : 0);
          cp_async16(st + plane * L::kDRaw + mm * L::kDRow + c * kV, src, ok);
        }
      }
#pragma unroll
      for (int it = 0; it < (2 * kGC + kThreads - 1) / kThreads; ++it) {
        const int e = tid + it * kThreads;
        if ((2 * kGC) % kThreads == 0 || e < 2 * kGC) {
          const int plane = e / kGC, r = e % kGC;
          const int kk = r / (BN / kV), c = r % (BN / kV);
          const int k = k0 + kk, n = n0 + c * kV;
          const bool ok = k < C && n < N;
          const B* src = (plane ? gip : grp) + (ok ? (size_t)k * N + n : 0);
          cp_async16(st + 2 * L::kDRaw + plane * L::kGRaw + kk * BN + c * kV,
                     src, ok);
        }
      }
    } else {  // form (c): masked element loads, any alignment
      // kGroup loads in flight, then their stores into the slot; the
      // groups stay a loop, so their index math is not hoisted out of the
      // K loop into registers the FMAs need
      constexpr int kGroup = 8;
      constexpr int kDE = 2 * BM * BK, kGE = 2 * BK * BN;
      constexpr int kIters = (kDE + kGE + kThreads - 1) / kThreads;
#pragma unroll 1
      for (int g0 = 0; g0 < kIters; g0 += kGroup) {
        B v[kGroup];
        int at[kGroup];
#pragma unroll
        for (int q = 0; q < kGroup; ++q) {
          const int e = tid + (g0 + q) * kThreads;
          v[q] = B(0);
          at[q] = -1;
          if (g0 + q >= kIters) continue;
          if (e < kDE) {
            const int plane = e / (BM * BK), r = e % (BM * BK);
            const int mm = r / BK, kk = r % BK;
            const int m = m0 + mm, k = k0 + kk;
            at[q] = plane * L::kDRaw + mm * L::kDRow + kk;
            if (m < M && k < C) v[q] = (plane ? dip : drp)[(size_t)m * C + k];
          } else if (e < kDE + kGE) {
            const int plane = (e - kDE) / (BK * BN);
            const int r = (e - kDE) % (BK * BN);
            const int kk = r / BN, nn = r % BN;
            const int k = k0 + kk, n = n0 + nn;
            at[q] = 2 * L::kDRaw + plane * L::kGRaw + r;
            if (k < C && n < N) v[q] = (plane ? gip : grp)[(size_t)k * N + n];
          }
        }
#pragma unroll
        for (int q = 0; q < kGroup; ++q)
          if (at[q] >= 0) st[at[q]] = v[q];
      }
    }
  };

  // slot s -> D K-major in As (and bf16 G widened into Bw)
  auto prepare = [&](int s) {
    const B* st = ring + s * L::kStage;
    constexpr int kDC = BM * (BK / kV);
#pragma unroll
    for (int it = 0; it < (2 * kDC + kThreads - 1) / kThreads; ++it) {
      const int e = tid + it * kThreads;
      if ((2 * kDC) % kThreads == 0 || e < 2 * kDC) {
        const int plane = e / kDC, r = e % kDC;
        const int mm = r % BM, c = r / BM;  // neighbours: neighbouring rows
        float v[kV];
        read_chunk(st + plane * L::kDRaw + mm * L::kDRow + c * kV, v);
        float* dst = As + plane * BK * BM + c * kV * BM + mm;
#pragma unroll
        for (int q = 0; q < kV; ++q) dst[q * BM] = v[q];
      }
    }
    if constexpr (sizeof(T) == 2) {
      constexpr int kGC = BK * BN / kV;
#pragma unroll
      for (int it = 0; it < (2 * kGC + kThreads - 1) / kThreads; ++it) {
        const int e = tid + it * kThreads;
        if ((2 * kGC) % kThreads == 0 || e < 2 * kGC) {
          float v[kV];
          read_chunk(st + 2 * L::kDRaw + e * kV, v);  // planes adjoin
          float4* dst = reinterpret_cast<float4*>(Bw + e * kV);
          dst[0] = make_float4(v[0], v[1], v[2], v[3]);
          dst[1] = make_float4(v[4], v[5], v[6], v[7]);
        }
      }
    }
  };

  float acc[kPlanes][TM][TN];
#pragma unroll
  for (int q = 0; q < kPlanes; ++q)
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[q][i][j] = 0.f;

  // the FMAs of the first kmax k of slot s
  auto compute = [&](int s, int kmax) {
    const float* Ar = As + tr * TM;
    const float* Ai = Ar + BK * BM;
    const float* Br =
        (sizeof(T) == 4
             ? reinterpret_cast<const float*>(ring + s * L::kStage +
                                              2 * L::kDRaw)
             : Bw) +
        tc * TN;
    const float* Bi = Br + BK * BN;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      if (kk >= kmax) break;
      float ar[TM], ai[TM], br[TN], bi[TN];
      lds(Ar + kk * BM, ar);
      lds(Ai + kk * BM, ai);
      lds(Br + kk * BN, br);
      lds(Bi + kk * BN, bi);
      if constexpr (THREE_M) {
        float as[TM], bs[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) as[i] = ar[i] + ai[i];
#pragma unroll
        for (int j = 0; j < TN; ++j) bs[j] = br[j] + bi[j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            acc[0][i][j] = fmaf(ar[i], br[j], acc[0][i][j]);  // T1
            acc[1][i][j] = fmaf(ai[i], bi[j], acc[1][i][j]);  // T2
            acc[2][i][j] = fmaf(as[i], bs[j], acc[2][i][j]);  // T3
          }
      } else {
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            acc[0][i][j] = fmaf(ar[i], br[j], acc[0][i][j]);
            acc[0][i][j] = fmaf(-ai[i], bi[j], acc[0][i][j]);
            acc[1][i][j] = fmaf(ar[i], bi[j], acc[1][i][j]);
            acc[1][i][j] = fmaf(ai[i], br[j], acc[1][i][j]);
          }
      }
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();  // one group per slice, empty past the end
  }

  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % STAGES;
    cp_async_wait<STAGES - 2>();  // this thread's copies of slice kt
    __syncthreads();  // everyone's copies; everyone done with slice kt-1
    prepare(s);
    const int next = kt + STAGES - 1;  // into the slot slice kt-1 used
    if (next < KT) load_stage(next, next % STAGES);
    cp_async_commit();
    __syncthreads();  // As (and Bw) ready
    if (kt * BK + BK <= C)
      compute(s, BK);
    else  // the last slice of a ragged C: its k past C hold zeros
      compute(s, C - kt * BK);
  }

  const int n = n0 + tc * TN;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + tr * TM + i;
    if (m >= M) continue;
    const size_t row = ((size_t)p * M + m) * N;
#pragma unroll
    for (int j0 = 0; j0 < TN; j0 += 4) {
      float re[4], im[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (THREE_M) {
          re[j] = acc[0][i][j0 + j] - acc[1][i][j0 + j];
          im[j] = acc[2][i][j0 + j] - acc[0][i][j0 + j] - acc[1][i][j0 + j];
        } else {
          re[j] = acc[0][i][j0 + j];
          im[j] = acc[1][i][j0 + j];
        }
      }
      if (flags & kVecStores) {  // N a multiple of 4: all in or all out
        if (n + j0 < N) {
          store4(zr + row + n + j0, re);
          store4(zi + row + n + j0, im);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j0 + j < N) {
            store1(zr + row + n + j0 + j, re[j]);
            store1(zi + row + n + j0 + j, im[j]);
          }
      }
    }
  }
}

template <typename T, int BM, int BN, int BK, int TM, int TN, int STAGES>
int launch(const T* dr, const T* di, const T* gr, const T* gi, T* zr, T* zi,
           int P, int M, int C, int N, bool three_m, int flags,
           cudaStream_t stream) {
  using L = Layout<T, BM, BN, BK, TM, TN, STAGES>;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, P);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  auto kernel = three_m ? cgemm_kernel<T, BM, BN, BK, TM, TN, STAGES, true>
                        : cgemm_kernel<T, BM, BN, BK, TM, TN, STAGES, false>;
  // the shared-memory limit is raised once per kernel and device
  static uint64_t raised[2];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const uint64_t bit = 1ull << (dev & 63);
  if (!(raised[three_m] & bit)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
    if (err != cudaSuccess) return (int)err;
    raised[three_m] |= bit;
  }
  kernel<<<grid, L::kThreads, L::kSmem, stream>>>(dr, di, gr, gi, zr, zi, M,
                                                  C, N, flags);
  return (int)cudaGetLastError();
}

template <typename T, int I>
int launch_shape(const T* dr, const T* di, const T* gr, const T* gi, T* zr,
                 T* zi, int P, int M, int C, int N, bool three_m, int flags,
                 cudaStream_t stream) {
  constexpr Shape s = kShapes[I];
  return launch<T, s.bm, s.bn, s.bk, s.tm, s.tn, s.stages>(
      dr, di, gr, gi, zr, zi, P, M, C, N, three_m, flags, stream);
}

template <typename T>
int smem_bytes(int i) {
#define CGEMM_SMEM(I)                                                      \
  case I:                                                                  \
    return Layout<T, kShapes[I].bm, kShapes[I].bn, kShapes[I].bk,          \
                  kShapes[I].tm, kShapes[I].tn, kShapes[I].stages>::kSmem;
  switch (i) {
    CGEMM_SMEM(0)
    CGEMM_SMEM(1)
    CGEMM_SMEM(2)
    CGEMM_SMEM(3)
    CGEMM_SMEM(4)
  }
#undef CGEMM_SMEM
  return -1;
}
static_assert(kNumShapes == 5, "one case per shape in smem_bytes and run");

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

// variant = shape index, plus kNumShapes for the scalar-load form (c)
template <typename T>
int run(const void* dr, const void* di, const void* gr, const void* gi,
        void* zr, void* zi, int P, int M, int C, int N, int three_m,
        int variant, void* stream) {
  if (P <= 0 || M <= 0 || N <= 0 || C < 0 || P > 65535 || variant < 0 ||
      variant >= 2 * kNumShapes)
    return (int)cudaErrorInvalidValue;
  // cp.async needs 16-byte rows and pointers; the vector stores of Z
  // 16-byte rows and Z's pointers
  const bool rows_out = (N * sizeof(T)) % 16 == 0;
  const bool vec_loads = variant < kNumShapes;
  if (vec_loads && ((C * sizeof(T)) % 16 || !rows_out || !aligned16(dr) ||
                    !aligned16(di) || !aligned16(gr) || !aligned16(gi)))
    return (int)cudaErrorMisalignedAddress;
  const int flags = (vec_loads ? kVecLoads : 0) |
                    (rows_out && aligned16(zr) && aligned16(zi) ? kVecStores
                                                                : 0);
  cudaGetLastError();  // start from a clean error state
  const T* a_r = static_cast<const T*>(dr);
  const T* a_i = static_cast<const T*>(di);
  const T* b_r = static_cast<const T*>(gr);
  const T* b_i = static_cast<const T*>(gi);
  T* c_r = static_cast<T*>(zr);
  T* c_i = static_cast<T*>(zi);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CGEMM_CASE(I)                                                     \
  case I:                                                                 \
    return launch_shape<T, I>(a_r, a_i, b_r, b_i, c_r, c_i, P, M, C, N,   \
                              three_m != 0, flags, s);
  switch (variant % kNumShapes) {
    CGEMM_CASE(0)
    CGEMM_CASE(1)
    CGEMM_CASE(2)
    CGEMM_CASE(3)
    CGEMM_CASE(4)
  }
#undef CGEMM_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int cgemm_f32(const void* dr, const void* di, const void* gr,
                         const void* gi, void* zr, void* zi, int P, int M,
                         int C, int N, int three_m, int variant,
                         void* stream) {
  return run<float>(dr, di, gr, gi, zr, zi, P, M, C, N, three_m, variant,
                    stream);
}

extern "C" int cgemm_bf16(const void* dr, const void* di, const void* gr,
                          const void* gi, void* zr, void* zi, int P, int M,
                          int C, int N, int three_m, int variant,
                          void* stream) {
  return run<__nv_bfloat16>(dr, di, gr, gi, zr, zi, P, M, C, N, three_m,
                            variant, stream);
}

// The tile table as compiled, for holding ops.py's copy to it:
// out = {bm, bn, bk, tm, tn, threads, stages, smem bytes}.
extern "C" int cgemm_shape_info(int shape, int bf16, int* out) {
  if (shape < 0 || shape >= kNumShapes) return (int)cudaErrorInvalidValue;
  const Shape s = kShapes[shape];
  const int v[8] = {s.bm, s.bn, s.bk, s.tm, s.tn,
                    (s.bm / s.tm) * (s.bn / s.tn), s.stages,
                    bf16 ? smem_bytes<__nv_bfloat16>(shape)
                         : smem_bytes<float>(shape)};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}

extern "C" int cgemm_num_shapes() { return kNumShapes; }

extern "C" const char* cgemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
