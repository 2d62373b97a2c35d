// Tile DFTs for Hopper (sm_90a): stages 1, 2 and 4 of FFT convolution, on
// the compact spectrum="real" layout and on the rect rfft2 grid.  Six entry
// points:
//
//   tile_rfft_f32             forward tile DFT + compact gather (stages 1, 2)
//   tile_irfft_f32            compact scatter + inverse tile DFT (stage 4)
//   tile_irfft_epilogue_f32   the same inverse with bias + activation fused
//   tile_fft_f32              forward tile DFT on the rect grid
//   tile_ifft_f32             inverse tile DFT from the rect grid
//   tile_ifft_epilogue_f32    the same inverse with bias + activation fused
//
// delta <= 32 (odd delta included), dh = delta/2 + 1, R = delta*dh points on
// the rect grid, r = u*dh + v; float32 throughout.
//
// ---- forward: tile_rfft_f32 / tile_fft_f32 --------------------------------
// For every tile x[t] (delta x delta, contiguous):
//   1. B = x @ F_half^T                 (delta x delta times delta x dh),
//   2. T = F @ B                        (delta x delta times delta x dh),
//      compact form: only at the P_real stored points r = store[p];
//      rect form: at all R points, r = p,
// written as two flat planes tr[t][p], ti[t][p] (n x P_real, or n x R, which
// is the (n, delta, dh) rfft2 grid row-major).  F @ x @ F_half^T is the
// rfft2 of the tile; taking the w-axis product first costs delta*delta*dh
// real-by-complex products instead of delta^3.
//
// Two kernel forms, the code ops.choose_form passes (kForm*), each a
// template with the gather compiled in or out (kGather), so the compact and
// rect layouts cannot drift apart:
//   specialised (rfwd16_kernel): delta 16, the tile of every plan path, on
//     16-byte-aligned tiles.  Rows, then columns, in registers; the DFT
//     table by value in the launch's parameters (off the shared-memory
//     pipe); shared memory only for one transpose and the output rows.
//     Its design is set out above the kernel.
//   generic (rfwd_kernel): every delta <= 32, odd included, and tiles off
//     16 bytes.  The tables in shared memory once per block, a warp per
//     tile, B and the tile in per-warp shared buffers.  The launcher refuses
//     a form it cannot run (the specialised one on other deltas or on
//     misaligned planes): no silent fallback.
//
// Replaces: src/repro/kernels/dft_tile/kernel.py:_rfwd_kernel (compact,
// wrapped there by dft_tile/ops.py:tile_rfft_pallas) and :_fwd_kernel
// (rect, wrapped by tile_fft_pallas), Pallas on a TPU.
//
// Bound on an H100.  Per 16x16 tile the compact form reads 1,024 B and
// writes 2 x 130 floats (1,040 B); the rect form writes 2 x 144 floats
// (1,152 B).  The specialised form does about 8.2k FMAs a tile (16 kFLOP,
// 8 per byte), under the card's float32 ridge of 20 (67 TFLOP/s / 3.35
// TB/s), so it is bound by bytes: stage 1 of a served VGG forward at
// 224x224, batch 4 (156,672 tiles, 323 MB compact, 341 MB rect) is bounded
// by 0.10 ms.  The generic form issues about 580 shared-memory warp
// instructions a tile (its table, tile and B reads), which bound it near
// 0.35-0.39 ms there instead.
//
// ---- inverse: tile_irfft_f32 / tile_ifft_f32 (+ _epilogue) ---------------
// For every tile t of n:
//   1. compact form: conj-mirror scatter of the compact Hermitian list into
//      the rect grid,  Z[u][v] = (Zr[t][src[r]], sgn[r] * Zi[t][src[r]]),
//      r = u*dh + v (Zr/Zi rows have ld >= P_real points; trailing points
//      past P_real are never read);  rect form: Z[u][v] = row t of the
//      (n, R) planes as it is,
//   2. Y = Finv @ Z                     (delta x delta times delta x dh),
//   3. y = Re(Y @ W^T)                  (delta x dh times dh x delta),
//   4. epilogue entries only: y = act(y + bias[t]), act in {none, relu,
//      tanh-gelu, silu},
// written as y[t] (delta x delta, float32).  The column weights of the
// inverse rfft (1 for the self-conjugate DC and, at even delta, Nyquist
// columns, 2 for the rest) live in W, so odd and even delta take the same
// code.  One template, the tail (kTail) and the scatter (kScatter) compiled
// in or out.
//
// Replaces: src/repro/kernels/dft_tile/kernel.py:_rinv_kernel (compact,
// wrapped by tile_irfft_pallas), :_rinv_epilogue_kernel (compact, fused
// tail, tile_irfft_epilogue_pallas), :_inv_kernel (rect, tile_ifft_pallas)
// and :_inv_epilogue_kernel (rect, fused tail, tile_ifft_epilogue_pallas).
//
// Bound on an H100.  Per 16x16 tile the kernel reads 2 x 130 floats
// (compact) or 2 x 144 (rect), plus a bias with the tail, and writes 256
// floats (2.1-2.2 kB) for about 28 kFLOP of small complex products: 13
// FLOP per byte against the card's 20, so it is bound by memory traffic
// (247,808 output tiles of a served VGG forward, 539 MB rect: 0.16 ms).
//
// Design, the inverse forms and the generic forward form.  The Pallas
// kernels' gain is that the intermediate product never reaches device
// memory (nor, compact, the rect spectrum); the same holds here, in both
// forward forms too.  A block loads the DFT matrices and the layout table
// into shared memory once, then each of its warps walks over tiles
// (grid-stride): the warp reads its tile (or gathers its compact row
// through src/sgn) straight from device memory into a per-warp shared
// buffer, forms the intermediate there, and writes the result once,
// coalesced.  Warps of a block never wait on one another after the tables
// are loaded.  The generic forward kernel pads its matrix rows in shared
// memory so that a warp's column reads hit distinct banks.
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kWarps = 8;
constexpr int kMaxDelta = 32;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float activate(float y, int act) {
  switch (act) {
    case 1:
      return fmaxf(y, 0.f);
    case 2: {  // tanh approximation of gelu
      const float c = 0.7978845608028654f;  // sqrt(2 / pi)
      return 0.5f * y * (1.f + tanhf(c * (y + 0.044715f * y * y * y)));
    }
    case 3:
      return y / (1.f + expf(-y));
    default:
      return y;
  }
}

template <bool kGather>
__global__ void __launch_bounds__(kWarps * 32)
    rfwd_kernel(const float* __restrict__ x, float* __restrict__ tr,
                float* __restrict__ ti, const float* __restrict__ fr_g,
                const float* __restrict__ fi_g,
                const float* __restrict__ fhr_g,
                const float* __restrict__ fhi_g,
                const int* __restrict__ store_g, long long n, int P, int d) {
  extern __shared__ float smem[];
  const int dh = d / 2 + 1;
  const int R = d * dh;   // rect spectrum points
  const int DD = d * d;   // tile points
  // Rows of F, F_half and the tile are stored with a stride of d + 1: the
  // lanes of a warp read one column of several rows at once, and with a
  // stride of d (16) rows 0, 2, 4, ... would fall on one bank.
  const int ds = d + 1;
  float* fr = smem;       // F (d x d)
  float* fi = fr + d * ds;
  float* fhr = fi + d * ds;   // F_half (dh x d)
  float* fhi = fhr + dh * ds;
  int* store = reinterpret_cast<int*>(fhi + dh * ds);  // kGather only
  float* scratch = reinterpret_cast<float*>(store + (kGather ? P : 0));

  for (int e = threadIdx.x; e < DD; e += blockDim.x) {
    const int row = e / d;
    fr[e + row] = fr_g[e];  // e + row == row * ds + col
    fi[e + row] = fi_g[e];
  }
  for (int e = threadIdx.x; e < R; e += blockDim.x) {
    const int row = e / d;
    fhr[e + row] = fhr_g[e];
    fhi[e + row] = fhi_g[e];
  }
  if (kGather)
    for (int e = threadIdx.x; e < P; e += blockDim.x) store[e] = store_g[e];
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* xs = scratch + warp * (d * ds + 2 * R);  // the tile
  float* br = xs + d * ds;                        // B = x @ F_half^T
  float* bi = br + R;

  for (long long t = (long long)blockIdx.x * kWarps + warp; t < n;
       t += (long long)gridDim.x * kWarps) {
    const float* x_t = x + t * DD;
    for (int e = lane; e < DD; e += 32) xs[e + e / d] = x_t[e];
    __syncwarp();
    for (int e = lane; e < R; e += 32) {
      const int h = e / dh;
      const int v = e - h * dh;
      float sr = 0.f, si = 0.f;
      for (int w = 0; w < d; ++w) {
        const float xv = xs[h * ds + w];
        sr = fmaf(xv, fhr[v * ds + w], sr);
        si = fmaf(xv, fhi[v * ds + w], si);
      }
      br[e] = sr;
      bi[e] = si;
    }
    __syncwarp();
    float* tr_t = tr + t * P;
    float* ti_t = ti + t * P;
    for (int p = lane; p < P; p += 32) {
      const int r = kGather ? store[p] : p;
      const int u = r / dh;
      const int v = r - u * dh;
      float sr = 0.f, si = 0.f;
      for (int h = 0; h < d; ++h) {
        const float fre = fr[u * ds + h], fim = fi[u * ds + h];
        const float bre = br[h * dh + v], bim = bi[h * dh + v];
        sr = fmaf(fre, bre, sr);
        sr = fmaf(-fim, bim, sr);
        si = fmaf(fre, bim, si);
        si = fmaf(fim, bre, si);
      }
      tr_t[p] = sr;
      ti_t[p] = si;
    }
    __syncwarp();  // the next tile overwrites this warp's buffers
  }
}

// ---- the forward tile DFT at delta = 16 ("specialised" form) -------------
// A block of 128 threads takes 8 tiles, one block per 8 tiles.
//  Stage 1, by rows: thread (tile, h) loads row h with four 16-byte loads
//    straight into registers and forms B[h][v] = sum_w x[h][w] F_half[v][w].
//    B[h][0] and B[h][8] are real (F_half's rows 0 and 8 are real), so a row
//    of B is 16 floats: the two real columns and 7 complex ones.
//  Transpose: each thread writes its 16 floats to shared memory (four
//    16-byte stores), laid out as 8 complex "columns" c: c = 0 packs the two
//    real columns as z = B[:,0] + i B[:,8], c = 1..7 is B[:,c].
//  Stage 2, by columns: thread (tile, c) reads its column (16 complex) into
//    registers and forms Z[u] = sum_h F[u][h] z[h].  F[16-u] = conj(F[u]),
//    so the four sums over h of (Re F, Im F) x (Re z, Im z) give Z[u] and
//    Z[16-u] at once: 9 "units" (u = 0, u = 8 and the pairs (u, 16-u),
//    u = 1..7) cover a column.  The two warps of a 4-tile group split the
//    units (u = 0, 8 and pairs 1-3; pairs 4-7), so u is warp-uniform: every
//    table operand is the same for all lanes, at a compile-time offset of a
//    __grid_constant__ parameter: the compiler reads it from the constant
//    bank into uniform registers (ULDC), and no table read touches shared
//    memory.  Column 0 takes the same four sums, which are the two real
//    columns' transforms apart: T[u][0] = sum Re F z_r + i sum Im F z_r and
//    T[u][8] likewise from z_i.  (Unpacking them from Z[u] and Z[16-u], the
//    two-real-FFTs trick, costs the same and would mix the DC column's
//    rounding into the Nyquist column's.)  The compact form writes only its
//    130 stored points (the index map is compile-time), the rect form all
//    144.
//  Stores: the outputs go to a shared buffer in plane order; the 8 tiles'
//    rows are consecutive in each plane, so the block writes them out in
//    16-byte (rect) or 8-byte (compact) stores.
// About 8.2k FMAs a tile (4.1k a stage), 2 barriers a block, and per tile 4
// 16-byte shared stores and 16 8-byte loads for the transpose.
constexpr int kD16 = 16;
constexpr int kDh16 = kD16 / 2 + 1;
constexpr int kTiles16 = 8;                       // tiles per block
constexpr int kThreads16 = kTiles16 * kD16;       // one thread per row
constexpr int kRow16 = 20;     // floats per B row in shared (16 + 4: the
                               // 16-byte stores of 8 rows hit 8 bank quads)
constexpr int kTile16 = kD16 * kRow16 + 16;  // 336 = 16 mod 32: two tiles'
                                             // column reads miss each other

struct Tables16 {              // F_half = F[0:9], row-major, float32
  float re[kDh16][kD16];
  float im[kDh16][kD16];
};

// Index of rect point (u, v) in the compact layout at delta 16
// (core/dft.py:_compact_layout_np: rows 0-8 keep all 9 columns, rows 9-15
// drop columns 0 and 8).
__host__ __device__ constexpr int compact16(int u, int v) {
  return u <= 8 ? u * kDh16 + v : 81 + (u - 9) * 7 + (v - 1);
}

template <bool kGather>
__device__ __forceinline__ void put16(float* __restrict__ outr,
                                      float* __restrict__ outi, int u, int v,
                                      float re, float im) {
  const int p = kGather ? compact16(u, v) : u * kDh16 + v;
  outr[p] = re;
  outi[p] = im;
}

// One unit of column c: Z[U] and, for 1 <= U <= 7, Z[16 - U].
template <int U, bool kGather>
__device__ __forceinline__ void unit16(const Tables16& tab,
                                       const float (&zr)[kD16],
                                       const float (&zi)[kD16], int c,
                                       float* outr, float* outi) {
  constexpr bool kSingle = U == 0 || U == 8;   // F[U] real, Z[16-U] = Z[U]
  constexpr int kMirror = (kD16 - U) % kD16;
  float s1 = 0.f, s2 = 0.f, s3 = 0.f, s4 = 0.f;
#pragma unroll
  for (int h = 0; h < kD16; ++h) {
    const float a = tab.re[U][h];
    s1 = fmaf(a, zr[h], s1);
    s3 = fmaf(a, zi[h], s3);
    if constexpr (!kSingle) {
      const float b = tab.im[U][h];
      s2 = fmaf(b, zi[h], s2);
      s4 = fmaf(b, zr[h], s4);
    }
  }
  if (c == 0) {
    // the two real columns: T[U][0] = s1 + i s4 and T[U][8] = s3 + i s2,
    // T[16-U] their conjugates; each from its own sums, so neither
    // column's rounding reaches the other
    put16<kGather>(outr, outi, U, 0, s1, s4);
    put16<kGather>(outr, outi, U, 8, s3, s2);
    if constexpr (!kGather && !kSingle) {  // rows 9-15 of columns 0 and 8
      put16<kGather>(outr, outi, kMirror, 0, s1, -s4);
      put16<kGather>(outr, outi, kMirror, 8, s3, -s2);
    }
  } else {
    // Z[U] = (s1 - s2) + i(s3 + s4), Z[16-U] = (s1 + s2) + i(s3 - s4)
    put16<kGather>(outr, outi, U, c, s1 - s2, s3 + s4);
    if constexpr (!kSingle)
      put16<kGather>(outr, outi, kMirror, c, s1 + s2, s3 - s4);
  }
}

template <bool kGather>
__global__ void __launch_bounds__(kThreads16)
    rfwd16_kernel(const float* __restrict__ x, float* __restrict__ tr,
                  float* __restrict__ ti,
                  const __grid_constant__ Tables16 tab, long long n) {
  constexpr int P = kGather ? 130 : kD16 * kDh16;
  constexpr int V = P % 4 == 0 ? 4 : 2;          // floats per vector store
  __shared__ __align__(16) float sb[kTiles16 * kTile16];
  __shared__ __align__(16) float sor[kTiles16 * P];
  __shared__ __align__(16) float soi[kTiles16 * P];

  // stage 1: (tile q1, row h); stage 2: warp-uniform half of the units,
  // (tile q2, column c) within a 4-tile group
  const int q1 = threadIdx.x / kD16, h = threadIdx.x % kD16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int half = warp & 1;
  const int q2 = (warp >> 1) * 4 + lane / 8, c = lane % 8;
  const long long t0 = (long long)blockIdx.x * kTiles16;

  // stage 1: B[h][v], v = 0..8 real parts, v = 1..7 imaginary parts
  float xr[kD16];
  if (t0 + q1 < n) {
    const float4* row =
        reinterpret_cast<const float4*>(x + (t0 + q1) * kD16 * kD16) + h * 4;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float4 v = __ldg(row + k);
      xr[4 * k] = v.x;
      xr[4 * k + 1] = v.y;
      xr[4 * k + 2] = v.z;
      xr[4 * k + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int w = 0; w < kD16; ++w) xr[w] = 0.f;
  }
  float b[kD16];
#pragma unroll
  for (int v = 0; v < kDh16; ++v) {
    float sr = 0.f, si = 0.f;
#pragma unroll
    for (int w = 0; w < kD16; ++w) {
      sr = fmaf(xr[w], tab.re[v][w], sr);
      if (v != 0 && v != 8) si = fmaf(xr[w], tab.im[v][w], si);
    }
    if (v == 0) {
      b[0] = sr;
    } else if (v == 8) {
      b[1] = sr;
    } else {
      b[2 * v] = sr;
      b[2 * v + 1] = si;
    }
  }
  float4* brow = reinterpret_cast<float4*>(sb + q1 * kTile16 + h * kRow16);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    brow[k] = make_float4(b[4 * k], b[4 * k + 1], b[4 * k + 2], b[4 * k + 3]);
  __syncthreads();

  // stage 2: column c of tile q2
  float zr[kD16], zi[kD16];
#pragma unroll
  for (int hh = 0; hh < kD16; ++hh) {
    const float2 z = *reinterpret_cast<const float2*>(
        sb + q2 * kTile16 + hh * kRow16 + 2 * c);
    zr[hh] = z.x;
    zi[hh] = z.y;
  }
  float* outr = sor + q2 * P;
  float* outi = soi + q2 * P;
  if (half == 0) {
    unit16<0, kGather>(tab, zr, zi, c, outr, outi);
    unit16<8, kGather>(tab, zr, zi, c, outr, outi);
    unit16<1, kGather>(tab, zr, zi, c, outr, outi);
    unit16<2, kGather>(tab, zr, zi, c, outr, outi);
    unit16<3, kGather>(tab, zr, zi, c, outr, outi);
  } else {
    unit16<4, kGather>(tab, zr, zi, c, outr, outi);
    unit16<5, kGather>(tab, zr, zi, c, outr, outi);
    unit16<6, kGather>(tab, zr, zi, c, outr, outi);
    unit16<7, kGather>(tab, zr, zi, c, outr, outi);
  }
  __syncthreads();

  // the block's rows are consecutive in each plane
  const long long left = n - t0;
  const int tiles = left < kTiles16 ? (int)left : kTiles16;
  const int vecs = tiles * P / V;
  float* dr = tr + t0 * P;
  float* di = ti + t0 * P;
  for (int e = threadIdx.x; e < vecs; e += kThreads16) {
    if constexpr (V == 4) {
      reinterpret_cast<float4*>(dr)[e] =
          reinterpret_cast<const float4*>(sor)[e];
      reinterpret_cast<float4*>(di)[e] =
          reinterpret_cast<const float4*>(soi)[e];
    } else {
      reinterpret_cast<float2*>(dr)[e] =
          reinterpret_cast<const float2*>(sor)[e];
      reinterpret_cast<float2*>(di)[e] =
          reinterpret_cast<const float2*>(soi)[e];
    }
  }
}

template <bool kTail, bool kScatter>
__global__ void __launch_bounds__(kWarps * 32)
    rinv_kernel(const float* __restrict__ zr, const float* __restrict__ zi,
                const float* __restrict__ bias, float* __restrict__ y,
                const float* __restrict__ fvr_g,
                const float* __restrict__ fvi_g,
                const float* __restrict__ wr_g,
                const float* __restrict__ wi_g,
                const int* __restrict__ src_g,
                const float* __restrict__ sgn_g, long long n, int ld, int d,
                int act) {
  extern __shared__ float smem[];
  const int dh = d / 2 + 1;
  const int R = d * dh;   // rect spectrum points
  const int DD = d * d;   // output points
  float* fvr = smem;      // Finv (d x d)
  float* fvi = fvr + DD;
  float* wr = fvi + DD;   // W (d x dh)
  float* wi = wr + R;
  float* sgn = wi + R;    // kScatter only, as src
  int* src = reinterpret_cast<int*>(sgn + (kScatter ? R : 0));
  float* scratch = reinterpret_cast<float*>(src + (kScatter ? R : 0));

  for (int e = threadIdx.x; e < DD; e += blockDim.x) {
    fvr[e] = fvr_g[e];
    fvi[e] = fvi_g[e];
  }
  for (int e = threadIdx.x; e < R; e += blockDim.x) {
    wr[e] = wr_g[e];
    wi[e] = wi_g[e];
    if (kScatter) {
      sgn[e] = sgn_g[e];
      src[e] = src_g[e];
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* ar = scratch + warp * 4 * R;  // rect Z, real / imag
  float* ai = ar + R;
  float* yr = ai + R;                  // Y = Finv @ Z, real / imag
  float* yi = yr + R;

  for (long long t = (long long)blockIdx.x * kWarps + warp; t < n;
       t += (long long)gridDim.x * kWarps) {
    const float* zr_t = zr + t * ld;
    const float* zi_t = zi + t * ld;
    for (int r = lane; r < R; r += 32) {
      if (kScatter) {
        const int s = src[r];
        ar[r] = zr_t[s];
        ai[r] = zi_t[s] * sgn[r];
      } else {
        ar[r] = zr_t[r];
        ai[r] = zi_t[r];
      }
    }
    __syncwarp();
    for (int e = lane; e < R; e += 32) {
      const int h = e / dh;
      const int v = e - h * dh;
      float sr = 0.f, si = 0.f;
      for (int u = 0; u < d; ++u) {
        const float fr = fvr[h * d + u], fi = fvi[h * d + u];
        const float zre = ar[u * dh + v], zim = ai[u * dh + v];
        sr = fmaf(fr, zre, sr);
        sr = fmaf(-fi, zim, sr);
        si = fmaf(fr, zim, si);
        si = fmaf(fi, zre, si);
      }
      yr[e] = sr;
      yi[e] = si;
    }
    __syncwarp();
    float b = 0.f;
    if (kTail) b = bias[t];
    float* y_t = y + t * DD;
    for (int e = lane; e < DD; e += 32) {
      const int h = e / d;
      const int w = e - h * d;
      float s = 0.f;
      for (int v = 0; v < dh; ++v) {
        s = fmaf(yr[h * dh + v], wr[w * dh + v], s);
        s = fmaf(-yi[h * dh + v], wi[w * dh + v], s);
      }
      y_t[e] = kTail ? activate(s + b, act) : s;
    }
    __syncwarp();  // the next tile overwrites this warp's buffers
  }
}

int multiprocessors() {
  static int cache[kMaxDevices] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return 0;
  if (cache[dev] == 0)
    cudaDeviceGetAttribute(&cache[dev], cudaDevAttrMultiProcessorCount, dev);
  return cache[dev];
}

// Blocks for n tiles: one warp per tile up to the resident limit (8 blocks
// of 256 threads fill an SM's 2,048 threads); past it the warps loop.
long long grid_for(long long n) {
  const int sms = multiprocessors();
  if (sms <= 0) return 0;
  long long blocks = (n + kWarps - 1) / kWarps;
  const long long cap = (long long)sms * 8;
  return blocks > cap ? cap : blocks;
}

template <bool kGather>
int launch_rfwd(const void* x, void* tr, void* ti, const void* fr,
                const void* fi, const void* fhr, const void* fhi,
                const void* store, long long n, int P, int delta,
                void* stream) {
  const int dh = delta / 2 + 1;
  if (delta < 1 || delta > kMaxDelta || n <= 0 || P <= 0 || P > delta * dh)
    return (int)cudaErrorInvalidValue;
  cudaGetLastError();  // start from a clean error state
  const int R = delta * dh;
  const int DS = delta * (delta + 1);  // a padded d x d matrix
  const size_t smem = sizeof(float) * (2 * DS + 2 * dh * (delta + 1) +
                                       kWarps * (DS + 2 * R)) +
                      sizeof(int) * (kGather ? P : 0);
  cudaError_t err = cudaFuncSetAttribute(
      rfwd_kernel<kGather>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = grid_for(n);
  if (blocks <= 0) return (int)cudaGetLastError();
  rfwd_kernel<kGather><<<(unsigned)blocks, kWarps * 32, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(tr),
      static_cast<float*>(ti), static_cast<const float*>(fr),
      static_cast<const float*>(fi), static_cast<const float*>(fhr),
      static_cast<const float*>(fhi), static_cast<const int*>(store), n, P,
      delta);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

// Forms of the forward kernel, the code ops.choose_form passes.
constexpr int kFormGeneric = 0;
constexpr int kFormSpecialised = 1;     // rfwd16_kernel: delta 16, aligned

template <bool kGather>
int launch_rfwd16(const void* x, void* tr, void* ti, const void* tables,
                  long long n, int P, cudaStream_t stream) {
  if (P != (kGather ? 130 : kD16 * kDh16) || tables == nullptr)
    return (int)cudaErrorInvalidValue;
  // the 16-byte row loads and the vector stores need aligned planes
  if (!aligned16(x) || !aligned16(tr) || !aligned16(ti))
    return (int)cudaErrorMisalignedAddress;
  // one block per 8 tiles: a block that looped over tiles would keep the
  // table in registers across its loop (250 of them, 2 blocks an SM)
  const long long blocks = (n + kTiles16 - 1) / kTiles16;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaGetLastError();  // start from a clean error state
  Tables16 tab;
  memcpy(&tab, tables, sizeof tab);
  rfwd16_kernel<kGather><<<(unsigned)blocks, kThreads16, 0, stream>>>(
      static_cast<const float*>(x), static_cast<float*>(tr),
      static_cast<float*>(ti), tab, n);
  return (int)cudaGetLastError();
}

// The forward tile DFT in form ``form``: the specialised form (delta 16
// only, 16-byte aligned planes, F_half from the host table ``tables``,
// 2 x 9 x 16 floats) or the generic one (any delta <= 32, tables in device
// memory); a form that cannot run these operands is refused.
template <bool kGather>
int launch_forward(const void* x, void* tr, void* ti, const void* fr,
                   const void* fi, const void* fhr, const void* fhi,
                   const void* store, long long n, int P, int delta,
                   int form, const void* tables, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  if (form == kFormSpecialised) {
    if (delta != kD16) return (int)cudaErrorInvalidValue;
    return launch_rfwd16<kGather>(x, tr, ti, tables, n, P,
                                  static_cast<cudaStream_t>(stream));
  }
  if (form != kFormGeneric) return (int)cudaErrorInvalidValue;
  return launch_rfwd<kGather>(x, tr, ti, fr, fi, fhr, fhi, store, n, P,
                              delta, stream);
}

template <bool kTail, bool kScatter>
int launch_rinv(const void* zr, const void* zi, const void* bias, void* y,
                const void* fvr, const void* fvi, const void* wr,
                const void* wi, const void* src, const void* sgn, long long n,
                int ld, int delta, int act, void* stream) {
  const int dh = delta / 2 + 1;
  if (delta < 1 || delta > kMaxDelta || n <= 0 || ld <= 0 || act < 0 ||
      act > 3)
    return (int)cudaErrorInvalidValue;
  cudaGetLastError();  // start from a clean error state
  const int R = delta * dh;
  const int tables = kScatter ? R : 0;  // src and sgn
  const size_t smem =
      sizeof(float) * (2 * delta * delta + 2 * R + tables + kWarps * 4 * R) +
      sizeof(int) * tables;
  cudaError_t err = cudaFuncSetAttribute(
      rinv_kernel<kTail, kScatter>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = grid_for(n);
  if (blocks <= 0) return (int)cudaGetLastError();
  rinv_kernel<kTail, kScatter><<<(unsigned)blocks, kWarps * 32, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(zr), static_cast<const float*>(zi),
      static_cast<const float*>(bias), static_cast<float*>(y),
      static_cast<const float*>(fvr), static_cast<const float*>(fvi),
      static_cast<const float*>(wr), static_cast<const float*>(wi),
      static_cast<const int*>(src), static_cast<const float*>(sgn), n, ld,
      delta, act);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tile_rfft_f32(const void* x, void* tr, void* ti,
                             const void* fr, const void* fi, const void* fhr,
                             const void* fhi, const void* store, long long n,
                             int P, int delta, int form, const void* tables,
                             void* stream) {
  return launch_forward<true>(x, tr, ti, fr, fi, fhr, fhi, store, n, P, delta,
                              form, tables, stream);
}

extern "C" int tile_irfft_f32(const void* zr, const void* zi, void* y,
                              const void* fvr, const void* fvi,
                              const void* wr, const void* wi, const void* src,
                              const void* sgn, long long n, int ld, int delta,
                              void* stream) {
  return launch_rinv<false, true>(zr, zi, nullptr, y, fvr, fvi, wr, wi, src,
                                  sgn, n, ld, delta, 0, stream);
}

extern "C" int tile_irfft_epilogue_f32(const void* zr, const void* zi,
                                       const void* bias, void* y,
                                       const void* fvr, const void* fvi,
                                       const void* wr, const void* wi,
                                       const void* src, const void* sgn,
                                       long long n, int ld, int delta,
                                       int act, void* stream) {
  return launch_rinv<true, true>(zr, zi, bias, y, fvr, fvi, wr, wi, src, sgn,
                                 n, ld, delta, act, stream);
}

extern "C" int tile_fft_f32(const void* x, void* tr, void* ti, const void* fr,
                            const void* fi, const void* fhr, const void* fhi,
                            long long n, int delta, int form,
                            const void* tables, void* stream) {
  return launch_forward<false>(x, tr, ti, fr, fi, fhr, fhi, nullptr, n,
                               delta * (delta / 2 + 1), delta, form, tables,
                               stream);
}

extern "C" int tile_ifft_f32(const void* zr, const void* zi, void* y,
                             const void* fvr, const void* fvi, const void* wr,
                             const void* wi, long long n, int delta,
                             void* stream) {
  return launch_rinv<false, false>(zr, zi, nullptr, y, fvr, fvi, wr, wi,
                                   nullptr, nullptr, n,
                                   delta * (delta / 2 + 1), delta, 0, stream);
}

extern "C" int tile_ifft_epilogue_f32(const void* zr, const void* zi,
                                      const void* bias, void* y,
                                      const void* fvr, const void* fvi,
                                      const void* wr, const void* wi,
                                      long long n, int delta, int act,
                                      void* stream) {
  return launch_rinv<true, false>(zr, zi, bias, y, fvr, fvi, wr, wi, nullptr,
                                  nullptr, n, delta * (delta / 2 + 1), delta,
                                  act, stream);
}

extern "C" const char* dft_tile_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
