// Tile DFTs for Hopper (sm_90a): stages 1, 2 and 4 of FFT convolution, on
// the compact spectrum="real" layout and on the rect rfft2 grid.  Seven entry
// points:
//
//   tile_rfft_f32             forward tile DFT + compact gather (stages 1, 2)
//   tile_rfft_image_f32       stage 1 in one pass: the tiles read from the
//                             NCHW image, the compact spectra written as
//                             the CGEMM's (P, M, C) planes
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
// The specialised kernel has a third instantiation, the image form
// (rfwd16_kernel<true, true>, entry tile_rfft_image_f32): stage 1 of a
// conv without the tile copy before it or the permute after it.  It reads
// each tile straight from the (B, C, H, W) input, any strides, zeros past
// the image's edges (the overlap-save padding), and writes tile t = (m, c)
// of the conv's M x C tiles to column t of the (P_real, M*C) planes, the
// (P, M, C) layout the CGEMM reads.  The arithmetic is the specialised
// form's, operation for operation: its spectra equal the composed path's
// (pad, tile copy, tile_rfft_f32, permute) bit for bit.
//
// Replaces: src/repro/kernels/dft_tile/kernel.py:_rfwd_kernel (compact,
// wrapped there by dft_tile/ops.py:tile_rfft_pallas) and :_fwd_kernel
// (rect, wrapped by tile_fft_pallas), Pallas on a TPU.
//
// Bound on an H100.  Per 16x16 tile the compact form reads 1,024 B and
// writes 2 x 130 floats (1,040 B); the rect form writes 2 x 144 floats
// (1,152 B); the image form reads the image once (t_h x t_w of a tile's
// 256 points are its own, the overlap its neighbours', from L2) and writes
// 1,040 B a tile.  The specialised form does about 8.2k FMAs a tile (16 kFLOP,
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
// code.  Each form is one template, the tail (kTail) and the scatter
// (kScatter) compiled in or out.
//
// Two kernel forms, the code ops.choose_inverse_form passes (kForm*), each
// compiled at 4, 8 and 16 tiles a block (the ``tiles`` argument of the
// entry points, ops.INVERSE_TILES; 8 by default): the port's form of the
// reference's ``bt``, the tiles of one grid step of the inverse:
//   specialised (rinv16_kernel): delta 16, the tile of every plan path, on
//     16-byte-aligned planes and output with an even row stride ld.
//     Columns, then rows, in registers; the tables (Finv and W, rows 0-8)
//     by value in the launch's parameters; the compact scatter compiled in
//     (no src/sgn); shared memory only for the block's spectrum rows and one
//     transpose.  Its design is set out above the kernel.
//   generic (rinv_kernel): every delta <= 32, odd included, and planes off
//     16 bytes; one warp a tile, as many warps a block as tiles.  The
//     launcher refuses a form, or a number of tiles, it cannot run: no
//     silent fallback.
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
// The specialised form does about 6.1k FMAs a tile (12 kFLOP, 6 per byte),
// well under the ridge.  The generic form issues about 600 shared-memory
// warp instructions a tile (its tables, Z and Y), which bound it near
// 0.6-0.65 ms there instead.
//
// Design, the generic forms.  The Pallas kernels' gain is that the
// intermediate product never reaches device memory (nor, compact, the rect
// spectrum); the same holds here, in every form.  A block loads the DFT
// matrices and the layout table
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

constexpr int kWarps = 8;        // warps a block, generic forward form
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
//
// The image form (kImage) changes only the load and the store; stages 1
// and 2 are the lines above, so its spectra are the other forms' bit for
// bit.
//  Load: the tiles' rows lie anywhere in the image and off 16 bytes (t_w is
//    14 or 12), so the block loads them together: thread (q, 0) finds tile
//    t0 + q = (m, c), m = (b, xi, dl), its origin, row xi*t_h - pad_h and
//    column dl*t_w - pad_w, and that point's offset; then in 16 steps of
//    half a tile the block loads the 8 tiles, a thread a point, 16 lanes a
//    row (runs of 64 B along w), every load issued before the first store
//    to shared; a point off the image reads 0.0f (what the pad gave the
//    tile copy).  The points go to the rows of sb that stage 1 then reads
//    in 16-byte loads, and each thread's B row overwrites its own tile row.
//  Store: tile t of the conv is column t of each (P, M*C) plane, so for
//    each point p the block's 8 tiles are one run of 32 B at p*M*C + t0; a
//    warp stores 4 points' runs, reading sor/soi across tiles.
// One barrier a block more than the other forms (the tile origins).  At
// 16 tiles a block (64-byte runs) stage 1 of the Table-I sweep at batch 64
// took 2.83 ms against 2.80 at 8 on an H100: it does not pay.
constexpr int kD16 = 16;
constexpr int kDh16 = kD16 / 2 + 1;
constexpr int kTiles16 = 8;                       // tiles per block,
                                                  // forward form
constexpr int kThreads16 = kTiles16 * kD16;       // one thread per row
constexpr int kRow16 = 20;     // floats per B row in shared (16 + 4: the
                               // 16-byte stores of 8 rows hit 8 bank quads)
constexpr int kTile16 = kD16 * kRow16 + 16;  // 336 = 16 mod 32: two tiles'
                                             // column reads miss each other

struct Tables16 {              // F_half = F[0:9], row-major, float32
  float re[kDh16][kD16];
  float im[kDh16][kD16];
};

// Where the image form finds its tiles: the input's strides (in floats)
// and extents, the tile grid, the tile steps (valid outputs a tile) and
// the padding.  Unread by the other instantiations.
struct Image16 {
  long long sb, sc, sh, sw;
  int C, H, W;
  int X, Dl;
  int th, tw;
  int ph, pw;
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

template <bool kGather, bool kImage = false>
__global__ void __launch_bounds__(kThreads16)
    rfwd16_kernel(const float* __restrict__ x, float* __restrict__ tr,
                  float* __restrict__ ti,
                  const __grid_constant__ Tables16 tab, long long n,
                  const __grid_constant__ Image16 img) {
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
  if constexpr (kImage) {
    // each tile's origin (row, column) in the image and the offset of its
    // point (0, 0) from x; a tile past n lies below the image
    __shared__ long long org[kTiles16];
    __shared__ int2 rc0[kTiles16];
    if (h == 0) {
      const long long t = t0 + q1;
      int r0 = img.H, c0 = 0;
      long long off = 0;
      if (t < n) {
        const long long m = t / img.C;
        const long long bx = m / img.Dl;
        const long long b = bx / img.X;
        r0 = (int)(bx - b * img.X) * img.th - img.ph;
        c0 = (int)(m - bx * img.Dl) * img.tw - img.pw;
        off = b * img.sb + (t - m * img.C) * img.sc + r0 * img.sh +
              c0 * img.sw;
      }
      org[q1] = off;
      rc0[q1] = make_int2(r0, c0);
    }
    __syncthreads();
    // kSteps steps of kRows rows of one tile, a thread a point, 16 lanes a
    // row; every load is issued before the first store to sb
    constexpr int kRows = kThreads16 / kD16;
    constexpr int kSteps = kTiles16 * kD16 / kRows;
    const int w = threadIdx.x % kD16, r = threadIdx.x / kD16;
    const long long o = r * img.sh + w * img.sw;
    float v[kSteps];
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
      const int q = st * kRows / kD16, h0 = st * kRows % kD16;
      const int2 p0 = rc0[q];
      const bool in = (unsigned)(p0.x + h0 + r) < (unsigned)img.H &&
                      (unsigned)(p0.y + w) < (unsigned)img.W;
      v[st] = in ? __ldg(x + org[q] + h0 * img.sh + o) : 0.f;
    }
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
      const int q = st * kRows / kD16, h0 = st * kRows % kD16;
      sb[q * kTile16 + (h0 + r) * kRow16 + w] = v[st];
    }
    __syncthreads();
    const float4* row =
        reinterpret_cast<const float4*>(sb + q1 * kTile16 + h * kRow16);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float4 v = row[k];
      xr[4 * k] = v.x;
      xr[4 * k + 1] = v.y;
      xr[4 * k + 2] = v.z;
      xr[4 * k + 3] = v.w;
    }
  } else if (t0 + q1 < n) {
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

  if constexpr (kImage) {
    // tile t is column t of the (P, n) planes: the block's tiles are one
    // run a point, 16 points a step
    const int q = threadIdx.x % kTiles16;
    if (t0 + q < n)
      for (int p = threadIdx.x / kTiles16; p < P;
           p += kThreads16 / kTiles16) {
        tr[p * n + t0 + q] = sor[q * P + p];
        ti[p * n + t0 + q] = soi[q * P + p];
      }
    return;
  }
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

template <int kInvWarps, bool kTail, bool kScatter>
__global__ void __launch_bounds__(kInvWarps * 32)
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

  for (long long t = (long long)blockIdx.x * kInvWarps + warp; t < n;
       t += (long long)gridDim.x * kInvWarps) {
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

// ---- the inverse tile DFT at delta = 16 ("specialised" form) -------------
// The forward form run backwards.  A block of 16 threads a tile takes
// kTiles tiles (4, 8 or 16; 128 threads at the default 8), one block per
// kTiles tiles (no loop over tiles, so ptxas keeps no table in registers
// across one).  Every stage below works on 4-tile groups, so kTiles is a
// multiple of 4; at 16 tiles the static shared memory is 40 KB, under the
// 48 KB a kernel may hold without the dynamic opt-in.
//  Load: the block copies its kTiles spectrum rows, both planes, into shared
//    memory with vector loads: 16-byte in the rect form (144 floats a row),
//    8-byte in the compact form (a row of 130 floats starts only 8 bytes
//    aligned), each row to its own padded slot (kZCompact16, kZRect16), so
//    that the column reads below miss each other's banks.  Rows of stride
//    ld: points past 130 (compact) are never read.
//  Stage A, by columns: thread (tile, c) reads column c of Z into
//    registers and forms Y[h] = sum_u Finv[h][u] Z[u].  Finv[16-h] =
//    conj(Finv[h]), so the four sums over u of (Re Finv, Im Finv) x (Re z,
//    Im z) give Y[h] and Y[16-h] at once: 9 units (h = 0, 8 and the pairs
//    (h, 16-h), h = 1..7).  The two warps of a 4-tile group split them (h =
//    0, 8 and pairs 1-3; pairs 4-7: 256 FMAs a thread each), so h is
//    warp-uniform and every table operand is at a compile-time offset of a
//    __grid_constant__ parameter, read from the constant bank: no table read
//    touches shared memory.  Stage B reads only the real parts of columns 0
//    and 8 (W's imaginary column 0 is 0, column 8 at most 3.4e-16), so one
//    thread takes both: it holds column 0 as (a, b) and column 8 as (c, d)
//    = (Re, -Im), and the same four sums, each over its own operands, are
//    Re Y[:,0] (s1 -+ s2) and Re Y[:,8] (s3 +- s4).  Every other thread
//    holds its column as (a, b) = (Re, Im) and (c, d) = (Im, Re).  In the
//    compact form the conj-mirror scatter is compile-time: rows 9-15 of
//    columns 0 and 8 read row 16-u with the imaginary part negated
//    (compact16 gives the index of every stored point); no src/sgn table.
//  Transpose: Y goes to shared memory as 8 complex "columns" a row (column
//    0 packs Re Y[:,0] and Re Y[:,8]), rows padded as in the forward form.
//  Stage B, by rows: thread (tile, h) reads row h of Y (four 16-byte loads)
//    and forms y[h][w] = sum_v Wr[w][v] Yr[h][v] - Wi[w][v] Yi[h][v].
//    W[16-w] = conj(W[w]), so the same two sums give y[h][w] and
//    y[h][16-w]; the tail (bias, activation) follows in registers.
//  Store: each thread puts its row in the spectrum buffer, dead since
//    stage A (its four 16-byte chunks swizzled by row so that 8 rows miss
//    each other's banks); the block's kTiles tiles are contiguous in y
//    (1 KB a tile), and it writes them in 16-byte stores, a warp's 512
//    bytes contiguous.
//    (Storing each row from its own thread puts a warp's 16-byte stores 64
//    bytes apart, half a sector each, and measured slower on the card.)
// About 6.1k FMAs a tile (4.1k in stage A, 2.1k in stage B), 3 barriers a
// block; per tile about 50 shared-memory warp instructions.
constexpr int kZCompact16 = 136;   // shared floats a compact row (130 used;
                                   // 136 = 8 mod 32: the 4 tiles of a warp's
                                   // column reads fall on 4 bank octets)
constexpr int kZRect16 = 152;      // a rect row (144 used; 152 = 24 mod 32)

struct InvTables16 {           // row-major, float32
  float fr[kDh16][kD16];       // Finv rows 0-8
  float fi[kDh16][kD16];
  float wr[kDh16][kDh16];      // W rows 0-8
  float wi[kDh16][kDh16];
};

template <int V>
struct VecOf;
template <>
struct VecOf<2> {
  using type = float2;
};
template <>
struct VecOf<4> {
  using type = float4;
};

// One unit of stage A: Y[H] and, for 1 <= H <= 7, Y[16 - H], into the
// tile's transpose buffer at column pair c.
template <int H>
__device__ __forceinline__ void iunit16(const InvTables16& tab,
                                        const float (&a)[kD16],
                                        const float (&b)[kD16],
                                        const float (&c)[kD16],
                                        const float (&d)[kD16], float* ys,
                                        int col) {
  // Finv[H] real for H = 0 (exactly) and H = 8 (imaginary parts at most
  // 3.4e-16 in dft_mats), and 16 - H = H there
  constexpr bool kSingle = H == 0 || H == 8;
  float s1 = 0.f, s2 = 0.f, s3 = 0.f, s4 = 0.f;
#pragma unroll
  for (int u = 0; u < kD16; ++u) {
    const float fr = tab.fr[H][u];
    s1 = fmaf(fr, a[u], s1);
    s3 = fmaf(fr, c[u], s3);
    if constexpr (!kSingle) {
      const float fi = tab.fi[H][u];
      s2 = fmaf(fi, b[u], s2);
      s4 = fmaf(fi, d[u], s4);
    }
  }
  float2* row = reinterpret_cast<float2*>(ys + H * kRow16) + col;
  if constexpr (kSingle) {
    *row = make_float2(s1, s3);
  } else {
    *row = make_float2(s1 - s2, s3 + s4);
    reinterpret_cast<float2*>(ys + (kD16 - H) * kRow16)[col] =
        make_float2(s1 + s2, s3 - s4);
  }
}

template <int kTiles, bool kTail, bool kScatter>
__global__ void __launch_bounds__(kTiles * kD16)
    rinv16_kernel(const float* __restrict__ zr, const float* __restrict__ zi,
                  const float* __restrict__ bias, float* __restrict__ y,
                  const __grid_constant__ InvTables16 tab, long long n,
                  int ld, int act) {
  static_assert(kTiles % 4 == 0, "stage A works on 4-tile groups");
  constexpr int kThreads = kTiles * kD16;        // one thread per row
  constexpr int P = kScatter ? 130 : kD16 * kDh16;
  constexpr int V = kScatter ? 2 : 4;            // floats per vector load
  constexpr int S = kScatter ? kZCompact16 : kZRect16;
  constexpr int kVecs = P / V;                   // vectors a row
  constexpr int kIters = (kTiles * kVecs + kThreads - 1) / kThreads;
  using Vec = typename VecOf<V>::type;
  // the spectrum rows, real then imaginary; then the output tiles
  // (2 * kTiles * S >= kTiles * 256 floats)
  __shared__ __align__(16) float sz[2 * kTiles * S];
  __shared__ __align__(16) float sy[kTiles * kTile16];
  float* szr = sz;
  float* szi = sz + kTiles * S;

  const long long t0 = (long long)blockIdx.x * kTiles;
  const long long left = n - t0;
  const int tiles = left < kTiles ? (int)left : kTiles;

  // load: every vector of the block's rows in flight before the first store
  Vec lr[kIters], li[kIters];
#pragma unroll
  for (int j = 0; j < kIters; ++j) {
    const int e = threadIdx.x + j * kThreads;
    if (e < tiles * kVecs) {
      const int q = e / kVecs;
      const long long off = (t0 + q) * ld + (e - q * kVecs) * V;
      lr[j] = __ldg(reinterpret_cast<const Vec*>(zr + off));
      li[j] = __ldg(reinterpret_cast<const Vec*>(zi + off));
    }
  }
#pragma unroll
  for (int j = 0; j < kIters; ++j) {
    const int e = threadIdx.x + j * kThreads;
    if (e < tiles * kVecs) {
      const int q = e / kVecs;
      const int off = q * S + (e - q * kVecs) * V;
      *reinterpret_cast<Vec*>(szr + off) = lr[j];
      *reinterpret_cast<Vec*>(szi + off) = li[j];
    }
  }
  __syncthreads();

  // stage A: column c of tile q2, the warp's half of the units
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int half = warp & 1;
  const int q2 = (warp >> 1) * 4 + lane / 8, c = lane % 8;
  float a[kD16], b[kD16], cc[kD16], dd[kD16];
  {
    const float* re = szr + q2 * S;
    const float* im = szi + q2 * S;
    // (cc, dd): column 8 as (Re, -Im) for c = 0, else column c as (Im, Re)
    const float* pc = c == 0 ? re : im;
    const float* pd = c == 0 ? im : re;
    const float sd = c == 0 ? -1.f : 1.f;
    const int c8 = c == 0 ? 8 : c;
#pragma unroll
    for (int u = 0; u < kD16; ++u) {
      if (!kScatter || u <= 8) {
        a[u] = re[u * kDh16 + c];
        b[u] = im[u * kDh16 + c];
        cc[u] = pc[u * kDh16 + c8];
        dd[u] = sd * pd[u * kDh16 + c8];
      } else {
        // compact rows 9-15 store columns 1-7; columns 0 and 8 there are
        // the conjugates of row 16 - u
        const int m = (kD16 - u) * kDh16;
        const int p = compact16(u, c == 0 ? 1 : c);
        const int pa = c == 0 ? m : p;
        const int pcd = c == 0 ? m + 8 : p;
        a[u] = re[pa];
        b[u] = (c == 0 ? -1.f : 1.f) * im[pa];
        cc[u] = pc[pcd];
        dd[u] = pd[pcd];   // c = 0: -Im Z[u][8] = +Im Z[16-u][8]
      }
    }
  }
  float* ys = sy + q2 * kTile16;
  if (half == 0) {
    iunit16<0>(tab, a, b, cc, dd, ys, c);
    iunit16<8>(tab, a, b, cc, dd, ys, c);
    iunit16<1>(tab, a, b, cc, dd, ys, c);
    iunit16<2>(tab, a, b, cc, dd, ys, c);
    iunit16<3>(tab, a, b, cc, dd, ys, c);
  } else {
    iunit16<4>(tab, a, b, cc, dd, ys, c);
    iunit16<5>(tab, a, b, cc, dd, ys, c);
    iunit16<6>(tab, a, b, cc, dd, ys, c);
    iunit16<7>(tab, a, b, cc, dd, ys, c);
  }
  __syncthreads();

  // stage B: row h of tile q1; yv = Re Y[h][0], Re Y[h][8], then (Re, Im)
  // of Y[h][1..7]
  const int q1 = threadIdx.x / kD16, h = threadIdx.x % kD16;
  float yv[kD16];
  const float4* yrow =
      reinterpret_cast<const float4*>(sy + q1 * kTile16 + h * kRow16);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float4 v = yrow[k];
    yv[4 * k] = v.x;
    yv[4 * k + 1] = v.y;
    yv[4 * k + 2] = v.z;
    yv[4 * k + 3] = v.w;
  }
  float out[kD16];
#pragma unroll
  for (int w = 0; w < kDh16; ++w) {
    float p1 = tab.wr[w][0] * yv[0];
    p1 = fmaf(tab.wr[w][8], yv[1], p1);
#pragma unroll
    for (int v = 1; v < 8; ++v) p1 = fmaf(tab.wr[w][v], yv[2 * v], p1);
    if (w == 0 || w == 8) {    // W[0] real, Im W[8] at most 1.1e-16
      out[w] = p1;
    } else {
      float p2 = 0.f;
#pragma unroll
      for (int v = 1; v < 8; ++v) p2 = fmaf(tab.wi[w][v], yv[2 * v + 1], p2);
      out[w] = p1 - p2;
      out[kD16 - w] = p1 + p2;
    }
  }
  if (kTail) {   // a tile past n has no bias; its row is never stored
    const float bt = q1 < tiles ? bias[t0 + q1] : 0.f;
#pragma unroll
    for (int w = 0; w < kD16; ++w) out[w] = activate(out[w] + bt, act);
  }
  // store: row r = q1 * 16 + h at float4 slots 4r..4r+3, chunk k in slot
  // k ^ ((r >> 1) & 3)
  float4* so = reinterpret_cast<float4*>(sz) + (q1 * kD16 + h) * 4;
  const int sw = (h >> 1) & 3;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    so[k ^ sw] = make_float4(out[4 * k], out[4 * k + 1], out[4 * k + 2],
                             out[4 * k + 3]);
  __syncthreads();
  const int vecs = tiles * kD16 * 4;          // float4s of the block's tiles
  float4* dst = reinterpret_cast<float4*>(y + t0 * (kD16 * kD16));
  const float4* src = reinterpret_cast<const float4*>(sz);
  for (int e = threadIdx.x; e < vecs; e += kThreads)
    dst[e] = src[(e & ~3) | ((e & 3) ^ ((e >> 3) & 3))];
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

// Blocks of ``warps`` warps for n tiles: one warp per tile up to the
// resident limit (64 warps fill an SM's 2,048 threads: 8 blocks of 8
// warps); past it the warps loop.
long long grid_for(long long n, int warps = kWarps) {
  const int sms = multiprocessors();
  if (sms <= 0) return 0;
  long long blocks = (n + warps - 1) / warps;
  const long long cap = (long long)sms * (64 / warps);
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

// Forms of the tile DFT kernels, the codes ops.choose_form and
// ops.choose_inverse_form pass.
constexpr int kFormGeneric = 0;
constexpr int kFormSpecialised = 1;     // rfwd16_kernel / rinv16_kernel

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
      static_cast<float*>(ti), tab, n, Image16{});
  return (int)cudaGetLastError();
}

// Stage 1 in the image form: the B x C x H x W input at x (strides in
// floats) -> the (P_real, M*C) planes tr, ti, M = B * X * Dl tiles of
// steps th x tw from padding (ph, pw); F_half from the host table.
int launch_rfwd16_image(const void* x, void* tr, void* ti, int B,
                        const Image16& img, const void* tables,
                        cudaStream_t stream) {
  if (tables == nullptr || B <= 0 || img.C <= 0 || img.H <= 0 ||
      img.W <= 0 || img.X <= 0 || img.Dl <= 0 || img.th <= 0 ||
      img.tw <= 0 || img.ph < 0 || img.pw < 0)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * img.X * img.Dl * img.C;
  // one block per 8 tiles, as the specialised form: no loop
  const long long blocks = (n + kTiles16 - 1) / kTiles16;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaGetLastError();  // start from a clean error state
  Tables16 tab;
  memcpy(&tab, tables, sizeof tab);
  rfwd16_kernel<true, true><<<(unsigned)blocks, kThreads16, 0, stream>>>(
      static_cast<const float*>(x), static_cast<float*>(tr),
      static_cast<float*>(ti), tab, n, img);
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

template <int kInvWarps, bool kTail, bool kScatter>
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
  const size_t smem = sizeof(float) * (2 * delta * delta + 2 * R + tables +
                                       kInvWarps * 4 * R) +
                      sizeof(int) * tables;
  cudaError_t err = cudaFuncSetAttribute(
      rinv_kernel<kInvWarps, kTail, kScatter>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = grid_for(n, kInvWarps);
  if (blocks <= 0) return (int)cudaGetLastError();
  rinv_kernel<kInvWarps, kTail, kScatter>
      <<<(unsigned)blocks, kInvWarps * 32, smem,
         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(zr), static_cast<const float*>(zi),
      static_cast<const float*>(bias), static_cast<float*>(y),
      static_cast<const float*>(fvr), static_cast<const float*>(fvi),
      static_cast<const float*>(wr), static_cast<const float*>(wi),
      static_cast<const int*>(src), static_cast<const float*>(sgn), n, ld,
      delta, act);
  return (int)cudaGetLastError();
}

template <int kTiles, bool kTail, bool kScatter>
int launch_rinv16(const void* zr, const void* zi, const void* bias, void* y,
                  const void* tables, long long n, int ld, int act,
                  cudaStream_t stream) {
  constexpr int P = kScatter ? 130 : kD16 * kDh16;
  if (tables == nullptr || ld < P || act < 0 || act > 3 ||
      (kTail && bias == nullptr))
    return (int)cudaErrorInvalidValue;
  // the vector loads of the rows (8-byte compact, 16-byte rect: the rect
  // row stride is always 144) and the 16-byte output stores need aligned
  // planes and output and a row stride of whole vectors
  if (!aligned16(zr) || !aligned16(zi) || !aligned16(y) ||
      ld % (kScatter ? 2 : 4) != 0)
    return (int)cudaErrorMisalignedAddress;
  // one block per kTiles tiles, no loop (as the forward form)
  const long long blocks = (n + kTiles - 1) / kTiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaGetLastError();  // start from a clean error state
  InvTables16 tab;
  memcpy(&tab, tables, sizeof tab);
  rinv16_kernel<kTiles, kTail, kScatter>
      <<<(unsigned)blocks, kTiles * kD16, 0, stream>>>(
      static_cast<const float*>(zr), static_cast<const float*>(zi),
      static_cast<const float*>(bias), static_cast<float*>(y), tab, n, ld,
      act);
  return (int)cudaGetLastError();
}

// The inverse in form ``form`` at ``kTiles`` tiles a block.
template <int kTiles, bool kTail, bool kScatter>
int launch_inverse_at(const void* zr, const void* zi, const void* bias,
                      void* y, const void* fvr, const void* fvi,
                      const void* wr, const void* wi, const void* src,
                      const void* sgn, long long n, int ld, int delta,
                      int act, int form, const void* tables, void* stream) {
  if (form == kFormSpecialised) {
    if (delta != kD16) return (int)cudaErrorInvalidValue;
    return launch_rinv16<kTiles, kTail, kScatter>(
        zr, zi, bias, y, tables, n, ld, act,
        static_cast<cudaStream_t>(stream));
  }
  if (form != kFormGeneric) return (int)cudaErrorInvalidValue;
  return launch_rinv<kTiles, kTail, kScatter>(zr, zi, bias, y, fvr, fvi, wr,
                                              wi, src, sgn, n, ld, delta, act,
                                              stream);
}

// The inverse tile DFT in form ``form`` with ``tiles`` tiles a block (4, 8
// or 16: tiles a block of the specialised form, warps a block of the
// generic one, which runs a tile a warp): the specialised form (delta 16
// only, aligned planes and output, Finv and W rows 0-8 from the host table
// ``tables``, 2 x 9 x 16 + 2 x 9 x 9 floats) or the generic one (any delta
// <= 32, tables in device memory); a form that cannot run these operands,
// or a number of tiles not compiled, is refused.
template <bool kTail, bool kScatter>
int launch_inverse(const void* zr, const void* zi, const void* bias, void* y,
                   const void* fvr, const void* fvi, const void* wr,
                   const void* wi, const void* src, const void* sgn,
                   long long n, int ld, int delta, int act, int form,
                   int tiles, const void* tables, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  switch (tiles) {
    case 4:
      return launch_inverse_at<4, kTail, kScatter>(
          zr, zi, bias, y, fvr, fvi, wr, wi, src, sgn, n, ld, delta, act,
          form, tables, stream);
    case 8:
      return launch_inverse_at<8, kTail, kScatter>(
          zr, zi, bias, y, fvr, fvi, wr, wi, src, sgn, n, ld, delta, act,
          form, tables, stream);
    case 16:
      return launch_inverse_at<16, kTail, kScatter>(
          zr, zi, bias, y, fvr, fvi, wr, wi, src, sgn, n, ld, delta, act,
          form, tables, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
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

extern "C" int tile_rfft_image_f32(const void* x, void* tr, void* ti,
                                   long long sb, long long sc, long long sh,
                                   long long sw, int B, int C, int H, int W,
                                   int X, int Dl, int th, int tw, int ph,
                                   int pw, const void* tables, void* stream) {
  const Image16 img{sb, sc, sh, sw, C, H, W, X, Dl, th, tw, ph, pw};
  return launch_rfwd16_image(x, tr, ti, B, img, tables,
                             static_cast<cudaStream_t>(stream));
}

extern "C" int tile_irfft_f32(const void* zr, const void* zi, void* y,
                              const void* fvr, const void* fvi,
                              const void* wr, const void* wi, const void* src,
                              const void* sgn, long long n, int ld, int delta,
                              int form, int tiles, const void* tables,
                              void* stream) {
  return launch_inverse<false, true>(zr, zi, nullptr, y, fvr, fvi, wr, wi,
                                     src, sgn, n, ld, delta, 0, form, tiles,
                                     tables, stream);
}

extern "C" int tile_irfft_epilogue_f32(const void* zr, const void* zi,
                                       const void* bias, void* y,
                                       const void* fvr, const void* fvi,
                                       const void* wr, const void* wi,
                                       const void* src, const void* sgn,
                                       long long n, int ld, int delta,
                                       int act, int form, int tiles,
                                       const void* tables, void* stream) {
  return launch_inverse<true, true>(zr, zi, bias, y, fvr, fvi, wr, wi, src,
                                    sgn, n, ld, delta, act, form, tiles,
                                    tables, stream);
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
                             const void* wi, long long n, int delta, int form,
                             int tiles, const void* tables, void* stream) {
  return launch_inverse<false, false>(zr, zi, nullptr, y, fvr, fvi, wr, wi,
                                      nullptr, nullptr, n,
                                      delta * (delta / 2 + 1), delta, 0, form,
                                      tiles, tables, stream);
}

extern "C" int tile_ifft_epilogue_f32(const void* zr, const void* zi,
                                      const void* bias, void* y,
                                      const void* fvr, const void* fvi,
                                      const void* wr, const void* wi,
                                      long long n, int delta, int act,
                                      int form, int tiles,
                                      const void* tables, void* stream) {
  return launch_inverse<true, false>(zr, zi, bias, y, fvr, fvi, wr, wi,
                                     nullptr, nullptr, n,
                                     delta * (delta / 2 + 1), delta, act,
                                     form, tiles, tables, stream);
}

extern "C" const char* dft_tile_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
