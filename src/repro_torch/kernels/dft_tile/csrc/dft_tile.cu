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
// real-by-complex products instead of delta^3.  One template, the gather
// compiled in or out (kGather), so the two forms cannot drift apart.
//
// Replaces: src/repro/kernels/dft_tile/kernel.py:_rfwd_kernel (compact,
// wrapped there by dft_tile/ops.py:tile_rfft_pallas) and :_fwd_kernel
// (rect, wrapped by tile_fft_pallas), Pallas on a TPU.
//
// Bound on an H100.  Per 16x16 tile the compact form reads 1,024 B and
// writes 2 x 130 floats (1,040 B); the rect form writes 2 x 144 floats
// (1,152 B).  The Pallas kernels' order (F @ x, then the rect product) costs
// about 35 kFLOP a tile; this one's (the w axis first) about 26 kFLOP
// compact and 27.6 kFLOP rect, 12.5-12.7 per byte.  Both are under the
// card's float32 ridge of 20 (67 TFLOP/s / 3.35 TB/s), so the kernel is
// bound by bytes: stage 1 of a served VGG forward at 224x224, batch 4
// (156,672 tiles, 323 MB compact, 341 MB rect) is bounded by 0.10 ms.
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
// Design, all six.  The Pallas kernels' gain is that the intermediate
// product never reaches device memory (nor, compact, the rect spectrum);
// the same holds here.  A block loads the DFT matrices and the layout table
// into shared memory once, then each of its warps walks over tiles
// (grid-stride): the warp reads its tile (or gathers its compact row
// through src/sgn) straight from device memory into a per-warp shared
// buffer, forms the intermediate there, and writes the result once,
// coalesced.  Warps of a block never wait on one another after the tables
// are loaded.  The forward kernel pads its matrix rows in shared memory so
// that a warp's column reads hit distinct banks.
#include <cuda_runtime.h>

#include <math.h>

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
                             int P, int delta, void* stream) {
  return launch_rfwd<true>(x, tr, ti, fr, fi, fhr, fhi, store, n, P, delta,
                           stream);
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
                            long long n, int delta, void* stream) {
  return launch_rfwd<false>(x, tr, ti, fr, fi, fhr, fhi, nullptr, n,
                            delta * (delta / 2 + 1), delta, stream);
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
