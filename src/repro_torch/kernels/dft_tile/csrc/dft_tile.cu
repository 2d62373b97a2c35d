// Fused compact-spectrum inverse tile DFT + conv epilogue for Hopper
// (sm_90a): stage 4 of the fft-cuda backend on the spectrum="real" layout.
//
// For every tile t of n, with delta <= 32 and dh = delta/2 + 1:
//   1. conj-mirror scatter of the compact Hermitian list into the rect
//      rfft2 grid:  Z[u][v] = (Zr[t][src[r]], sgn[r] * Zi[t][src[r]]),
//      r = u*dh + v (Zr/Zi rows have ld >= P_real points; trailing points
//      past P_real are never read),
//   2. Y = Finv @ Z                     (delta x delta times delta x dh),
//   3. y = Re(Y @ W^T)                  (delta x dh times dh x delta),
//   4. y = act(y + bias[t]), act in {none, relu, tanh-gelu, silu},
// written as y[t] (delta x delta, float32).
//
// Replaces: src/repro/kernels/dft_tile/kernel.py:_rinv_epilogue_kernel
// (Pallas, TPU).
//
// Bound on an H100.  Per 16x16 tile the kernel reads 2 x 130 floats plus a
// bias and writes 256 floats (2.1 kB) for about 28 kFLOP of small complex
// products: 13 FLOP per byte against the card's 20 (67 TFLOP/s float32 /
// 3.35 TB/s), so it sits near the ridge and is bound by memory traffic
// (65,536 tiles = 135 MB at Vconv1.2, batch 4: 40 us).
//
// Design.  The Pallas kernel's gain is that the rect spectrum and the Y
// intermediate never reach device memory; the same holds here.  A block
// loads the DFT matrices and the src/sgn tables into shared memory once,
// then each of its warps walks over tiles (grid-stride): the warp gathers
// its tile's compact row through src/sgn straight from device memory into
// a per-warp shared buffer, forms Y there, and writes y once, coalesced,
// with the bias and activation applied in registers.  Warps of a block
// never wait on one another after the tables are loaded.
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

__global__ void __launch_bounds__(kWarps * 32)
    rinv_epilogue_kernel(const float* __restrict__ zr,
                         const float* __restrict__ zi,
                         const float* __restrict__ bias,
                         float* __restrict__ y,
                         const float* __restrict__ fvr_g,
                         const float* __restrict__ fvi_g,
                         const float* __restrict__ wr_g,
                         const float* __restrict__ wi_g,
                         const int* __restrict__ src_g,
                         const float* __restrict__ sgn_g, long long n, int ld,
                         int d, int act) {
  extern __shared__ float smem[];
  const int dh = d / 2 + 1;
  const int R = d * dh;   // rect spectrum points
  const int DD = d * d;   // output points
  float* fvr = smem;      // Finv (d x d)
  float* fvi = fvr + DD;
  float* wr = fvi + DD;   // W (d x dh)
  float* wi = wr + R;
  float* sgn = wi + R;
  int* src = reinterpret_cast<int*>(sgn + R);
  float* scratch = reinterpret_cast<float*>(src + R);

  for (int e = threadIdx.x; e < DD; e += blockDim.x) {
    fvr[e] = fvr_g[e];
    fvi[e] = fvi_g[e];
  }
  for (int e = threadIdx.x; e < R; e += blockDim.x) {
    wr[e] = wr_g[e];
    wi[e] = wi_g[e];
    sgn[e] = sgn_g[e];
    src[e] = src_g[e];
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
      const int s = src[r];
      ar[r] = zr_t[s];
      ai[r] = zi_t[s] * sgn[r];
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
    const float b = bias[t];
    float* y_t = y + t * DD;
    for (int e = lane; e < DD; e += 32) {
      const int h = e / d;
      const int w = e - h * d;
      float s = 0.f;
      for (int v = 0; v < dh; ++v) {
        s = fmaf(yr[h * dh + v], wr[w * dh + v], s);
        s = fmaf(-yi[h * dh + v], wi[w * dh + v], s);
      }
      y_t[e] = activate(s + b, act);
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

}  // namespace

extern "C" int tile_irfft_epilogue_f32(const void* zr, const void* zi,
                                       const void* bias, void* y,
                                       const void* fvr, const void* fvi,
                                       const void* wr, const void* wi,
                                       const void* src, const void* sgn,
                                       long long n, int ld, int delta,
                                       int act, void* stream) {
  const int dh = delta / 2 + 1;
  if (delta < 1 || delta > kMaxDelta || n <= 0 || ld <= 0 || act < 0 ||
      act > 3)
    return (int)cudaErrorInvalidValue;
  cudaGetLastError();  // start from a clean error state
  const int R = delta * dh;
  const size_t smem =
      sizeof(float) * (2 * delta * delta + 3 * R + kWarps * 4 * R) +
      sizeof(int) * R;
  cudaError_t err = cudaFuncSetAttribute(
      rinv_epilogue_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int sms = multiprocessors();
  if (sms <= 0) return (int)cudaGetLastError();
  long long blocks = (n + kWarps - 1) / kWarps;
  const long long cap = (long long)sms * 8;  // resident blocks at delta=16
  if (blocks > cap) blocks = cap;
  rinv_epilogue_kernel<<<(unsigned)blocks, kWarps * 32, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(zr), static_cast<const float*>(zi),
      static_cast<const float*>(bias), static_cast<float*>(y),
      static_cast<const float*>(fvr), static_cast<const float*>(fvi),
      static_cast<const float*>(wr), static_cast<const float*>(wi),
      static_cast<const int*>(src), static_cast<const float*>(sgn), n, ld,
      delta, act);
  return (int)cudaGetLastError();
}

extern "C" const char* dft_tile_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
