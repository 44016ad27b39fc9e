// Kernel K22 `frame_metrics`: the three planes' SSE and the luma SSIM of a
// batch of F frames in one launch, out [F, 4] f32 (SSE y, cb, cr, SSIM y),
// the layout of the trees' `sse` rows.
//
// Replaces, from the JAX package: ops/metrics.py ssim_plane (:24) and the
// plane SSEs of each encoder's tail (models/intra_frame.py :291-296,
// models/intra_tree.py, models/inter_tree.py).
//
// SSE is exact: integer sums, 64-bit across blocks, converted to f32 once
// (round to nearest), as the plain version does.  SSIM takes the JAX
// window (8x8, non-overlapping, C1 = (0.01 * 255)^2, C2 = (0.03 * 255)^2):
// a window's sums are exact integers, its means exact in f32, and its SSIM
// the plain version's f32 operations in order (built with --fmad=false);
// the mean over the windows is summed in f64, in another order than the
// plain version's f32 mean, so the frame's SSIM agrees to about 1e-7, not
// bit for bit.  Without SSIM (Main10), column 3 is 0.
//
// Design: a thread block per (frame, row of 8 luma rows), 256 threads, a
// thread a window; the block also sums the 4 matching rows of each chroma
// plane.  Each block writes its partial sums; the frame's last block to
// finish (an atomic counter per frame, which that block resets to 0) adds
// them in row order and writes the frame's row, so the result does not
// depend on the blocks' order.
//
// What bounds it on an H100: bytes (each sample of the six int32 planes
// read once).
//
// Entry point (plain C, caller's stream, returns cudaGetLastError()):
//   frame_metrics(src_y, src_cb, src_cr, rec_y, rec_cb, rec_cr  (int32),
//                 F, H, W, ssim, partial [F, H/8, 4] f64, counters [F] i32
//                 (zero), out [F, 4] f32, stream)

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ long long warp_sum(long long v) {
  for (int o = 16; o; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ float window_ssim(int sx, int sy, int sxx, int syy, int sxy) {
  const float c1 = 6.5025f, c2 = 58.5225f;
  const float mx = __fdiv_rn((float)sx, 64.0f);
  const float my = __fdiv_rn((float)sy, 64.0f);
  const float vx = __fsub_rn(__fdiv_rn((float)sxx, 64.0f), __fmul_rn(mx, mx));
  const float vy = __fsub_rn(__fdiv_rn((float)syy, 64.0f), __fmul_rn(my, my));
  const float cov =
      __fsub_rn(__fdiv_rn((float)sxy, 64.0f), __fmul_rn(mx, my));
  const float num =
      __fmul_rn(__fadd_rn(__fmul_rn(__fmul_rn(2.0f, mx), my), c1),
                __fadd_rn(__fmul_rn(2.0f, cov), c2));
  const float den = __fmul_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(mx, mx), __fmul_rn(my, my)), c1),
      __fadd_rn(__fadd_rn(vx, vy), c2));
  return __fdiv_rn(num, den);
}

__global__ void __launch_bounds__(kThreads)
    metrics_kernel(const int32_t* __restrict__ sy, const int32_t* __restrict__ scb,
                   const int32_t* __restrict__ scr, const int32_t* __restrict__ ry,
                   const int32_t* __restrict__ rcb,
                   const int32_t* __restrict__ rcr, int H, int W, int ssim,
                   double* __restrict__ partial, int* __restrict__ counters,
                   float* __restrict__ out) {
  __shared__ long long sh_sse[3][kThreads / 32];
  __shared__ double sh_ssim[kThreads / 32];
  __shared__ bool last;
  const int fi = blockIdx.y, row = blockIdx.x, nrows = gridDim.x;
  const int Wc = W / 2, Hc = H / 2;
  const size_t yoff = (size_t)fi * H * W, coff = (size_t)fi * Hc * Wc;
  long long sse_y = 0, sse_cb = 0, sse_cr = 0;
  double ss = 0.0;
  for (int wx = threadIdx.x; wx < W / 8; wx += kThreads) {
    int sx = 0, sy_ = 0, sxx = 0, syy = 0, sxy = 0;
    for (int y = 0; y < 8; ++y) {
      const size_t o = yoff + (size_t)(row * 8 + y) * W + wx * 8;
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        const int a = sy[o + x], b = ry[o + x];
        sx += a;
        sy_ += b;
        sxx += a * a;
        syy += b * b;
        sxy += a * b;
        sse_y += (long long)(a - b) * (a - b);
      }
    }
    if (ssim) ss += (double)window_ssim(sx, sy_, sxx, syy, sxy);
  }
  for (int i = threadIdx.x; i < 4 * Wc; i += kThreads) {
    const size_t o = coff + (size_t)(row * 4 + i / Wc) * Wc + i % Wc;
    const long long d1 = scb[o] - rcb[o], d2 = scr[o] - rcr[o];
    sse_cb += d1 * d1;
    sse_cr += d2 * d2;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  sse_y = warp_sum(sse_y);
  sse_cb = warp_sum(sse_cb);
  sse_cr = warp_sum(sse_cr);
  ss = warp_sum(ss);
  if (lane == 0) {
    sh_sse[0][warp] = sse_y;
    sh_sse[1][warp] = sse_cb;
    sh_sse[2][warp] = sse_cr;
    sh_ssim[warp] = ss;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    long long t[3] = {0, 0, 0};
    double s = 0.0;
    for (int w = 0; w < kThreads / 32; ++w) {
      for (int k = 0; k < 3; ++k) t[k] += sh_sse[k][w];
      s += sh_ssim[w];
    }
    double* p = partial + ((size_t)fi * nrows + row) * 4;
    for (int k = 0; k < 3; ++k) p[k] = (double)t[k];   // < 2^53: exact
    p[3] = s;
    __threadfence();
    last = atomicAdd(&counters[fi], 1) == nrows - 1;
  }
  __syncthreads();
  if (!last || threadIdx.x != 0) return;
  __threadfence();
  long long t[3] = {0, 0, 0};
  double s = 0.0;
  const volatile double* p = partial + (size_t)fi * nrows * 4;
  for (int r = 0; r < nrows; ++r) {
    for (int k = 0; k < 3; ++k) t[k] += (long long)p[r * 4 + k];
    s += p[r * 4 + 3];
  }
  for (int k = 0; k < 3; ++k) out[fi * 4 + k] = __ll2float_rn(t[k]);
  out[fi * 4 + 3] =
      ssim ? (float)(s / (double)((H / 8) * (W / 8))) : 0.0f;
  counters[fi] = 0;
}

}  // namespace

extern "C" int frame_metrics(const int32_t* sy, const int32_t* scb,
                             const int32_t* scr, const int32_t* ry,
                             const int32_t* rcb, const int32_t* rcr, int F,
                             int H, int W, int ssim, double* partial,
                             int* counters, float* out, cudaStream_t stream) {
  if (F < 1 || H < 8 || W < 16 || H % 8 || W % 16)
    return (int)cudaErrorInvalidValue;
  metrics_kernel<<<dim3(H / 8, F), kThreads, 0, stream>>>(
      sy, scb, scr, ry, rcb, rcr, H, W, ssim, partial, counters, out);
  return (int)cudaGetLastError();
}
