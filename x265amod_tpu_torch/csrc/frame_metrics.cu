// Kernel K22 `frame_metrics`: the three planes' SSE and the luma SSIM of a
// batch of F frames in one launch, out [F, 4] f32 (SSE y, cb, cr, SSIM y),
// the layout of the trees' `sse` rows.
//
// Replaces, from the JAX package: ops/metrics.py ssim_plane (:24) and the
// plane SSEs of each encoder's tail (models/intra_frame.py :291-296,
// models/intra_tree.py, models/inter_tree.py).
//
// SSE is exact: integer sums, 64-bit across warps, converted to f32 once
// (round to nearest), as the plain version does.  SSIM takes the JAX
// window (8x8, non-overlapping, C1 = (0.01 * 255)^2, C2 = (0.03 * 255)^2):
// a window's five moments are exact int32 sums, its means exact in f32
// (integers below 2^24 over 64), and its SSIM the plain version's f32
// operations in its order (`window_ssim`, built with --fmad=false), so
// each window's value is the plain version's bit for bit.  The mean over
// the windows is an exact sum of their values in fixed point (below), in
// another order than the plain version's f32 mean, so the frame's SSIM
// agrees to about 1e-7, not bit for bit.  Without SSIM (Main10), column 3
// is 0.
//
// What bounds it on an H100: bytes (each sample of the six int32 planes
// read once: 25 MB, 7.5 us, at one 1920x1088 frame).
//
// Design.  A warp is one unit of work: a band of 8 luma rows times a strip
// of 64 columns (8 windows), with the 4 x 32 chroma samples under it.  A
// lane reads 4 adjacent samples (16 bytes) of one row from each plane:
// lanes 0-15 cover rows 0, 2, 4, 6 of the band, lanes 16-31 rows 1, 3, 5,
// 7, two lanes a window row, so each warp load is two 256-byte runs; a
// lane keeps its 16 samples' moments in int32 and a window's four lanes
// (l, l ^ 1, l ^ 16, l ^ 17) add theirs with two shuffles.  Chroma: lane l
// reads row l / 8 of the band's 4 chroma rows, columns 4 (l % 8) of the
// strip's 32, no division a sample.  A lane issues its 12 16-byte loads
// before it uses any, so a warp waits on memory once.  A strip past the
// plane's last column (W not a multiple of 64) masks its lanes there: W is
// a multiple of 16, so a window is whole or absent.  A CTA is 4 warps of
// one frame, so 1920x1088 is 1020 CTAs, 1280x736 460 and 16 x 640x384
// 1920: several CTAs of 4 warps on every SM.
//
// Reduction, deterministic because every sum is of integers: a window's
// f32 SSIM becomes a fixed-point int64 (x 2^40, rounded to nearest even:
// exact but below 2^-17 in magnitude); the SSEs are int64.  A warp adds
// its lanes', its CTA its 4 warps', and the CTA adds its four sums to the
// frame's accumulators (`partial`, [F, 4] 64-bit, zero) with atomics;
// integer addition gives the same bits in any order.  The frame's last
// CTA (a per-frame counter, each CTA's adds fenced before its count)
// takes the sums, leaves zeros and a zero count for the next launch, and
// writes the frame's row: SSIM = sum / 2^40 / windows in f64, then f32.
//
// Entry point (plain C, caller's stream, returns cudaGetLastError()):
//   frame_metrics(src_y, src_cb, src_cr, rec_y, rec_cb, rec_cr  (int32,
//                 16-byte aligned), F, H, W, ssim,
//                 partial [F, 4] 64-bit accumulators (zero),
//                 counters [F] i32 (zero), out [F, 4] f32, stream)

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStrip = 64;           // luma columns a warp covers
// a window's SSIM in fixed point: x 2^40 (|SSIM| <= 1, at most 2^15
// windows a 1088p frame: every sum far inside int64)
constexpr float kSsimScale = 1099511627776.0f;

__device__ __forceinline__ long long warp_sum(long long v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int pair_sum(int v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

// The plain version's f32 operations in its order, one rounding each; the
// means are the sums over 64, taken as products by 1/64 (exact either way:
// a power of two, integers below 2^24).
__device__ float window_ssim(int sx, int sy, int sxx, int syy, int sxy) {
  const float c1 = 6.5025f, c2 = 58.5225f, inv = 0.015625f;
  const float mx = __fmul_rn((float)sx, inv);
  const float my = __fmul_rn((float)sy, inv);
  const float vx = __fsub_rn(__fmul_rn((float)sxx, inv), __fmul_rn(mx, mx));
  const float vy = __fsub_rn(__fmul_rn((float)syy, inv), __fmul_rn(my, my));
  const float cov =
      __fsub_rn(__fmul_rn((float)sxy, inv), __fmul_rn(mx, my));
  const float num =
      __fmul_rn(__fadd_rn(__fmul_rn(__fmul_rn(2.0f, mx), my), c1),
                __fadd_rn(__fmul_rn(2.0f, cov), c2));
  const float den = __fmul_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(mx, mx), __fmul_rn(my, my)), c1),
      __fadd_rn(__fadd_rn(vx, vy), c2));
  return __fdiv_rn(num, den);
}

__device__ __forceinline__ int4 ld4(const int32_t* p) {
  return __ldg(reinterpret_cast<const int4*>(p));
}

__device__ __forceinline__ int sq_diff4(int4 a, int4 b) {
  const int d0 = a.x - b.x, d1 = a.y - b.y, d2 = a.z - b.z, d3 = a.w - b.w;
  return d0 * d0 + d1 * d1 + d2 * d2 + d3 * d3;
}

template <bool kSsim>
__global__ void __launch_bounds__(kThreads)
    metrics_kernel(const int32_t* __restrict__ sy, const int32_t* __restrict__ scb,
                   const int32_t* __restrict__ scr, const int32_t* __restrict__ ry,
                   const int32_t* __restrict__ rcb,
                   const int32_t* __restrict__ rcr, int H, int W,
                   unsigned long long* __restrict__ acc,
                   int* __restrict__ counters, float* __restrict__ out) {
  __shared__ long long sh[4][kWarps];
  const int fi = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int strips = (W + kStrip - 1) / kStrip;
  const int unit = blockIdx.x * kWarps + warp;
  const int Wc = W / 2, Hc = H / 2;
  int sse_y = 0, sse_cb = 0, sse_cr = 0;
  long long ss = 0;
  if (unit < (H / 8) * strips) {     // warp-uniform
    const int band = unit / strips, strip = unit - band * strips;
    // luma: lane (rp, g) reads columns 4g..4g+3 of rows rp, rp+2, rp+4, rp+6
    const int g = lane & 15, rp = lane >> 4;
    const int col = strip * kStrip + 4 * g;
    // chroma: lane l reads row l / 8 of the band's 4, columns 4 (l % 8)
    const int ccol = strip * (kStrip / 2) + 4 * (lane & 7);
    // every load of the lane is issued before any use: one trip to memory
    int4 a[4], b[4], p, q, r, s;
    if (col < W) {
      const size_t o = ((size_t)fi * H + band * 8 + rp) * W + col;
#pragma unroll
      for (int it = 0; it < 4; ++it) {
        a[it] = ld4(sy + o + (size_t)(2 * it) * W);
        b[it] = ld4(ry + o + (size_t)(2 * it) * W);
      }
    }
    if (ccol < Wc) {
      const size_t o = ((size_t)fi * Hc + band * 4 + (lane >> 3)) * Wc + ccol;
      p = ld4(scb + o);
      q = ld4(rcb + o);
      r = ld4(scr + o);
      s = ld4(rcr + o);
    }
    int mx = 0, my = 0, mxx = 0, myy = 0, mxy = 0;
    if (col < W) {
#pragma unroll
      for (int it = 0; it < 4; ++it) {
        sse_y += sq_diff4(a[it], b[it]);
        if (kSsim) {
          const int x[4] = {a[it].x, a[it].y, a[it].z, a[it].w};
          const int y[4] = {b[it].x, b[it].y, b[it].z, b[it].w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            mx += x[k];
            my += y[k];
            mxx += x[k] * x[k];
            myy += y[k] * y[k];
            mxy += x[k] * y[k];
          }
        }
      }
    }
    if (ccol < Wc) {
      sse_cb = sq_diff4(p, q);
      sse_cr = sq_diff4(r, s);
    }
    if (kSsim) {
      mx = pair_sum(mx);
      my = pair_sum(my);
      mxx = pair_sum(mxx);
      myy = pair_sum(myy);
      mxy = pair_sum(mxy);
      // one lane a window: the even lanes of the first half; its f32 value
      // in fixed point (x 2^40, round to nearest even: exact but below
      // 2^-17 in magnitude), so every later sum is an exact integer
      if (col < W && (lane & 17) == 0)
        ss = __float2ll_rn(__fmul_rn(window_ssim(mx, my, mxx, myy, mxy),
                                     kSsimScale));
    }
  }
  const long long w[4] = {warp_sum((long long)sse_y),
                          warp_sum((long long)sse_cb),
                          warp_sum((long long)sse_cr),
                          kSsim ? warp_sum(ss) : 0};
  if (lane == 0)
    for (int k = 0; k < 4; ++k) sh[k][warp] = w[k];
  __syncthreads();
  if (threadIdx.x != 0) return;
  unsigned long long* fa = acc + (size_t)fi * 4;
  for (int k = 0; k < 4; ++k) {
    long long t = 0;
    for (int v = 0; v < kWarps; ++v) t += sh[k][v];
    atomicAdd(fa + k, (unsigned long long)t);   // two's complement
  }
  __threadfence();
  if (atomicAdd(&counters[fi], 1) != gridDim.x - 1) return;
  // the frame's last CTA: every CTA's sums are in (each fenced its adds
  // before its count); read them and leave zeros for the next launch
  __threadfence();
  long long t[4];
  for (int k = 0; k < 4; ++k) t[k] = (long long)atomicExch(fa + k, 0ull);
  for (int k = 0; k < 3; ++k) out[fi * 4 + k] = __ll2float_rn(t[k]);
  out[fi * 4 + 3] =
      kSsim ? (float)((double)t[3] / (double)kSsimScale /
                      (double)((H / 8) * (W / 8)))
            : 0.0f;
  counters[fi] = 0;
}

int ctas_of(int H, int W) {
  const int units = (H / 8) * ((W + kStrip - 1) / kStrip);
  return (units + kWarps - 1) / kWarps;
}

}  // namespace

extern "C" int frame_metrics(const int32_t* sy, const int32_t* scb,
                             const int32_t* scr, const int32_t* ry,
                             const int32_t* rcb, const int32_t* rcr, int F,
                             int H, int W, int ssim, double* partial,
                             int* counters, float* out, cudaStream_t stream) {
  unsigned long long* acc = reinterpret_cast<unsigned long long*>(partial);
  if (F < 1 || F > 65535 || H < 8 || W < 16 || H % 8 || W % 16)
    return (int)cudaErrorInvalidValue;
  const int32_t* planes[6] = {sy, scb, scr, ry, rcb, rcr};
  for (const int32_t* p : planes)
    if (reinterpret_cast<uintptr_t>(p) % 16)
      return (int)cudaErrorMisalignedAddress;
  const dim3 grid(ctas_of(H, W), F);
  if (ssim)
    metrics_kernel<true><<<grid, kThreads, 0, stream>>>(
        sy, scb, scr, ry, rcb, rcr, H, W, acc, counters, out);
  else
    metrics_kernel<false><<<grid, kThreads, 0, stream>>>(
        sy, scb, scr, ry, rcb, rcr, H, W, acc, counters, out);
  return (int)cudaGetLastError();
}
