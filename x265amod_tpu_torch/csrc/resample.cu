// Kernel K16 `resample_plane`: the separable resampler of the ABR ladder, as
// two passes over banded operators.  Row d of an operator has its nonzero
// taps at source first[d] + t, t < n, with weight w[d * n + t] (zero past the
// band; such a tap's source is clamped into the plane).
//   resample_v: mid[i, x] = sum_t wv[i, t] * src[firstv[i] + t, x]   (f32)
//   resample_h: out[i, j] = sum_t wh[j, t] * mid[i, firsth[j] + t]   (f32),
//               then rintf (half to even), a clip to 0..255 and uint8; the
//               unrounded f32 values also go to raw when raw is not null.
// Each sum is one fused multiply-add chain in increasing t, written with
// __fmaf_rn and compiled with --fmad=false, so that its rounding is the
// plain version's (ops/scaler.py:resample_plane_plain) bit for bit.
//
// Replaces, from the JAX package: ops/scaler.py resample_plane (two dense
// f32 matrix products, V @ P @ H^T, then rint and the clip).
//
// Entry points (plain C, caller's stream, return cudaGetLastError()):
//   resample_v(src [H, W] u8, H, W, firstv [h] i32, wv [h, nv] f32, nv,
//              mid [h, W] f32, h)
//   resample_h(mid [h, W] f32, W, firsth [w] i32, wh [w, nh] f32, nh,
//              out [h, w] u8, raw [h, w] f32 or null, h, w)
//
// What bounds it on an H100: bytes (the source read once, the f32
// intermediate written and read once, the output written once; at most 13
// taps per output from L1).  One thread per output sample, consecutive
// threads on consecutive columns, so each tap's loads are coalesced.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void vertical_kernel(const uint8_t* __restrict__ src, int H, int W,
                                const int32_t* __restrict__ first,
                                const float* __restrict__ w, int n,
                                float* __restrict__ mid, int h) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y;
  if (x >= W || i >= h) return;
  const int f = first[i];
  float acc = 0.0f;
  for (int t = 0; t < n; ++t) {
    int y = f + t;
    y = y < H - 1 ? y : H - 1;
    acc = __fmaf_rn(w[(int64_t)i * n + t], (float)src[(int64_t)y * W + x],
                    acc);
  }
  mid[(int64_t)i * W + x] = acc;
}

__global__ void horizontal_kernel(const float* __restrict__ mid, int W,
                                  const int32_t* __restrict__ first,
                                  const float* __restrict__ w, int n,
                                  uint8_t* __restrict__ out,
                                  float* __restrict__ raw, int h, int wd) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y;
  if (j >= wd || i >= h) return;
  const int f = first[j];
  const float* row = mid + (int64_t)i * W;
  float acc = 0.0f;
  for (int t = 0; t < n; ++t) {
    int x = f + t;
    x = x < W - 1 ? x : W - 1;
    acc = __fmaf_rn(w[(int64_t)j * n + t], row[x], acc);
  }
  if (raw != nullptr) raw[(int64_t)i * wd + j] = acc;
  float r = rintf(acc);
  r = r < 0.0f ? 0.0f : (r > 255.0f ? 255.0f : r);
  out[(int64_t)i * wd + j] = (uint8_t)r;
}

}  // namespace

extern "C" int resample_v(const uint8_t* src, int H, int W,
                          const int32_t* first, const float* w, int n,
                          float* mid, int h, cudaStream_t stream) {
  const int threads = 128;
  const dim3 grid((W + threads - 1) / threads, h);
  vertical_kernel<<<grid, threads, 0, stream>>>(src, H, W, first, w, n, mid,
                                                h);
  return (int)cudaGetLastError();
}

extern "C" int resample_h(const float* mid, int W, const int32_t* first,
                          const float* w, int n, uint8_t* out, float* raw,
                          int h, int wd, cudaStream_t stream) {
  const int threads = 128;
  const dim3 grid((wd + threads - 1) / threads, h);
  horizontal_kernel<<<grid, threads, 0, stream>>>(mid, W, first, w, n, out,
                                                  raw, h, wd);
  return (int)cudaGetLastError();
}
