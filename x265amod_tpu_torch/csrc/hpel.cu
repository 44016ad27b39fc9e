// Kernel K8 `hpel_plane`: the (1/2, 1/2)-phase 8-tap interpolation of a
// reference plane on the integer grid, (v + 2048) >> 12 without clipping,
// read at clamped coordinates (edge padding).  The P and B trees price
// sub-pel merge candidates from SSD grids over this plane.
//
// Replaces, from the JAX package: models/inter_tree.py _hpel_plane.
//
// Entry point (plain C, caller's stream, returns cudaGetLastError()):
//   hpel_plane(ref [H,W] i32, H, W, out [H,W] i32, stream)
//
// What bounds it on an H100: bytes (one int32 read and one written per
// sample: 16.7 MB, 5.0 us, at 1920x1088).
//
// Design: a CTA of 128 threads an output tile of 64 x 32.  It stages the
// tile's input window, rows y0-3..y0+35 and columns x0-4..x0+67 (39 x 72,
// one column more on the left than the taps need so that each row starts
// on 16 bytes), in shared memory once: 16-byte loads where the window lies
// inside the plane's columns (W a multiple of 4, both planes 16-byte
// aligned), else one clamped sample at a time; rows are clamped either
// way.  The horizontal 8-tap pass runs once per staged row, a thread 4
// adjacent outputs from three 16-byte reads, into a second buffer of 39 x
// 64; the vertical pass runs in registers, a thread a 4 x 4 block of
// outputs: it reads the 11 filtered rows under it once (16 bytes each),
// slides the 8 taps down them and writes 16-byte stores.  The taps are
// symmetric, so a pass is 40 (a3 + a4) - 11 (a2 + a5) + 4 (a1 + a6) - (a0 +
// a7): the same integer sums as the plain version's, in int32 throughout
// (an 8-bit plane's horizontal values lie in [-6120, 22440], its vertical
// sums below 2^22 in magnitude; int32 arithmetic is exact modulo 2^32 in
// any order, so wider inputs agree with the plain int32 version too).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTW = 64;             // output tile width
constexpr int kTH = 32;             // output tile height
constexpr int kThreads = 128;
constexpr int kSW = kTW + 8;        // staged columns x0-4 .. x0+67
constexpr int kSH = kTH + 7;        // staged rows y0-3 .. y0+35

__device__ __forceinline__ int tap8(int a0, int a1, int a2, int a3, int a4,
                                    int a5, int a6, int a7) {
  return 40 * (a3 + a4) - 11 * (a2 + a5) + 4 * (a1 + a6) - (a0 + a7);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void __launch_bounds__(kThreads)
    hpel_kernel(const int32_t* __restrict__ ref, int H, int W, int vec_ok,
                int32_t* __restrict__ out) {
  __shared__ __align__(16) int32_t s_in[kSH][kSW];
  __shared__ __align__(16) int32_t s_h[kSH][kTW];
  const int x0 = blockIdx.x * kTW, y0 = blockIdx.y * kTH;
  const int tid = threadIdx.x;

  // stage the input window
  if (vec_ok && x0 >= 4 && x0 + kTW + 4 <= W) {
    for (int i = tid; i < kSH * (kSW / 4); i += kThreads) {
      const int r = i / (kSW / 4), c4 = i - r * (kSW / 4);
      const int y = clampi(y0 - 3 + r, 0, H - 1);
      *reinterpret_cast<int4*>(&s_in[r][4 * c4]) = __ldg(
          reinterpret_cast<const int4*>(ref + (size_t)y * W + x0 - 4 + 4 * c4));
    }
  } else {
    for (int i = tid; i < kSH * kSW; i += kThreads) {
      const int r = i / kSW, c = i - r * kSW;
      const int y = clampi(y0 - 3 + r, 0, H - 1);
      const int x = clampi(x0 - 4 + c, 0, W - 1);
      s_in[r][c] = __ldg(ref + (size_t)y * W + x);
    }
  }
  __syncthreads();

  // horizontal pass: output column c reads staged columns c+1 .. c+8
  for (int i = tid; i < kSH * (kTW / 4); i += kThreads) {
    const int r = i >> 4, g = i & 15;
    const int4 p = *reinterpret_cast<const int4*>(&s_in[r][4 * g]);
    const int4 q = *reinterpret_cast<const int4*>(&s_in[r][4 * g + 4]);
    const int4 u = *reinterpret_cast<const int4*>(&s_in[r][4 * g + 8]);
    int4 h;
    h.x = tap8(p.y, p.z, p.w, q.x, q.y, q.z, q.w, u.x);
    h.y = tap8(p.z, p.w, q.x, q.y, q.z, q.w, u.x, u.y);
    h.z = tap8(p.w, q.x, q.y, q.z, q.w, u.x, u.y, u.z);
    h.w = tap8(q.x, q.y, q.z, q.w, u.x, u.y, u.z, u.w);
    *reinterpret_cast<int4*>(&s_h[r][4 * g]) = h;
  }
  __syncthreads();

  // vertical pass: output row r reads filtered rows r .. r+7
  const int cg = tid & 15, rg = tid >> 4;
  int4 v[11];
#pragma unroll
  for (int k = 0; k < 11; ++k)
    v[k] = *reinterpret_cast<const int4*>(&s_h[4 * rg + k][4 * cg]);
  const int x = x0 + 4 * cg;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int y = y0 + 4 * rg + j;
    if (y >= H || x >= W) continue;
    int4 o;
    o.x = (tap8(v[j].x, v[j + 1].x, v[j + 2].x, v[j + 3].x, v[j + 4].x,
                v[j + 5].x, v[j + 6].x, v[j + 7].x) + 2048) >> 12;
    o.y = (tap8(v[j].y, v[j + 1].y, v[j + 2].y, v[j + 3].y, v[j + 4].y,
                v[j + 5].y, v[j + 6].y, v[j + 7].y) + 2048) >> 12;
    o.z = (tap8(v[j].z, v[j + 1].z, v[j + 2].z, v[j + 3].z, v[j + 4].z,
                v[j + 5].z, v[j + 6].z, v[j + 7].z) + 2048) >> 12;
    o.w = (tap8(v[j].w, v[j + 1].w, v[j + 2].w, v[j + 3].w, v[j + 4].w,
                v[j + 5].w, v[j + 6].w, v[j + 7].w) + 2048) >> 12;
    int32_t* dst = out + (size_t)y * W + x;
    if (vec_ok) {            // W % 4 == 0: the 4 columns lie in the plane
      *reinterpret_cast<int4*>(dst) = o;
    } else {
      const int ov[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (x + k < W) dst[k] = ov[k];
    }
  }
}

}  // namespace

extern "C" int hpel_plane(const int32_t* ref, int H, int W, int32_t* out,
                          cudaStream_t stream) {
  if (H < 1 || W < 1) return (int)cudaSuccess;
  const int vec_ok = W % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(ref) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH);
  hpel_kernel<<<grid, kThreads, 0, stream>>>(ref, H, W, vec_ok, out);
  return (int)cudaGetLastError();
}
