// Kernel K8 `hpel_plane`: the (1/2, 1/2)-phase 8-tap interpolation of a
// reference plane on the integer grid, (v + 2048) >> 12 without clipping,
// read at clamped coordinates (edge padding).  The P tree prices sub-pel
// merge candidates from SSD grids over this plane.
//
// Replaces, from the JAX package: models/inter_tree.py _hpel_plane.
//
// Entry point (plain C, caller's stream, returns cudaGetLastError()):
//   hpel_plane(ref [H,W] i32, H, W, out [H,W] i32)
//
// What bounds it on an H100: bytes (one int32 read and one written per
// sample; the 64 taps per sample come from L1).  One thread per output
// sample; both filter stages in int32 (|v| < 2^22).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__constant__ int kHalf[8] = {-1, 4, -11, 40, 40, -11, 4, -1};

__global__ void hpel_kernel(const int32_t* __restrict__ ref, int H, int W,
                            int32_t* __restrict__ out) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)H * W) return;
  const int i = (int)(idx / W), j = (int)(idx % W);
  int cols[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int x = j + k - 3;
    cols[k] = x < 0 ? 0 : (x > W - 1 ? W - 1 : x);
  }
  int v = 0;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    int y = i + r - 3;
    y = y < 0 ? 0 : (y > H - 1 ? H - 1 : y);
    const int32_t* row = ref + (size_t)y * W;
    int h = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) h += kHalf[k] * row[cols[k]];
    v += kHalf[r] * h;
  }
  out[idx] = (v + 2048) >> 12;
}

}  // namespace

extern "C" int hpel_plane(const int32_t* ref, int H, int W, int32_t* out,
                          cudaStream_t stream) {
  const int64_t total = (int64_t)H * W;
  const int threads = 256;
  hpel_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0,
                stream>>>(ref, H, W, out);
  return (int)cudaGetLastError();
}
