// Kernel K7 `mc_qpel`: uni-directional motion compensation of every n x n
// raster block of a plane at its own MV: quarter-pel luma (8-tap) or
// eighth-pel chroma (4-tap), 14-bit intermediate, (p + 32) >> 6, clip.
//
// Replaces, from the JAX package: ops/me.py mc_luma_qpel / mc_luma_qpel14
// and mc_chroma_qpel / mc_chroma_qpel14 (uni path), with the one-hot window
// fetch _block_windows they use.
//
// Entry point (plain C, caller's stream, returns cudaGetLastError()):
//   mc_qpel(plane [H,W] i32, H, W, mv [nb,2] i32, nb, n, chroma,
//           out [nb,n,n] i32)
// mv is in luma quarter-pel units; for chroma the same value is the
// eighth-pel chroma MV (4:2:0).
//
// What bounds it on an H100: bytes at these sizes (one int32 in, one out per
// pixel; the T x T taps hit L1).  One thread per output pixel reads its
// T x T reference neighbourhood at clamped coordinates (edge padding, what
// the JAX window fetch gives for every MV the encoder produces) and applies
// the two filter stages in int32.  Phase 0 of each table is a single 64
// tap, so the same two stages give the full-pel and half-way cases exactly.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__constant__ int kLuma[4][8] = {{0, 0, 0, 64, 0, 0, 0, 0},
                                {-1, 4, -10, 58, 17, -5, 1, 0},
                                {-1, 4, -11, 40, 40, -11, 4, -1},
                                {0, 1, -5, 17, 58, -10, 4, -1}};
__constant__ int kChroma[8][4] = {{0, 64, 0, 0},     {-2, 58, 10, -2},
                                  {-4, 54, 16, -2},  {-6, 46, 28, -4},
                                  {-4, 36, 36, -4},  {-4, 28, 46, -6},
                                  {-2, 16, 54, -4},  {-2, 10, 58, -2}};

template <int T>
__global__ void mc_kernel(const int32_t* __restrict__ plane, int H, int W,
                          const int32_t* __restrict__ mv, int nb, int n,
                          int32_t* __restrict__ out) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int nn = n * n;
  if (idx >= (int64_t)nb * nn) return;
  const int b = (int)(idx / nn), p = (int)(idx % nn);
  const int i = p / n, j = p % n;
  const int wb = W / n;
  const int sh = T == 8 ? 2 : 3;
  const int margin = T == 8 ? 3 : 1;
  const int vx = mv[2 * b], vy = mv[2 * b + 1];
  const int fx = vx & ((1 << sh) - 1), fy = vy & ((1 << sh) - 1);
  const int* tx;
  const int* ty;
  if constexpr (T == 8) {
    tx = kLuma[fx];
    ty = kLuma[fy];
  } else {
    tx = kChroma[fx];
    ty = kChroma[fy];
  }
  const int x0 = (b % wb) * n + (vx >> sh) - margin + j;
  const int y0 = (b / wb) * n + (vy >> sh) - margin + i;
  int cols[T];
#pragma unroll
  for (int k = 0; k < T; ++k) {
    const int x = x0 + k;
    cols[k] = x < 0 ? 0 : (x > W - 1 ? W - 1 : x);
  }
  int v = 0;
#pragma unroll
  for (int r = 0; r < T; ++r) {
    int y = y0 + r;
    y = y < 0 ? 0 : (y > H - 1 ? H - 1 : y);
    const int32_t* row = plane + (size_t)y * W;
    int h = 0;
#pragma unroll
    for (int k = 0; k < T; ++k) h += tx[k] * row[cols[k]];
    v += ty[r] * h;
  }
  int pred = ((v >> 6) + 32) >> 6;
  out[idx] = pred < 0 ? 0 : (pred > 255 ? 255 : pred);
}

}  // namespace

extern "C" int mc_qpel(const int32_t* plane, int H, int W, const int32_t* mv,
                       int nb, int n, int chroma, int32_t* out,
                       cudaStream_t stream) {
  if (n != 8 && n != 16 && n != 32) return (int)cudaErrorInvalidValue;
  const int64_t total = (int64_t)nb * n * n;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  if (chroma)
    mc_kernel<4><<<blocks, threads, 0, stream>>>(plane, H, W, mv, nb, n, out);
  else
    mc_kernel<8><<<blocks, threads, 0, stream>>>(plane, H, W, mv, nb, n, out);
  return (int)cudaGetLastError();
}
