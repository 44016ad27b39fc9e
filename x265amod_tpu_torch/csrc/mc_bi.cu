// Kernel K9 `mc_bi`: bi-prediction of every n x n raster block of a plane:
// two 14-bit predictions (quarter-pel luma 8-tap, or eighth-pel chroma
// 4-tap), one from each reference at its own MV, combined as
// Clip((p0 + p1 + 64) >> 7) (spec 8.5.3.3.4.3, 8-bit).
//
// Replaces, from the JAX package: ops/me.py bi_combine (:323) over
// mc_luma_qpel14 (:262) / mc_chroma_qpel14 (:331) of the two lists, as the
// B tree calls them in its trials (models/inter_tree.py:1274-1279) and in
// mc_select (:1610-1624), with the one-hot window fetch _block_windows
// (:180) those use.
//
// Entry point (plain C, caller's stream, returns cudaGetLastError()):
//   mc_bi(ref0 [H,W] i32, ref1 [H,W] i32, H, W, mv0 [nb,2] i32,
//         mv1 [nb,2] i32, nb, n, chroma, max_mv, out [nb,n,n] i32,
//         excess [] i32, zeroed by the caller)
// MVs are in luma quarter-pel units; for chroma the same value is the
// eighth-pel chroma MV (4:2:0).  `excess` receives how far the largest
// integer MV part lies beyond +-max_mv (the window contract), 0 inside it.
//
// What bounds it on an H100: bytes (two int32 planes read through L1, one
// int32 out per sample).  One block per block of the plane, one thread per
// output sample: each thread filters its T x T neighbourhood in both
// references at clamped coordinates (the edge padding the JAX fetch gives
// inside its window contract, which the kernel measures for the wrapper to
// check) and combines the
// two 14-bit values in registers, so they never reach device memory.  All
// shifts are on signed int32 (arithmetic, as in JAX): the 8-tap lobes make
// 14-bit values negative near dark edges.

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

// 14-bit prediction of the sample at (x, y) of a block from `plane` at MV
// (vx, vy): horizontal taps, then vertical taps and >> 6.
template <int T>
__device__ __forceinline__ int pred14(const int32_t* __restrict__ plane,
                                      int H, int W, int x, int y, int vx,
                                      int vy) {
  const int sh = T == 8 ? 2 : 3;
  const int margin = T == 8 ? 3 : 1;
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
  const int x0 = x + (vx >> sh) - margin;
  const int y0 = y + (vy >> sh) - margin;
  int cols[T];
#pragma unroll
  for (int k = 0; k < T; ++k) {
    const int c = x0 + k;
    cols[k] = c < 0 ? 0 : (c > W - 1 ? W - 1 : c);
  }
  int v = 0;
#pragma unroll
  for (int r = 0; r < T; ++r) {
    int yy = y0 + r;
    yy = yy < 0 ? 0 : (yy > H - 1 ? H - 1 : yy);
    const int32_t* row = plane + (size_t)yy * W;
    int h = 0;
#pragma unroll
    for (int k = 0; k < T; ++k) h += tx[k] * row[cols[k]];
    v += ty[r] * h;
  }
  return v >> 6;
}

template <int T>
__global__ void mc_bi_kernel(const int32_t* __restrict__ ref0,
                             const int32_t* __restrict__ ref1, int H, int W,
                             const int32_t* __restrict__ mv0,
                             const int32_t* __restrict__ mv1, int n,
                             int max_mv, int32_t* __restrict__ out,
                             int32_t* __restrict__ excess) {
  const int b = blockIdx.x;
  const int p = threadIdx.x;
  if (p == 0) {                   // the block's MVs against the contract
    const int sh = T == 8 ? 2 : 3;
    int e = 0;
#pragma unroll
    for (int k = 0; k < 2; ++k)
      e = max(e, max(abs(mv0[2 * b + k] >> sh), abs(mv1[2 * b + k] >> sh)));
    if (e > max_mv) atomicMax(excess, e - max_mv);
  }
  const int i = p / n, j = p % n;
  const int wb = W / n;
  const int x = (b % wb) * n + j, y = (b / wb) * n + i;
  const int a = pred14<T>(ref0, H, W, x, y, mv0[2 * b], mv0[2 * b + 1]);
  const int c = pred14<T>(ref1, H, W, x, y, mv1[2 * b], mv1[2 * b + 1]);
  const int v = (a + c + 64) >> 7;
  out[(size_t)b * n * n + p] = v < 0 ? 0 : (v > 255 ? 255 : v);
}

}  // namespace

extern "C" int mc_bi(const int32_t* ref0, const int32_t* ref1, int H, int W,
                     const int32_t* mv0, const int32_t* mv1, int nb, int n,
                     int chroma, int max_mv, int32_t* out, int32_t* excess,
                     cudaStream_t stream) {
  if (n != 8 && n != 16 && n != 32) return (int)cudaErrorInvalidValue;
  if (chroma)
    mc_bi_kernel<4><<<nb, n * n, 0, stream>>>(ref0, ref1, H, W, mv0, mv1, n,
                                              max_mv, out, excess);
  else
    mc_bi_kernel<8><<<nb, n * n, 0, stream>>>(ref0, ref1, H, W, mv0, mv1, n,
                                              max_mv, out, excess);
  return (int)cudaGetLastError();
}
