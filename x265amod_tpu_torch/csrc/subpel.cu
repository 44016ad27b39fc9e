// Kernel K6 `subpel_refine`: exhaustive +-2 quarter-pel refinement around
// each block's integer MV.  25 candidates (dy outer, dx inner, -2..2): 8-tap
// horizontal then vertical interpolation (spec 8.5.3.3.3, 8-bit), uni
// rounding, SSD against the block, cost ssd + lam * mvd_bits(mv), first
// minimum.
//
// Replaces, from the JAX package: ops/me.py subpel_refine (+ _mvd_bits_f,
// and the one-hot window fetch _block_windows it uses).
//
// Entry point (plain C, caller's stream, returns cudaGetLastError()):
//   subpel_refine(ref [H,W] i32, H, W, cur [nb,n,n] i32, mv_int [nb,2] i32,
//                 lam [nb] f32, n, mv_out [nb,2] i32, ssd_out [nb] f32)
//
// What bounds it on an H100: integer operations (the two filter passes and
// 25 SSDs per pixel).  One thread block per block: its (n+8)^2 window is
// read once at clamped coordinates (edge padding) into shared memory, the
// five horizontal phases of the window are filtered there, and each warp
// takes whole candidates, reducing its exact int32 SSD with shuffles.  The
// cost decides an argmin, so it is formed as XLA's CPU code forms JAX's
// `cost + lam * rate`: one FMA (__fmaf_rn; built with --fmad=false so that
// nothing else contracts).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__constant__ int kLuma[4][8] = {{0, 0, 0, 64, 0, 0, 0, 0},
                                {-1, 4, -10, 58, 17, -5, 1, 0},
                                {-1, 4, -11, 40, 40, -11, 4, -1},
                                {0, 1, -5, 17, 58, -10, 4, -1}};
// qpel delta -2..2 -> (integer offset, phase)
__constant__ int kIo[5] = {-1, -1, 0, 0, 0};
__constant__ int kPh[5] = {2, 3, 0, 1, 2};

__device__ __forceinline__ int bitlen(int x) {
  return x > 0 ? 32 - __clz(x) : 0;
}

__device__ __forceinline__ float mv_bins(int v) {
  return (float)(1 + 2 * bitlen(v < 0 ? -v : v));
}

__global__ void subpel_kernel(const int32_t* __restrict__ ref, int H, int W,
                              const int32_t* __restrict__ cur,
                              const int32_t* __restrict__ mv_int,
                              const float* __restrict__ lam, int n,
                              int32_t* __restrict__ mv_out,
                              float* __restrict__ ssd_out) {
  extern __shared__ int sh[];
  __shared__ int acc[25];
  const int wn = n + 8;
  int* win = sh;                      // [wn][wn]
  int* hs = win + wn * wn;            // [5][wn][n]
  int* blk = hs + 5 * wn * n;         // [n][n]
  const int b = blockIdx.x;
  const int wb = W / n;
  const int bx = (b % wb) * n, by = (b / wb) * n;
  const int mx = mv_int[2 * b], my = mv_int[2 * b + 1];
  for (int i = threadIdx.x; i < wn * wn; i += blockDim.x) {
    int y = by + my - 4 + i / wn, x = bx + mx - 4 + i % wn;
    y = y < 0 ? 0 : (y > H - 1 ? H - 1 : y);
    x = x < 0 ? 0 : (x > W - 1 ? W - 1 : x);
    win[i] = ref[(size_t)y * W + x];
  }
  for (int i = threadIdx.x; i < n * n; i += blockDim.x)
    blk[i] = cur[(size_t)b * n * n + i];
  __syncthreads();
  // horizontal pass for the five x deltas: hs[xi][r][j]
  for (int i = threadIdx.x; i < 5 * wn * n; i += blockDim.x) {
    const int xi = i / (wn * n), r = (i / n) % wn, j = i % n;
    const int* t = kLuma[kPh[xi]];
    const int* src = win + r * wn + 1 + kIo[xi] + j;
    int s = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) s += t[k] * src[k];
    hs[i] = s;
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  for (int cand = warp; cand < 25; cand += nwarps) {
    const int yi = cand / 5, xi = cand % 5;
    const int* t = kLuma[kPh[yi]];
    const int* h = hs + xi * wn * n + (1 + kIo[yi]) * n;
    int local = 0;
    for (int p = lane; p < n * n; p += 32) {
      const int i = p / n, j = p % n;
      int s = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) s += t[k] * h[(i + k) * n + j];
      int pred = ((s >> 6) + 32) >> 6;
      pred = pred < 0 ? 0 : (pred > 255 ? 255 : pred);
      const int d = pred - blk[p];
      local += d * d;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      local += __shfl_down_sync(0xffffffffu, local, off);
    if (lane == 0) acc[cand] = local;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const float l = lam[b];
    float best_cost = 0.0f;
    int best = 0;
    for (int cand = 0; cand < 25; ++cand) {
      const int vx = 4 * mx + cand % 5 - 2, vy = 4 * my + cand / 5 - 2;
      const float rate = __fadd_rn(mv_bins(vx), mv_bins(vy));
      const float cost = __fmaf_rn(l, rate, __int2float_rn(acc[cand]));
      if (cand == 0 || cost < best_cost) {
        best_cost = cost;
        best = cand;
      }
    }
    mv_out[2 * b] = 4 * mx + best % 5 - 2;
    mv_out[2 * b + 1] = 4 * my + best / 5 - 2;
    ssd_out[b] = __int2float_rn(acc[best]);
  }
}

}  // namespace

extern "C" int subpel_refine(const int32_t* ref, int H, int W,
                             const int32_t* cur, const int32_t* mv_int,
                             const float* lam, int n, int32_t* mv_out,
                             float* ssd_out, cudaStream_t stream) {
  if (n != 16 && n != 32) return (int)cudaErrorInvalidValue;
  const int nb = (H / n) * (W / n);
  const int wn = n + 8;
  const size_t shmem = (size_t)(wn * wn + 5 * wn * n + n * n) * sizeof(int);
  subpel_kernel<<<nb, 256, shmem, stream>>>(ref, H, W, cur, mv_int, lam, n,
                                            mv_out, ssd_out);
  return (int)cudaGetLastError();
}
