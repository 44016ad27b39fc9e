// Kernel K13 `lowres_me`: the lookahead's lowres motion search, a full
// search of every 8x8 block of the lowres plane over [-rng, rng]^2 of the
// previous lowres plane read at clamped coordinates (the JAX edge padding).
//
// Replaces, from the JAX package: models/lookahead.py lowres_inter_cost (an
// im2col of the padded reference, two grouped f32 convolutions and
// w2 - 2 corr + c2, then the first argmin and sqrt(max(c, 0) * 64)).
//
// Entry point (plain C, caller's stream, returns cudaGetLastError()):
//   lowres_me(cur [h,w] u8, ref [h,w] u8, cost [h/8,w/8] f32 out,
//             mv [h/8,w/8,2] i32 out (x, y), h, w, rng, stream)
//
// What bounds it on an H100: integer operations (S^2 = 289 candidates of 64
// differences, squares and adds per block at rng 8, against 64 bytes of
// the block and its 24x24 window).  One thread block per 8x8 block holds
// the block and its (8 + 2 rng)^2 window in shared memory; each thread sums
// the exact int32 SSD of one offset (every JAX term is an integer below
// 2^24, so its f32 SSD is this integer), and the block keeps the least
// (SSD, flat index) pair, the flat index dy (2 rng + 1) + dx being JAX's
// argmin order, so the first minimum wins.  cost = sqrt(ssd * 64) is
// rounded to nearest (__fsqrt_rn), as XLA's sqrt is; ssd * 64 is exact.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxRng = 16;
constexpr int kMaxWin = 8 + 2 * kMaxRng;

__global__ void lowres_me_kernel(const uint8_t* __restrict__ cur,
                                 const uint8_t* __restrict__ ref, int h,
                                 int w, int rng, float* __restrict__ cost,
                                 int32_t* __restrict__ mv) {
  __shared__ int win[kMaxWin * kMaxWin];
  __shared__ int blk[64];
  __shared__ unsigned long long best;
  const int S = 2 * rng + 1;
  const int ws = 8 + 2 * rng;
  const int wb = w / 8;
  const int b = blockIdx.x;
  const int bx = (b % wb) * 8, by = (b / wb) * 8;
  for (int i = threadIdx.x; i < ws * ws; i += blockDim.x) {
    int yy = by - rng + i / ws, xx = bx - rng + i % ws;
    yy = yy < 0 ? 0 : (yy > h - 1 ? h - 1 : yy);
    xx = xx < 0 ? 0 : (xx > w - 1 ? w - 1 : xx);
    win[i] = ref[(size_t)yy * w + xx];
  }
  if (threadIdx.x < 64)
    blk[threadIdx.x] =
        cur[(size_t)(by + threadIdx.x / 8) * w + bx + threadIdx.x % 8];
  if (threadIdx.x == 0) best = ~0ULL;
  __syncthreads();
  for (int o = threadIdx.x; o < S * S; o += blockDim.x) {
    const int dy = o / S, dx = o % S;
    int acc = 0;
#pragma unroll
    for (int yy = 0; yy < 8; ++yy) {
      const int* wr = win + (dy + yy) * ws + dx;
      const int* cr = blk + yy * 8;
#pragma unroll
      for (int xx = 0; xx < 8; ++xx) {
        const int d = cr[xx] - wr[xx];
        acc += d * d;
      }
    }
    atomicMin(&best, ((unsigned long long)acc << 16) | (unsigned)o);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int ssd = (int)(best >> 16);
    const int o = (int)(best & 0xffff);
    cost[b] = __fsqrt_rn(__int2float_rn(ssd) * 64.0f);
    mv[2 * b] = o % S - rng;
    mv[2 * b + 1] = o / S - rng;
  }
}

}  // namespace

extern "C" int lowres_me(const uint8_t* cur, const uint8_t* ref, float* cost,
                         int32_t* mv, int h, int w, int rng,
                         cudaStream_t stream) {
  if (h <= 0 || w <= 0 || h % 8 || w % 8 || rng < 1 || rng > kMaxRng)
    return (int)cudaErrorInvalidValue;
  const int nb = (h / 8) * (w / 8);
  const int S = 2 * rng + 1;
  int threads = ((S * S + 31) / 32) * 32;
  threads = threads > 1024 ? 1024 : threads;
  lowres_me_kernel<<<nb, threads, 0, stream>>>(cur, ref, h, w, rng, cost,
                                               mv);
  return (int)cudaGetLastError();
}
