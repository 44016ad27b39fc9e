// Kernel `mv_argmin`: the integer MV of every block from its SSD grid, the
// first minimum of fma(lam, mvd_bits(4 d), grid[d]) over the grid.
//
// Replaces, from the JAX package: the cost and argmin of
// models/inter_tree.py best_mv (:227-229), `grid + lam * mvbits_grid` and
// `jnp.argmin`, which XLA's CPU code forms as one vfmadd231ss of lam and
// the MV bins onto the grid value (the product's one use is the add).
//
// Entry point (plain C, caller's stream, returns cudaGetLastError()):
//   mv_argmin(grid [nb,S,S] f32 (dy-major), lam [nb] f32, nb, sr,
//             out [nb,2] i32 (dx, dy)),  S = 2 sr + 1
//
// Design: a thread block per block, 256 threads; each thread keeps the
// first minimum of its strided share of the grid, then a warp-shuffle and
// a shared-memory reduction take the minimum with the lowest index, which
// is jnp.argmin's tie rule.  The cost is __fmaf_rn (built with
// --fmad=false).  mvd_bits of a qpel component a is 1 + 2 bitlen(|a|), of
// a vector the sum (ops/me.py mvd_bits).
//
// What bounds it on an H100: bytes (each grid entry read once).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float mvd_bits(int dx, int dy) {
  const int ax = abs(4 * dx), ay = abs(4 * dy);
  const int bx = ax ? 32 - __clz(ax) : 0, by = ay ? 32 - __clz(ay) : 0;
  return (float)(2 * (bx + by) + 2);
}

__device__ __forceinline__ void keep_min(float& c, int& i, float c2,
                                         int i2) {
  if (c2 < c || (c2 == c && i2 < i)) {
    c = c2;
    i = i2;
  }
}

__global__ void __launch_bounds__(kThreads)
    argmin_kernel(const float* __restrict__ grid,
                  const float* __restrict__ lam, int sr,
                  int32_t* __restrict__ out) {
  __shared__ float sh_c[kThreads / 32];
  __shared__ int sh_i[kThreads / 32];
  const int b = blockIdx.x;
  const int S = 2 * sr + 1;
  const float* g = grid + (size_t)b * S * S;
  const float l = lam[b];
  float best = __int_as_float(0x7f800000);   // +inf
  int bi = S * S;
  for (int o = threadIdx.x; o < S * S; o += kThreads) {
    const float c = __fmaf_rn(l, mvd_bits(o % S - sr, o / S - sr), g[o]);
    keep_min(best, bi, c, o);
  }
  for (int off = 16; off; off >>= 1) {
    const float c2 = __shfl_down_sync(0xffffffffu, best, off);
    const int i2 = __shfl_down_sync(0xffffffffu, bi, off);
    keep_min(best, bi, c2, i2);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    sh_c[warp] = best;
    sh_i[warp] = bi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) keep_min(best, bi, sh_c[w],
                                                     sh_i[w]);
    out[2 * b] = bi % S - sr;
    out[2 * b + 1] = bi / S - sr;
  }
}

}  // namespace

extern "C" int mv_argmin(const float* grid, const float* lam, int nb, int sr,
                         int32_t* out, cudaStream_t stream) {
  if (nb < 1 || sr < 1 || sr > 64) return (int)cudaErrorInvalidValue;
  argmin_kernel<<<nb, kThreads, 0, stream>>>(grid, lam, sr, out);
  return (int)cudaGetLastError();
}
