// Kernel K14 `cutree_prop`: one CU-tree back-propagation step of the
// lookahead, as a deterministic gather.
//
// Replaces, from the JAX package: models/lookahead.py cutree_propagate_step
// (each lowres block's amount (intra + prop_in) (intra - min(inter, intra))
// / max(intra, 1), spread over the four blocks around where its MV points
// with bilinear weights by four scatter-adds, `.at[].add`).
//
// Entry point (plain C, caller's stream, returns cudaGetLastError()):
//   cutree_prop(prop_in, intra, inter [hb,wb] f32, mv [hb,wb,2] i32 (x, y),
//               out [hb,wb] f32, hb, wb, rng, stream)     |mv| <= rng
//
// What bounds it on an H100: launch latency (at config 3 the map is 68 x
// 120 blocks, 130 KB in and 33 KB out).  Float atomics would add in an
// order that changes from run to run, so each thread owns one target block
// and sums its own sources, which lie within ceil(rng / 8) + 1 blocks: no
// atomics, the same result every run.  The order is XLA's CPU scatter
// order, which the JAX results pin: scatter 1 (the (y0, x0) corner) over
// the sources in row-major order, then the (y0, x1), (y1, x0) and (y1, x1)
// scatters.  Each source's amount and weights are recomputed by every
// target that reads it, in the JAX order of operations (amount * (1 - fx))
// * (1 - fy), with a correctly rounded division and no contraction
// (--fmad=false).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void cutree_prop_kernel(const float* __restrict__ prop_in,
                                   const float* __restrict__ intra,
                                   const float* __restrict__ inter,
                                   const int32_t* __restrict__ mv,
                                   float* __restrict__ out, int hb, int wb,
                                   int r) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= hb * wb) return;
  const int ty = t / wb, tx = t % wb;
  float acc = 0.0f;
  for (int k = 0; k < 4; ++k) {
    for (int sy = ty - r; sy <= ty + r; ++sy) {
      if (sy < 0 || sy >= hb) continue;
      for (int sx = tx - r; sx <= tx + r; ++sx) {
        if (sx < 0 || sx >= wb) continue;
        const int s = sy * wb + sx;
        const int by = sy * 8 + mv[2 * s + 1];
        const int bx = sx * 8 + mv[2 * s];
        const int x0 = clampi(bx >> 3, 0, wb - 1);   // floor division
        const int y0 = clampi(by >> 3, 0, hb - 1);
        const int x1 = clampi(x0 + 1, 0, wb - 1);
        const int y1 = clampi(y0 + 1, 0, hb - 1);
        const int yk = (k < 2) ? y0 : y1;
        const int xk = (k & 1) ? x1 : x0;
        if (yk != ty || xk != tx) continue;
        const float ic = intra[s];
        const float inter_c = fminf(inter[s], ic);
        const float ratio =
            ic > 0.0f ? __fdiv_rn(__fsub_rn(ic, inter_c), fmaxf(ic, 1.0f))
                      : 0.0f;
        const float amount = __fmul_rn(__fadd_rn(ic, prop_in[s]), ratio);
        const float fx =
            fminf(fmaxf(__int2float_rn(bx - x0 * 8) / 8.0f, 0.0f), 1.0f);
        const float fy =
            fminf(fmaxf(__int2float_rn(by - y0 * 8) / 8.0f, 0.0f), 1.0f);
        const float wx = (k & 1) ? fx : __fsub_rn(1.0f, fx);
        const float wy = (k < 2) ? __fsub_rn(1.0f, fy) : fy;
        acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(amount, wx), wy));
      }
    }
  }
  out[t] = acc;
}

}  // namespace

extern "C" int cutree_prop(const float* prop_in, const float* intra,
                           const float* inter, const int32_t* mv, float* out,
                           int hb, int wb, int rng, cudaStream_t stream) {
  if (hb <= 0 || wb <= 0 || rng < 1 || rng > 16)
    return (int)cudaErrorInvalidValue;
  const int r = (rng + 7) / 8 + 1;
  const int n = hb * wb;
  cutree_prop_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
      prop_in, intra, inter, mv, out, hb, wb, r);
  return (int)cudaGetLastError();
}
