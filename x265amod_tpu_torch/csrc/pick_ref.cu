// Kernel K18 `pick_ref`: the best reference of each CU of a multi-reference
// P frame from its per-reference inter trials.
//
// Replaces, from the JAX package: models/inter_tree.py pick_ref (:274-290),
// the per-CU argmin over the R references of
//   j_r = d_r + lam * ((rb_r + mvd_bits(mv_r)) + refbits_r)
// (mvd_bits of the absolute MV, as JAX prices it), first minimum, and the
// gather of the chosen d, rb and MV.  XLA's CPU code contracts the product,
// whose one use is the add, into an FMA: the kernel writes that FMA with
// __fmaf_rn and is built with --fmad=false so that nothing else contracts.
//
// Entry point (plain C, caller's stream, returns cudaGetLastError()):
//   pick_ref(d [n,R] f32, rb [n,R] f32, mv [n,R,2] i32, lam [n] f32,
//            refbits [R] f32, n, R, best [n] i32, d_out [n] f32,
//            rb_out [n] f32, mv_out [n,2] i32)
//
// What bounds it on an H100: bytes (R x 16 bytes in and 20 out per CU, a
// few operations each).  One thread per CU, its R <= 4 candidates in
// registers.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int bitlen(int a) {
  return a == 0 ? 0 : 32 - __clz(a);
}

// bins of an MVD (the port's ops/me.py mvd_bits): 1 + 2 bitlen(|c|) per
// component, as an exact f32
__device__ __forceinline__ float mvd_bits(int x, int y) {
  return (float)(2 * (bitlen(abs(x)) + bitlen(abs(y))) + 2);
}

__global__ void pick_ref_kernel(const float* __restrict__ d,
                                const float* __restrict__ rb,
                                const int32_t* __restrict__ mv,
                                const float* __restrict__ lam,
                                const float* __restrict__ refbits, int n,
                                int R, int32_t* __restrict__ best,
                                float* __restrict__ d_out,
                                float* __restrict__ rb_out,
                                int32_t* __restrict__ mv_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float l = lam[i];
  int b = 0;
  float jb = 0.0f;
  for (int r = 0; r < R; ++r) {
    const int k = i * R + r;
    const float x = (rb[k] + mvd_bits(mv[2 * k], mv[2 * k + 1])) + refbits[r];
    const float j = __fmaf_rn(l, x, d[k]);
    if (r == 0 || j < jb) {
      jb = j;
      b = r;
    }
  }
  const int k = i * R + b;
  best[i] = b;
  d_out[i] = d[k];
  rb_out[i] = rb[k];
  mv_out[2 * i] = mv[2 * k];
  mv_out[2 * i + 1] = mv[2 * k + 1];
}

}  // namespace

extern "C" int pick_ref(const float* d, const float* rb, const int32_t* mv,
                        const float* lam, const float* refbits, int n, int R,
                        int32_t* best, float* d_out, float* rb_out,
                        int32_t* mv_out, cudaStream_t stream) {
  if (R < 1 || R > 4) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  pick_ref_kernel<<<blocks, threads, 0, stream>>>(d, rb, mv, lam, refbits, n,
                                                  R, best, d_out, rb_out,
                                                  mv_out);
  return (int)cudaGetLastError();
}
