// Kernel K3 `tu_bits`: context-anchored fractional CABAC bits of a TU
// (cbf, last position, coded-sub-block flags, significance map,
// greater1/greater2 flags, Golomb-Rice remainders, signs), priced at the
// slice type's init states from a [52, 13] QP-indexed table.
//
// Replaces, from the JAX package: ops/estbits.py tu_bits (the per-block QP
// path used by models/intra_tree.py _rbits_proxy).
//
// Entry point (plain C, caller's stream, returns cudaGetLastError()):
//   tu_bits(levels [T,n,n] i16, qp [T] i32, table [52*13] f32,
//           out [T] f32, T, n)
//
// What bounds it on an H100: bytes.  It reads each level once (2 bytes)
// and does a few integer operations per coefficient.  One thread block
// prices one TU; each thread walks one 4x4 coefficient group
// (tu_bits.cuh, shared with K23), and the per-TU counts meet in shared
// memory through integer atomics, which is exact and order-independent.
// The f32 result must equal the plain PyTorch version bit for bit, because
// these costs decide argmins: every fractional family is summed in integer
// units of 2^-15 bit, converted once (round to nearest), and the nine
// families are added in the JAX expression's order with __fadd_rn /
// __fmul_rn.  The file is also built with --fmad=false, so no multiply-add
// is ever contracted.

#include <cstdint>
#include <cuda_runtime.h>

#include "tu_bits.cuh"

namespace {

using namespace tu_bits_dev;

__global__ void tu_bits_kernel(const int16_t* __restrict__ levels,
                               const int32_t* __restrict__ qp_arr,
                               const float* __restrict__ table,
                               float* __restrict__ out, int n) {
  __shared__ TuCounts c;
  const int t = blockIdx.x;
  if (threadIdx.x == 0) clear(&c);
  __syncthreads();
  const int g4 = n / 4;
  if ((int)threadIdx.x < g4 * g4)
    group_counts(levels + (size_t)t * n * n, n, threadIdx.x, &c);
  __syncthreads();
  if (threadIdx.x == 0) {
    int q = qp_arr[t];
    q = q < 0 ? 0 : (q > 51 ? 51 : q);
    out[t] = total_bits(c, n, table + q * 13);
  }
}

}  // namespace

extern "C" int tu_bits(const int16_t* levels, const int32_t* qp,
                       const float* table, float* out, int T, int n,
                       cudaStream_t stream) {
  if (n != 8 && n != 16 && n != 32) return (int)cudaErrorInvalidValue;
  tu_bits_kernel<<<T, 64, 0, stream>>>(levels, qp, table, out, n);
  return (int)cudaGetLastError();
}
