// Kernel K1 `intra_pred`: HEVC intra prediction for the CTU32 tree.
//
// Replaces, from the JAX package: ops/intra.py substitute_refs_general,
// predict_all_modes_batch and predict_modes_batch, and
// models/intra_tree.py _satd_modes (the 8x8 Hadamard SATD of all 35 modes).
//
// Entry points (plain C, launched on the caller's stream, return
// cudaGetLastError()):
//   intra_satd35  raw refs + availability + source block -> [B, 35] SATD
//   intra_predict raw refs + availability + modes [B, K] -> [B, K, n, n]
// Both take the bit depth (8 or 10), a template parameter of the kernels:
// the mid-grey fill of a block without references is 1 << (bd - 1), the
// mode 10/26 edge filters clip to (1 << bd) - 1 (JAX ops/intra.py:141,
// 262, 356, 390).
//
// What bounds it on an H100: integer work, not bytes.  satd35 reads one
// n x n source block and 8n+1 reference samples per block and writes 35
// ints, but computes 35 n x n predictions and their Hadamard transforms
// (about 35 * n * n * 12 integer operations).  The JAX version
// materialises all predictions, [B, 35, n, n] int32 (about 550 MB per CU
// size at the main path's 16-frame batch); here each thread builds one
// 8x8 prediction tile in registers from the references in shared memory
// (two taps per sample, ((32 - f) * a + f * b + 16) >> 5), transforms it
// with add/sub butterflies and adds its SATD into a shared per-mode sum,
// so the predictions never reach device memory.  Integer atomics make
// the sums order-independent and exact.

#include <cstdint>
#include <cuda_runtime.h>

#include "intra_chain.cuh"

namespace {

using namespace intra_chain;

__device__ __forceinline__ void fwht8(int* v) {
#pragma unroll
  for (int s = 1; s < 8; s <<= 1) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (!(i & s)) {
        int a = v[i], b = v[i + s];
        v[i] = a + b;
        v[i + s] = a - b;
      }
    }
  }
}

template <int BD>
__global__ void satd35_kernel(const int32_t* __restrict__ orig,
                              const int32_t* top_raw,
                              const int32_t* left_raw,
                              const int32_t* corner_raw,
                              const uint8_t* av_top, const uint8_t* av_left,
                              const uint8_t* av_corner,
                              int32_t* __restrict__ out, int n, int c_idx) {
  __shared__ int s[kMaxSeq];
  __shared__ int f[kMaxSeq];
  __shared__ int src[kMaxN * kMaxN];
  __shared__ int sat[35];
  __shared__ int dc_sh;
  const int b = blockIdx.x;
  const int log2n = 31 - __clz(n);
  for (int i = threadIdx.x; i < n * n; i += blockDim.x)
    src[i] = orig[(size_t)b * n * n + i];
  if (threadIdx.x < 35) sat[threadIdx.x] = 0;
  load_refs<BD>(top_raw, left_raw, corner_raw, av_top, av_left, av_corner,
                b, n, s, f);
  if (threadIdx.x == 0) dc_sh = dc_value(s, n, log2n);
  __syncthreads();
  const RefView r{s, f, n};
  const int dc = dc_sh;
  const int kb = n / 8;
  const int tasks = 35 * kb * kb;
  for (int t = threadIdx.x; t < tasks; t += blockDim.x) {
    const int mode = t / (kb * kb);
    const int sb = t % (kb * kb);
    const int y0 = (sb / kb) * 8, x0 = (sb % kb) * 8;
    int d[8][8];
#pragma unroll
    for (int yy = 0; yy < 8; ++yy) {
#pragma unroll
      for (int xx = 0; xx < 8; ++xx) {
        d[yy][xx] = src[(y0 + yy) * n + x0 + xx] -
                    pred_sample<BD>(r, mode, c_idx, log2n, dc, y0 + yy,
                                    x0 + xx);
      }
      fwht8(d[yy]);
    }
    int acc = 0;
#pragma unroll
    for (int xx = 0; xx < 8; ++xx) {
      int col[8];
#pragma unroll
      for (int yy = 0; yy < 8; ++yy) col[yy] = d[yy][xx];
      fwht8(col);
#pragma unroll
      for (int yy = 0; yy < 8; ++yy) acc += abs(col[yy]);
    }
    atomicAdd(&sat[mode], (acc + 2) >> 2);
  }
  __syncthreads();
  if (threadIdx.x < 35) out[(size_t)b * 35 + threadIdx.x] = sat[threadIdx.x];
}

template <int BD>
__global__ void predict_kernel(const int32_t* top_raw,
                               const int32_t* left_raw,
                               const int32_t* corner_raw,
                               const uint8_t* av_top,
                               const uint8_t* av_left,
                               const uint8_t* av_corner,
                               const int32_t* __restrict__ modes,
                               int32_t* __restrict__ out, int K, int n,
                               int c_idx) {
  __shared__ int s[kMaxSeq];
  __shared__ int f[kMaxSeq];
  __shared__ int dc_sh;
  const int bk = blockIdx.x;
  const int b = bk / K;
  const int log2n = 31 - __clz(n);
  load_refs<BD>(top_raw, left_raw, corner_raw, av_top, av_left, av_corner,
                b, n, s, f);
  if (threadIdx.x == 0) dc_sh = dc_value(s, n, log2n);
  __syncthreads();
  const RefView r{s, f, n};
  const int mode = modes[bk];
  for (int i = threadIdx.x; i < n * n; i += blockDim.x) {
    out[(size_t)bk * n * n + i] =
        pred_sample<BD>(r, mode, c_idx, log2n, dc_sh, i / n, i % n);
  }
}

}  // namespace

extern "C" int intra_satd35(const int32_t* orig, const int32_t* top_raw,
                            const int32_t* left_raw,
                            const int32_t* corner_raw, const uint8_t* av_top,
                            const uint8_t* av_left,
                            const uint8_t* av_corner, int32_t* out, int B,
                            int n, int c_idx, int bd, cudaStream_t stream) {
  if (n != 8 && n != 16 && n != 32) return (int)cudaErrorInvalidValue;
  if (bd != 8 && bd != 10) return (int)cudaErrorInvalidValue;
  if (bd == 8)
    satd35_kernel<8><<<B, 128, 0, stream>>>(orig, top_raw, left_raw,
                                            corner_raw, av_top, av_left,
                                            av_corner, out, n, c_idx);
  else
    satd35_kernel<10><<<B, 128, 0, stream>>>(orig, top_raw, left_raw,
                                             corner_raw, av_top, av_left,
                                             av_corner, out, n, c_idx);
  return (int)cudaGetLastError();
}

extern "C" int intra_predict(const int32_t* top_raw, const int32_t* left_raw,
                             const int32_t* corner_raw,
                             const uint8_t* av_top, const uint8_t* av_left,
                             const uint8_t* av_corner, const int32_t* modes,
                             int32_t* out, int B, int K, int n, int c_idx,
                             int bd, cudaStream_t stream) {
  if (n != 8 && n != 16 && n != 32) return (int)cudaErrorInvalidValue;
  if (bd != 8 && bd != 10) return (int)cudaErrorInvalidValue;
  if (bd == 8)
    predict_kernel<8><<<B * K, 256, 0, stream>>>(top_raw, left_raw,
                                                 corner_raw, av_top, av_left,
                                                 av_corner, modes, out, K, n,
                                                 c_idx);
  else
    predict_kernel<10><<<B * K, 256, 0, stream>>>(top_raw, left_raw,
                                                  corner_raw, av_top,
                                                  av_left, av_corner, modes,
                                                  out, K, n, c_idx);
  return (int)cudaGetLastError();
}
