// Kernel K1 `intra_pred`: HEVC intra prediction for the CTU32 tree, the
// flat P/B frames' intra trial and the lookahead.
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
// 262, 356, 390).  Exact for samples in [0, 2^bd - 1].
//
// What bounds it on an H100.  satd35 reads one n x n block and 8n + 1
// reference samples a CU and writes 35 ints, but forms 35 n x n
// predictions and their Hadamard transforms: operations.  predict writes
// K n x n int32 predictions a CU (the flat intra trial: 8160 CU16s x 35
// modes, 292 MB at 1080p): bytes.  A serial substitution, references
// loaded again for every mode, and lanes of one warp on different modes
// (every branch of the prediction diverging) would each cost more than
// that work.  Here:
//   - references: one warp a CU, once per thread block.  The substitution
//     "the nearest available sample before, else the first available" is a
//     segmented fill: a ballot of the availability per 32 entries, the
//     highest set bit at or below the lane (else the carry from earlier
//     chunks); then the [1 2 1] smoothing and the DC value (a warp sum).
//   - every warp works on one mode at a time (warp-uniform branches), from
//     the mode's reference line L[-n .. 2n + 1] (the side projected through
//     the inverse angle; intra_chain.cuh line_at), built once per (mode, CU)
//     in shared memory, so an angular sample (intra_chain.cuh angular_at,
//     the arithmetic K20 and K23 share) is two loads and
//     ((32 - f) a + f b + 16) >> 5.
//   - predict: a thread block serves several CUs and all their modes; the
//     lanes of a warp own consecutive samples of one (CU, mode) (two CUs at
//     n 8) and store 16 bytes each, streaming (the output is read once).
//   - satd35: warp w owns modes w, w + 7, ..., w + 28 over all the CUs of
//     its block (16 at n 8, 4 at n 16, 1 at n 32: eight pairs of 8x8
//     blocks a mode).  H D H^T runs on the tensor cores as two f16 mma.sync
//     with f32 accumulation: stage 1 blockdiag(H, H) [D_a; D_b]
//     (m16n8k16), stage 2 its result times H^T (m16n8k8, whose A fragment
//     is stage 1's accumulator layout).  H holds +-1.  At bit depth 8 every
//     step is exact: |D| <= 255, stage 1 <= 2,040 (f16 holds integers to
//     2,048), stage 2 <= 16,320 in f32.  At bit depth 10 stage 1 reaches
//     8,184, so its output splits as 64 hi + lo (|hi| <= 128, 0 <= lo < 64,
//     both exact in f16) and stage 2 takes two products, 64 R_hi + R_lo,
//     exact in f32: one more mma instead of integer butterflies.  Each
//     block's sum of |.| is a warp reduction (no atomics), then
//     (sum + 2) >> 2.

#include <cstdint>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "intra_chain.cuh"

namespace {

using namespace intra_chain;

constexpr unsigned kFull = 0xffffffffu;

template <int N>
__host__ __device__ constexpr int log2_of() {
  return N == 8 ? 3 : (N == 16 ? 4 : 5);
}

// One warp substitutes and smooths the references of CU b into s and f
// (the scan layout of intra_chain.cuh) and writes its DC value.
template <int N, int BD>
__device__ void warp_refs(const int32_t* top_raw, const int32_t* left_raw,
                          const int32_t* corner_raw, const uint8_t* av_top,
                          const uint8_t* av_left, const uint8_t* av_corner,
                          int b, int* s, int* f, int* dc, int lane) {
  constexpr int M = 4 * N + 1;
  constexpr int NC = (M + 31) / 32;
  const int32_t* tr = top_raw + (size_t)b * 2 * N;
  const int32_t* lr = left_raw + (size_t)b * 2 * N;
  const uint8_t* at = av_top + (size_t)b * 2 * N;
  const uint8_t* al = av_left + (size_t)b * 2 * N;
  bool av[NC];
  unsigned bal[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int i = 32 * c + lane;
    bool a = false;
    if (i < 2 * N) {
      a = al[2 * N - 1 - i];
      s[i] = lr[2 * N - 1 - i];
    } else if (i == 2 * N) {
      a = av_corner[b];
      s[i] = corner_raw[b];
    } else if (i < M) {
      a = at[i - 2 * N - 1];
      s[i] = tr[i - 2 * N - 1];
    }
    av[c] = a;
    bal[c] = __ballot_sync(kFull, a);
  }
  __syncwarp();
  int first = -1;
#pragma unroll
  for (int c = NC - 1; c >= 0; --c)
    if (bal[c]) first = 32 * c + __ffs(bal[c]) - 1;
  int carry = -1;   // the last available entry before this chunk
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int i = 32 * c + lane;
    const unsigned le = bal[c] & ((2u << lane) - 1u);
    const int src = le ? 32 * c + 31 - __clz(le) : carry;
    if (bal[c]) carry = 32 * c + 31 - __clz(bal[c]);
    // an available entry is never written, so the reads see raw samples
    if (i < M && !av[c])
      s[i] = first < 0 ? 1 << (BD - 1) : s[src < 0 ? first : src];
  }
  __syncwarp();
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int i = 32 * c + lane;
    if (i < M) f[i] = smooth_121(s, M, i);
  }
  const int part = lane < N ? top_at(s, N, lane) + left_at(s, N, lane) : 0;
  const int acc = __reduce_add_sync(kFull, part);
  if (lane == 0) *dc = (acc + N) >> (log2_of<N>() + 1);
}

// Sample (y, x) of `mode` from the mode's line L (L[i], i in [-N, 2N + 1],
// a copy of line_at in shared memory).
template <int N, int BD>
__device__ __forceinline__ int sample(int mode, bool edge, const int* u,
                                      const int* R, const int* L, int dc,
                                      int y, int x) {
  return sample_at<BD>(
      mode, edge, u, R, [L](int i) { return L[i]; }, dc, N, log2_of<N>(), y,
      x);
}

__device__ __forceinline__ unsigned pack_h2(float lo, float hi) {
  const __half2 h = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// d = a (16x16 f16) . b (16x8 f16), f32 accumulation from 0
__device__ __forceinline__ void mma_k16(float (&d)[4], unsigned a0,
                                        unsigned a1, unsigned a2,
                                        unsigned a3, unsigned b0,
                                        unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1), "f"(0.0f));
}

// d = a (16x8 f16) . b (8x8 f16), f32 accumulation from 0
__device__ __forceinline__ void mma_k8(float (&d)[4], unsigned a0,
                                       unsigned a1, unsigned b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%7,%7,%7,%7};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0), "f"(0.0f));
}

// CUs a thread block serves
template <int N>
__host__ __device__ constexpr int satd_cus() {
  return N == 8 ? 16 : (N == 16 ? 4 : 1);
}
template <int N>
__host__ __device__ constexpr int pred_cus() {
  return N == 8 ? 16 : (N == 16 ? 4 : 2);
}
constexpr int kSatdWarps = 7;   // 35 modes = 7 warps x 5
constexpr int kPredWarps = 8;

template <int N, int BD>
__global__ void __launch_bounds__(32 * kSatdWarps)
    satd35_kernel(const int32_t* __restrict__ orig, const int32_t* top_raw,
                  const int32_t* left_raw, const int32_t* corner_raw,
                  const uint8_t* av_top, const uint8_t* av_left,
                  const uint8_t* av_corner, int32_t* __restrict__ out,
                  int B, int c_idx) {
  constexpr int M = 4 * N + 1, NL = 3 * N + 2, CPB = satd_cus<N>();
  constexpr int P = N + 4;   // source row pitch: the 4 fragment rows of a
                             // lane group fall in distinct banks
  __shared__ int s[CPB][M], f[CPB][M], dcs[CPB];
  __shared__ int src[CPB][N * P];
  __shared__ int lines[kSatdWarps][CPB][NL];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b0 = blockIdx.x * CPB;
  const int nb = min(CPB, B - b0);
  for (int i = threadIdx.x; i < nb * N * N; i += blockDim.x)
    src[i / (N * N)][(i % (N * N)) / N * P + i % N] =
        orig[(size_t)b0 * N * N + i];
  for (int cu = warp; cu < nb; cu += kSatdWarps)
    warp_refs<N, BD>(top_raw, left_raw, corner_raw, av_top, av_left,
                     av_corner, b0 + cu, s[cu], f[cu], &dcs[cu], lane);
  __syncthreads();

  const int g = lane >> 2, t = lane & 3;
  // H[g][2t], H[g][2t + 1] of the Sylvester Hadamard H[i][j] =
  // (-1)^popc(i & j): stage 1's A (blockdiag(H, H)) and stage 2's B (H^T)
  const unsigned h = pack_h2(__popc(g & (2 * t)) & 1 ? -1.0f : 1.0f,
                             __popc(g & (2 * t + 1)) & 1 ? -1.0f : 1.0f);
  const bool edge = c_idx == 0 && N < 32;
  for (int mode = warp; mode < 35; mode += kSatdWarps) {
    const bool filt = filter_flag(mode, N, c_idx);
    if (mode >= 2) {
      for (int e = lane; e < nb * NL; e += 32) {
        const int cu = e / NL;
        lines[warp][cu][e % NL] =
            line_at(filt ? f[cu] : s[cu], N, mode, e % NL - N);
      }
      __syncwarp();
    }
    int sum = 0;
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      // the pair of 8x8 blocks (a, b): CU, row and column of each
      int cua, cub, ya, xa, yb, xb;
      if (N == 8) {
        cua = 2 * p;
        cub = 2 * p + 1;
        ya = xa = yb = xb = 0;
      } else if (N == 16) {
        cua = cub = p >> 1;
        ya = yb = (p & 1) * 8;
        xa = 0;
        xb = 8;
      } else {
        cua = cub = 0;
        ya = yb = (p >> 1) * 8;
        xa = (p & 1) * 16;
        xb = xa + 8;
      }
      if (cua >= nb) break;
      if (cub >= nb) cub = cua;   // a lone last CU at n 8: b discarded
      float d[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int cu = q < 2 ? cua : cub;
        const int y = (q < 2 ? ya : yb) + 2 * t + (q & 1);
        const int x = (q < 2 ? xa : xb) + g;
        const int pr = sample<N, BD>(mode, edge, s[cu], filt ? f[cu] : s[cu],
                                     lines[warp][cu] + N, dcs[cu], y, x);
        d[q] = (float)(src[cu][y * P + x] - pr);
      }
      float c1[4], r[4];
      mma_k16(c1, h, 0u, 0u, h, pack_h2(d[0], d[1]), pack_h2(d[2], d[3]));
      if (BD == 8) {
        mma_k8(r, pack_h2(c1[0], c1[1]), pack_h2(c1[2], c1[3]), h);
      } else {
        float hi[4], lo[4], rh[4], rl[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          hi[j] = floorf(c1[j] * 0.015625f);
          lo[j] = c1[j] - 64.0f * hi[j];
        }
        mma_k8(rh, pack_h2(hi[0], hi[1]), pack_h2(hi[2], hi[3]), h);
        mma_k8(rl, pack_h2(lo[0], lo[1]), pack_h2(lo[2], lo[3]), h);
#pragma unroll
        for (int j = 0; j < 4; ++j) r[j] = 64.0f * rh[j] + rl[j];
      }
      const int sa = __reduce_add_sync(
          kFull, __float2int_rn(fabsf(r[0]) + fabsf(r[1])));
      const int sb = __reduce_add_sync(
          kFull, __float2int_rn(fabsf(r[2]) + fabsf(r[3])));
      const int ra = (sa + 2) >> 2, rb = (sb + 2) >> 2;
      if (N == 8) {
        if (lane == 0) {
          out[(size_t)(b0 + cua) * 35 + mode] = ra;
          if (cub != cua) out[(size_t)(b0 + cub) * 35 + mode] = rb;
        }
      } else {
        sum += ra + rb;
        if (N == 16 && (p & 1)) {
          if (lane == 0) out[(size_t)(b0 + cua) * 35 + mode] = sum;
          sum = 0;
        }
      }
    }
    if (N == 32 && lane == 0) out[(size_t)b0 * 35 + mode] = sum;
    __syncwarp();   // the lines are rebuilt for the next mode
  }
}

template <int N, int BD>
__global__ void __launch_bounds__(32 * kPredWarps)
    predict_kernel(const int32_t* top_raw, const int32_t* left_raw,
                   const int32_t* corner_raw, const uint8_t* av_top,
                   const uint8_t* av_left, const uint8_t* av_corner,
                   const int32_t* __restrict__ modes,
                   int32_t* __restrict__ out, int B, int K, int c_idx) {
  constexpr int M = 4 * N + 1, NL = 3 * N + 2, CPB = pred_cus<N>();
  constexpr int G = N == 8 ? 2 : 1;   // CUs of one warp item
  constexpr int LANES = 32 / G;       // lanes of one CU in an item
  __shared__ int s[CPB][M], f[CPB][M], dcs[CPB];
  __shared__ int lines[kPredWarps][G][NL];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b0 = blockIdx.x * CPB;
  const int nb = min(CPB, B - b0);
  for (int cu = warp; cu < nb; cu += kPredWarps)
    warp_refs<N, BD>(top_raw, left_raw, corner_raw, av_top, av_left,
                     av_corner, b0 + cu, s[cu], f[cu], &dcs[cu], lane);
  __syncthreads();

  const bool edge = c_idx == 0 && N < 32;
  const int items = (nb + G - 1) / G * K;
  const int hh = G == 2 ? lane / LANES : 0;
  const int li = lane % LANES;
  for (int it = warp; it < items; it += kPredWarps) {
    const int q = it / K, k = it % K;
    for (int e = lane; e < G * NL; e += 32) {
      const int cu = q * G + e / NL;
      if (cu < nb) {
        const int mode = modes[(size_t)(b0 + cu) * K + k];
        if (mode >= 2)
          lines[warp][e / NL][e % NL] = line_at(
              filter_flag(mode, N, c_idx) ? f[cu] : s[cu], N, mode,
              e % NL - N);
      }
    }
    __syncwarp();
    const int cu = q * G + hh;
    if (cu < nb) {
      const int mode = modes[(size_t)(b0 + cu) * K + k];
      const int* R = filter_flag(mode, N, c_idx) ? f[cu] : s[cu];
      const int* L = lines[warp][hh] + N;
      int32_t* o = out + ((size_t)(b0 + cu) * K + k) * N * N;
      for (int pos = 4 * li; pos < N * N; pos += 4 * LANES) {
        const int y = pos / N, x = pos % N;
        int4 v;
        v.x = sample<N, BD>(mode, edge, s[cu], R, L, dcs[cu], y, x);
        v.y = sample<N, BD>(mode, edge, s[cu], R, L, dcs[cu], y, x + 1);
        v.z = sample<N, BD>(mode, edge, s[cu], R, L, dcs[cu], y, x + 2);
        v.w = sample<N, BD>(mode, edge, s[cu], R, L, dcs[cu], y, x + 3);
        __stcs(reinterpret_cast<int4*>(o + pos), v);
      }
    }
    __syncwarp();   // the lines are rebuilt for the next item
  }
}

template <int N, int BD>
void satd35_launch(const int32_t* orig, const int32_t* top_raw,
                   const int32_t* left_raw, const int32_t* corner_raw,
                   const uint8_t* av_top, const uint8_t* av_left,
                   const uint8_t* av_corner, int32_t* out, int B, int c_idx,
                   cudaStream_t stream) {
  constexpr int CPB = satd_cus<N>();
  satd35_kernel<N, BD><<<(B + CPB - 1) / CPB, 32 * kSatdWarps, 0, stream>>>(
      orig, top_raw, left_raw, corner_raw, av_top, av_left, av_corner, out,
      B, c_idx);
}

template <int N, int BD>
void predict_launch(const int32_t* top_raw, const int32_t* left_raw,
                    const int32_t* corner_raw, const uint8_t* av_top,
                    const uint8_t* av_left, const uint8_t* av_corner,
                    const int32_t* modes, int32_t* out, int B, int K,
                    int c_idx, cudaStream_t stream) {
  constexpr int CPB = pred_cus<N>();
  predict_kernel<N, BD><<<(B + CPB - 1) / CPB, 32 * kPredWarps, 0,
                          stream>>>(top_raw, left_raw, corner_raw, av_top,
                                    av_left, av_corner, modes, out, B, K,
                                    c_idx);
}

template <int BD>
void satd35_n(int n, const int32_t* orig, const int32_t* top_raw,
              const int32_t* left_raw, const int32_t* corner_raw,
              const uint8_t* av_top, const uint8_t* av_left,
              const uint8_t* av_corner, int32_t* out, int B, int c_idx,
              cudaStream_t stream) {
  if (n == 8)
    satd35_launch<8, BD>(orig, top_raw, left_raw, corner_raw, av_top,
                         av_left, av_corner, out, B, c_idx, stream);
  else if (n == 16)
    satd35_launch<16, BD>(orig, top_raw, left_raw, corner_raw, av_top,
                          av_left, av_corner, out, B, c_idx, stream);
  else
    satd35_launch<32, BD>(orig, top_raw, left_raw, corner_raw, av_top,
                          av_left, av_corner, out, B, c_idx, stream);
}

template <int BD>
void predict_n(int n, const int32_t* top_raw, const int32_t* left_raw,
               const int32_t* corner_raw, const uint8_t* av_top,
               const uint8_t* av_left, const uint8_t* av_corner,
               const int32_t* modes, int32_t* out, int B, int K, int c_idx,
               cudaStream_t stream) {
  if (n == 8)
    predict_launch<8, BD>(top_raw, left_raw, corner_raw, av_top, av_left,
                          av_corner, modes, out, B, K, c_idx, stream);
  else if (n == 16)
    predict_launch<16, BD>(top_raw, left_raw, corner_raw, av_top, av_left,
                           av_corner, modes, out, B, K, c_idx, stream);
  else
    predict_launch<32, BD>(top_raw, left_raw, corner_raw, av_top, av_left,
                           av_corner, modes, out, B, K, c_idx, stream);
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
    satd35_n<8>(n, orig, top_raw, left_raw, corner_raw, av_top, av_left,
                av_corner, out, B, c_idx, stream);
  else
    satd35_n<10>(n, orig, top_raw, left_raw, corner_raw, av_top, av_left,
                 av_corner, out, B, c_idx, stream);
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
    predict_n<8>(n, top_raw, left_raw, corner_raw, av_top, av_left,
                 av_corner, modes, out, B, K, c_idx, stream);
  else
    predict_n<10>(n, top_raw, left_raw, corner_raw, av_top, av_left,
                  av_corner, modes, out, B, K, c_idx, stream);
  return (int)cudaGetLastError();
}
