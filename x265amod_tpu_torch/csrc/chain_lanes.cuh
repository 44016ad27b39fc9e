// The residual chain of one n x n block coded by n lanes of a warp, lane l
// owning line l: K2 (`residual_chain.cu`) runs one block per group of n
// lanes, several blocks to a thread block; K23 (`intra16_scan.cu`) one
// intra mode per group; K20 (`commit_intra.cu`) one block at a time by its
// thread block's first n lanes.  Stage for stage: forward DCT, quant
// (intra 171 or inter 85 rounding), the RDOQ stage, sign-bit hiding,
// dequant, inverse DCT, + prediction, clip to the bit depth, and the SSD
// (JAX ops/transforms.py, ops/quant.py, ops/rdoq.py, ops/sbh.py).
//
// Layout: each 1-D pass is a partial butterfly over one line held in
// registers (x265's partialButterfly: the even half recursively, the odd
// half a product with the odd rows of the matrix, whose coefficients are
// __constant__ and become operands once the loops unroll).  Every sum is
// the int32 sum of the matrix product regrouped, so the result is the same
// integer; an n-point pass takes 22, 86 or 342 multiplies for n 8, 16
// and 32 instead of n^2.  Between the row and the column passes the lines
// cross through one padded n x (n + 1) int32 tile in shared memory
// (conflict-free both ways), the only shared memory a block needs besides
// RDOQ's unrounded levels.  Quant, the per-coefficient RDOQ choice and the
// unrounded level are formed in the column pass's registers; the RDOQ group
// decision and sign hiding run one 4x4 group per lane; dequant is fused
// into the inverse column pass and the clip and SSD into the inverse row
// pass.  Lanes of one group meet only at __syncwarp(mask), so groups of 8
// or 16 lanes share a warp without waiting for each other.  Built with
// --fmad=false like intra_chain.cuh (RDOQ's f32 order).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "intra_chain.cuh"

namespace chain_lanes {

using namespace intra_chain;

// kOddN[i][k] = T_N[2i + 1][k], k < N/2: the odd rows of the N-point DCT
// matrix (spec 8.6.4.2); the even rows are the N/2-point matrix, mirrored.
__constant__ int kOdd2[1][1] = {{64}};
__constant__ int kOdd4[2][2] = {{83, 36}, {36, -83}};
__constant__ int kOdd8[4][4] = {
    {89, 75, 50, 18},
    {75, -18, -89, -50},
    {50, -89, 18, 75},
    {18, -50, 75, -89},
};
__constant__ int kOdd16[8][8] = {
    {90, 87, 80, 70, 57, 43, 25, 9},
    {87, 57, 9, -43, -80, -90, -70, -25},
    {80, 9, -70, -87, -25, 57, 90, 43},
    {70, -43, -87, 9, 90, 25, -80, -57},
    {57, -80, -25, 90, -9, -87, 43, 70},
    {43, -90, 57, 25, -87, 70, 9, -80},
    {25, -70, 90, -80, 43, 9, -57, 87},
    {9, -25, 43, -57, 70, -80, 87, -90},
};
__constant__ int kOdd32[16][16] = {
    {90, 90, 88, 85, 82, 78, 73, 67, 61, 54, 46, 38, 31, 22, 13, 4},
    {90, 82, 67, 46, 22, -4, -31, -54, -73, -85, -90, -88, -78, -61, -38,
     -13},
    {88, 67, 31, -13, -54, -82, -90, -78, -46, -4, 38, 73, 90, 85, 61, 22},
    {85, 46, -13, -67, -90, -73, -22, 38, 82, 88, 54, -4, -61, -90, -78,
     -31},
    {82, 22, -54, -90, -61, 13, 78, 85, 31, -46, -90, -67, 4, 73, 88, 38},
    {78, -4, -82, -73, 13, 85, 67, -22, -88, -61, 31, 90, 54, -38, -90,
     -46},
    {73, -31, -90, -22, 78, 67, -38, -90, -13, 82, 61, -46, -88, -4, 85,
     54},
    {67, -54, -78, 38, 85, -22, -90, 4, 90, 13, -88, -31, 82, 46, -73, -61},
    {61, -73, -46, 82, 31, -88, -13, 90, -4, -90, 22, 85, -38, -78, 54, 67},
    {54, -85, -4, 88, -46, -61, 82, 13, -90, 38, 67, -78, -22, 90, -31,
     -73},
    {46, -90, 38, 54, -90, 31, 61, -88, 22, 67, -85, 13, 73, -82, 4, 78},
    {38, -88, 73, -4, -67, 90, -46, -31, 85, -78, 13, 61, -90, 54, 22, -82},
    {31, -78, 90, -61, 4, 54, -88, 82, -38, -22, 73, -90, 67, -13, -46, 85},
    {22, -61, 85, -90, 73, -38, -4, 46, -78, 90, -82, 54, -13, -31, 67,
     -88},
    {13, -38, 61, -78, 88, -90, 85, -73, 54, -31, 4, 22, -46, 67, -82, 90},
    {4, -13, 22, -31, 38, -46, 54, -61, 67, -73, 78, -82, 85, -88, 90, -90},
};

template <int N>
__device__ __forceinline__ int odd_coef(int i, int k) {
  if constexpr (N == 2) return kOdd2[i][k];
  else if constexpr (N == 4) return kOdd4[i][k];
  else if constexpr (N == 8) return kOdd8[i][k];
  else if constexpr (N == 16) return kOdd16[i][k];
  else return kOdd32[i][k];
}

// y[k] = sum_j T_N[k][j] x[j]
template <int N>
__device__ __forceinline__ void fwd1d(const int* x, int* y) {
  if constexpr (N == 1) {
    y[0] = 64 * x[0];
  } else {
    constexpr int H = N / 2;
    int e[H], o[H], ye[H];
#pragma unroll
    for (int k = 0; k < H; ++k) {
      e[k] = x[k] + x[N - 1 - k];
      o[k] = x[k] - x[N - 1 - k];
    }
    fwd1d<H>(e, ye);
#pragma unroll
    for (int i = 0; i < H; ++i) {
      int acc = 0;
#pragma unroll
      for (int k = 0; k < H; ++k) acc += odd_coef<N>(i, k) * o[k];
      y[2 * i] = ye[i];
      y[2 * i + 1] = acc;
    }
  }
}

// y[j] = sum_k T_N[k][j] c[k]
template <int N>
__device__ __forceinline__ void inv1d(const int* c, int* y) {
  if constexpr (N == 1) {
    y[0] = 64 * c[0];
  } else {
    constexpr int H = N / 2;
    int ce[H], e[H];
#pragma unroll
    for (int i = 0; i < H; ++i) ce[i] = c[2 * i];
    inv1d<H>(ce, e);
#pragma unroll
    for (int j = 0; j < H; ++j) {
      int o = 0;
#pragma unroll
      for (int i = 0; i < H; ++i) o += odd_coef<N>(i, j) * c[2 * i + 1];
      y[j] = e[j] + o;
      y[N - 1 - j] = e[j] - o;
    }
  }
}

// The RDOQ group decision (zero the 4x4 group when j_zero < j_code, sums in
// XLA's order) and then sign-bit hiding, on group g of the levels A and
// unrounded levels Q (row stride P), one group at a time: each reads and
// writes its own 16 coefficients.
template <int N, bool RDOQ>
__device__ __forceinline__ void group_rdoq_sbh(int* A, const float* Q, int P,
                                               int g, const RdoqRow& t,
                                               int sbh) {
  constexpr int g4 = N / 4;
  const int gy = g / g4, gx = g % g4;
  const int base = gy * 4 * P + gx * 4;
  if (RDOQ) {
    float dsq[16], zsq[16], rr[16];
    bool nz = false;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int idx = base + (k >> 2) * P + (k & 3);
      const int l = abs(A[idx]);
      const float q = Q[idx];
      const float d = __fsub_rn(q, (float)l);
      dsq[k] = __fmul_rn(d, d);
      zsq[k] = __fmul_rn(q, q);
      rr[k] = level_rate(t, l);
      nz |= l > 0;
    }
    if (nz) {
      float ld[8], lr[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        ld[k] = __fmaf_rn(t.step, dsq[k + 8], __fmul_rn(t.step, dsq[k]));
        lr[k] = __fadd_rn(rr[k], rr[k + 8]);
      }
      const float d_code = lanes_tree(ld);
      const float r_code = lanes_tree(lr);
      float d_zero = __fmul_rn(t.step, zsq[0]);
#pragma unroll
      for (int k = 1; k < 16; ++k)
        d_zero = __fmaf_rn(t.step, zsq[k], d_zero);
      const float j_code =
          __fmaf_rn(t.lam, __fadd_rn(r_code, t.csb1), d_code);
      const float j_zero = __fadd_rn(d_zero, __fmul_rn(t.lam, t.csb0));
      if (j_zero < j_code) {
#pragma unroll
        for (int k = 0; k < 16; ++k) A[base + (k >> 2) * P + (k & 3)] = 0;
      }
    }
  }
  if (sbh) {
    int first = 16, last = -1, first_v = 0, last_i = 0, sum = 0;
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int idx = base + (q >> 2) * P + (q & 3);
      const int v = A[idx];
      if (v != 0) {
        const int ps = kDiagPos[q];
        if (ps < first) { first = ps; first_v = v; }
        if (ps > last) { last = ps; last_i = idx; }
        sum += abs(v);
      }
    }
    if (last - first > 3 && (sum & 1) != (first_v < 0 ? 1 : 0)) {
      const int v = A[last_i];
      const int sg = v > 0 ? 1 : -1;
      A[last_i] = v + (abs(v) >= 2 ? -sg : sg);
    }
  }
}

// The chain of one N x N block by the N lanes of a group (lane l = line l,
// `mask` the group's lanes; every lane of the group must call it).
//   S: the group's int tile [N * (N + 1)] in shared memory; Q: its float
//   tile of unrounded levels (RDOQ only);
//   resid_row(l, v): v[x] = orig - pred of row l;
//   pred_row(l, p), orig_row(l, o): row l of the prediction and source;
//   level_out(u, x, v): the level at (u, x), called by lane x for every u
//   (lanes of a group write one row together);
//   recon_row(y, r): row y of the reconstruction, called by lane y.
// Returns the block's SSD in every lane of the group.  rdoq: K2's row at
// the block's QP (ignored without RDOQ).
template <int N, int BD, bool RDOQ, class Resid, class PredRow,
          class OrigRow, class LevelOut, class ReconRow>
__device__ __forceinline__ int group_chain(
    int l, unsigned mask, int* S, float* Q, int qp, int sbh, int intra,
    const RdoqRow& rdoq, Resid resid_row, PredRow pred_row,
    OrigRow orig_row, LevelOut level_out, ReconRow recon_row) {
  constexpr int P = N + 1;
  constexpr int LOG2N = N == 8 ? 3 : (N == 16 ? 4 : 5);
  int v[N], w[N];
  // forward rows: tmp[y][u] = rs(sum_x resi[y][x] T[u][x], log2n + bd - 9)
  resid_row(l, v);
  fwd1d<N>(v, w);
#pragma unroll
  for (int u = 0; u < N; ++u)
    S[l * P + u] = round_shift(w[u], LOG2N + BD - 9);
  __syncwarp(mask);
  // forward columns: coeff[u][k] = rs(sum_y T[u][y] tmp[y][k], log2n + 6),
  // then quant and RDOQ's per-coefficient choice, in registers
#pragma unroll
  for (int y = 0; y < N; ++y) v[y] = S[y * P + l];
  fwd1d<N>(v, w);
  const int qs = kQuantScale[qp % 6];
  const int qbits = 14 + qp / 6 + 15 - BD - LOG2N;
  const long long qoff = (long long)(intra ? 171 : 85) << (qbits - 9);
  // RDOQ's unrounded level uses the 8-bit shift (JAX ops/rdoq.py:106)
  const float q_div = (float)(1 << (14 + qp / 6 + 15 - 8 - LOG2N));
  __syncwarp(mask);
#pragma unroll
  for (int u = 0; u < N; ++u) {
    const int c = round_shift(w[u], LOG2N + 6);
    const long long mag = ((long long)abs(c) * qs + qoff) >> qbits;
    int lv = clip16(c < 0 ? -mag : (c > 0 ? mag : 0));
    if (RDOQ) {
      const float q = __fdiv_rn(__fmul_rn((float)abs(c), (float)qs), q_div);
      const int a = abs(lv);
      if (a > 0 && coeff_cost(rdoq, q, a - 1) < coeff_cost(rdoq, q, a))
        lv = lv > 0 ? a - 1 : 1 - a;
      Q[u * P + l] = q;
    }
    S[u * P + l] = lv;
  }
  __syncwarp(mask);
  // RDOQ's group decision and sign hiding, a 4x4 group per lane
  if (RDOQ || sbh) {
    for (int g = l; g < (N / 4) * (N / 4); g += N)
      group_rdoq_sbh<N, RDOQ>(S, Q, P, g, rdoq, sbh);
    __syncwarp(mask);
  }
  // levels out; dequant (spec 8.6.3, m = 16) and the inverse columns:
  // g[y][x] = clip16(rs(sum_k T[k][y] coeff[k][x], 7))
  {
    const int bd_shift = BD + LOG2N - 5;
    const long long scale = (long long)(kInvQuantScale[qp % 6] * 16)
                            << (qp / 6);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int lv = S[k * P + l];
      level_out(k, l, lv);
      v[k] = clip16(((long long)lv * scale + (1 << (bd_shift - 1))) >>
                    bd_shift);
    }
  }
  inv1d<N>(v, w);
  __syncwarp(mask);
#pragma unroll
  for (int y = 0; y < N; ++y) S[y * P + l] = clip16(round_shift(w[y], 7));
  __syncwarp(mask);
  // inverse rows: r[y][x] = clip16(rs(sum_u g[y][u] T[u][x], 20 - bd)),
  // + pred, clip; the SSD
#pragma unroll
  for (int u = 0; u < N; ++u) v[u] = S[l * P + u];
  inv1d<N>(v, w);
  pred_row(l, v);
  constexpr int kMaxV = (1 << BD) - 1;
#pragma unroll
  for (int x = 0; x < N; ++x) {
    const int r = v[x] + clip16(round_shift(w[x], 20 - BD));
    w[x] = r < 0 ? 0 : (r > kMaxV ? kMaxV : r);
  }
  recon_row(l, w);
  orig_row(l, v);
  int ssd = 0;
#pragma unroll
  for (int x = 0; x < N; ++x) ssd += (w[x] - v[x]) * (w[x] - v[x]);
#pragma unroll
  for (int o = N / 2; o; o >>= 1) ssd += __shfl_xor_sync(mask, ssd, o);
  __syncwarp(mask);
  return ssd;
}

// The mask of the group of N lanes that holds this thread.
template <int N>
__device__ __forceinline__ unsigned group_mask() {
  const unsigned lane = threadIdx.x & 31;
  return N == 32 ? 0xffffffffu : (((1u << N) - 1) << (lane & ~(N - 1)));
}

}  // namespace chain_lanes
