// Kernel K4 `deblock`: the HEVC deblocking filter of the all-intra CTU32
// tree (spec 8.7.2.5): the luma filter with per-edge bS (1 or 2) and QP,
// and the chroma filter on bS == 2 edges, over a batch of F frames.
// Vertical edges are filtered first, then horizontal (the normative
// order), as two launches on the caller's stream.
//
// Replaces, from the JAX package: ops/deblock.py deblock_luma_bs and
// deblock_chroma_bs (which gather every edge window into a dense tensor,
// filter it and scatter it back).
//
// Entry points (plain C, in place on an int32 plane, return
// cudaGetLastError()):
//   deblock_luma(plane [F,H,W], bs_v [F,H/16,W/16-1], bs_h [F,H/16-1,W/16],
//                qp_v, qp_h (same shapes as bs_v, bs_h), F, H, W)
//   deblock_chroma(plane [F,Hc,Wc], bs_v, bs_h, qpc_v, qpc_h, F, Hc, Wc)
//     (bs/qp maps on the luma 16-grid; qpc_* already chroma-mapped)
//
// What bounds it on an H100: bytes.  Each edge segment reads and writes
// a few samples with a handful of compares; one thread owns one 4-line
// luma segment (or one chroma line) of one edge, reads its 8 (4) samples
// straight from the plane and writes back only the samples it changes.
// Edges 16 (8) samples apart never share a sample, so no thread waits on
// another within a pass.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__constant__ int kBeta[52] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 6, 7, 8, 9, 10, 11,
    12, 13, 14, 15, 16, 17, 18, 20, 22, 24, 26, 28, 30, 32, 34, 36, 38,
    40, 42, 44, 46, 48, 50, 52, 54, 56, 58, 60, 62, 64};
__constant__ int kTc[54] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 5, 5, 6, 6, 7, 8,
    9, 10, 11, 13, 14, 16, 18, 20, 22, 24};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// One 4-line luma segment.  px(i, t): sample of line i at tap t, where
// taps 0..3 are p3, p2, p1, p0 and 4..7 are q0, q1, q2, q3.
template <typename Px>
__device__ void filter_luma_segment(Px px, int beta, int tc) {
  int P[4][4], Q[4][4];   // [line][p0..p3] / [line][q0..q3]
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      P[i][t] = *px(i, 3 - t);
      Q[i][t] = *px(i, 4 + t);
    }
  }
  int dp[4], dq[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    dp[i] = abs(P[i][2] - 2 * P[i][1] + P[i][0]);
    dq[i] = abs(Q[i][2] - 2 * Q[i][1] + Q[i][0]);
  }
  if (!(dp[0] + dq[0] + dp[3] + dq[3] < beta)) return;
  bool strong = true;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int i = j ? 3 : 0;
    strong = strong && (2 * (dp[i] + dq[i]) < (beta >> 2)) &&
             (abs(P[i][3] - P[i][0]) + abs(Q[i][0] - Q[i][3]) <
              (beta >> 3)) &&
             (abs(P[i][0] - Q[i][0]) < ((5 * tc + 1) >> 1));
  }
  const int side = (beta + (beta >> 1)) >> 3;
  const bool dep = dp[0] + dp[3] < side;
  const bool deq = dq[0] + dq[3] < side;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p0 = P[i][0], p1 = P[i][1], p2 = P[i][2], p3 = P[i][3];
    const int q0 = Q[i][0], q1 = Q[i][1], q2 = Q[i][2], q3 = Q[i][3];
    if (strong) {
      *px(i, 3) = clampi((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                         p0 - 2 * tc, p0 + 2 * tc);
      *px(i, 2) = clampi((p2 + p1 + p0 + q0 + 2) >> 2, p1 - 2 * tc,
                         p1 + 2 * tc);
      *px(i, 1) = clampi((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3,
                         p2 - 2 * tc, p2 + 2 * tc);
      *px(i, 4) = clampi((p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3,
                         q0 - 2 * tc, q0 + 2 * tc);
      *px(i, 5) = clampi((p0 + q0 + q1 + q2 + 2) >> 2, q1 - 2 * tc,
                         q1 + 2 * tc);
      *px(i, 6) = clampi((p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3,
                         q2 - 2 * tc, q2 + 2 * tc);
    } else {
      int delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4;
      if (abs(delta) >= tc * 10) continue;
      delta = clampi(delta, -tc, tc);
      *px(i, 3) = clampi(p0 + delta, 0, 255);
      *px(i, 4) = clampi(q0 - delta, 0, 255);
      if (dep) {
        const int d = clampi((((p2 + p0 + 1) >> 1) - p1 + delta) >> 1,
                             -(tc >> 1), tc >> 1);
        *px(i, 2) = clampi(p1 + d, 0, 255);
      }
      if (deq) {
        const int d = clampi((((q2 + q0 + 1) >> 1) - q1 - delta) >> 1,
                             -(tc >> 1), tc >> 1);
        *px(i, 5) = clampi(q1 + d, 0, 255);
      }
    }
  }
}

__device__ __forceinline__ void luma_params(int bs, int qp, int* beta,
                                            int* tc) {
  *beta = kBeta[clampi(qp, 0, 51)];
  *tc = kTc[clampi(qp + 2 * (bs - 1), 0, 53)];
}

// vertical edges: thread = (frame, edge j, 4-row segment s)
__global__ void luma_v(int32_t* plane, const int32_t* bs_v,
                       const int32_t* qp_v, int F, int H, int W) {
  const int ne = W / 16 - 1, nseg = H / 4;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= (long long)F * ne * nseg) return;
  const int s = tid % nseg, j = (tid / nseg) % ne, f = tid / nseg / ne;
  const int m = (f * (H / 16) + s / 4) * ne + j;
  const int bs = bs_v[m];
  if (bs == 0) return;
  int beta, tc;
  luma_params(bs, qp_v[m], &beta, &tc);
  int32_t* base = plane + ((size_t)f * H + 4 * s) * W + 16 * (j + 1) - 4;
  filter_luma_segment(
      [=](int i, int t) { return base + (size_t)i * W + t; }, beta, tc);
}

// horizontal edges: thread = (frame, edge i, 4-column segment s)
__global__ void luma_h(int32_t* plane, const int32_t* bs_h,
                       const int32_t* qp_h, int F, int H, int W) {
  const int ne = H / 16 - 1, nseg = W / 4;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= (long long)F * ne * nseg) return;
  const int s = tid % nseg, e = (tid / nseg) % ne, f = tid / nseg / ne;
  const int m = (f * ne + e) * (W / 16) + s / 4;
  const int bs = bs_h[m];
  if (bs == 0) return;
  int beta, tc;
  luma_params(bs, qp_h[m], &beta, &tc);
  int32_t* base = plane + ((size_t)f * H + 16 * (e + 1) - 4) * W + 4 * s;
  filter_luma_segment(
      [=](int i, int t) { return base + (size_t)t * W + i; }, beta, tc);
}

__device__ __forceinline__ void filter_chroma(int32_t* p1, int32_t* p0,
                                              int32_t* q0, int32_t* q1,
                                              int tc) {
  const int d = clampi((((*q0 - *p0) << 2) + *p1 - *q1 + 4) >> 3, -tc, tc);
  const int np0 = clampi(*p0 + d, 0, 255), nq0 = clampi(*q0 - d, 0, 255);
  *p0 = np0;
  *q0 = nq0;
}

// chroma vertical edges: thread = (frame, edge j, row y)
__global__ void chroma_v(int32_t* plane, const int32_t* bs_v,
                         const int32_t* qpc_v, int F, int H, int W) {
  const int ne = W / 8 - 1;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= (long long)F * ne * H) return;
  const int y = tid % H, j = (tid / H) % ne, f = tid / H / ne;
  const int m = (f * (H / 8) + y / 8) * ne + j;
  if (bs_v[m] != 2) return;
  const int tc = kTc[clampi(qpc_v[m] + 2, 0, 53)];
  int32_t* r = plane + ((size_t)f * H + y) * W + 8 * (j + 1);
  filter_chroma(r - 2, r - 1, r, r + 1, tc);
}

// chroma horizontal edges: thread = (frame, edge i, column x)
__global__ void chroma_h(int32_t* plane, const int32_t* bs_h,
                         const int32_t* qpc_h, int F, int H, int W) {
  const int ne = H / 8 - 1;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= (long long)F * ne * W) return;
  const int x = tid % W, e = (tid / W) % ne, f = tid / W / ne;
  const int m = (f * ne + e) * (W / 8) + x / 8;
  if (bs_h[m] != 2) return;
  const int tc = kTc[clampi(qpc_h[m] + 2, 0, 53)];
  int32_t* c = plane + ((size_t)f * H + 8 * (e + 1)) * W + x;
  filter_chroma(c - 2 * W, c - W, c, c + W, tc);
}

inline unsigned blocks_for(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

}  // namespace

extern "C" int deblock_luma(int32_t* plane, const int32_t* bs_v,
                            const int32_t* bs_h, const int32_t* qp_v,
                            const int32_t* qp_h, int F, int H, int W,
                            cudaStream_t stream) {
  if (H % 16 || W % 16) return (int)cudaErrorInvalidValue;
  const long long nv = (long long)F * (W / 16 - 1) * (H / 4);
  const long long nh = (long long)F * (H / 16 - 1) * (W / 4);
  if (nv > 0)
    luma_v<<<blocks_for(nv, 256), 256, 0, stream>>>(plane, bs_v, qp_v, F,
                                                   H, W);
  if (nh > 0)
    luma_h<<<blocks_for(nh, 256), 256, 0, stream>>>(plane, bs_h, qp_h, F,
                                                   H, W);
  return (int)cudaGetLastError();
}

extern "C" int deblock_chroma(int32_t* plane, const int32_t* bs_v,
                              const int32_t* bs_h, const int32_t* qpc_v,
                              const int32_t* qpc_h, int F, int H, int W,
                              cudaStream_t stream) {
  if (H % 8 || W % 8) return (int)cudaErrorInvalidValue;
  const long long nv = (long long)F * (W / 8 - 1) * H;
  const long long nh = (long long)F * (H / 8 - 1) * W;
  if (nv > 0)
    chroma_v<<<blocks_for(nv, 256), 256, 0, stream>>>(plane, bs_v, qpc_v, F,
                                                     H, W);
  if (nh > 0)
    chroma_h<<<blocks_for(nh, 256), 256, 0, stream>>>(plane, bs_h, qpc_h, F,
                                                     H, W);
  return (int)cudaGetLastError();
}
