// Device functions of the intra chain, shared by K1 (`intra_pred.cu`), K20
// (`commit_intra.cu`), K23 (`intra16_scan.cu`) and, through
// chain_lanes.cuh, K2 (`residual_chain.cu`): the angle tables, the serial
// reference substitution (spec 8.4.4.2.2; K1 runs its own, a warp's
// segmented fill), the [1 2 1] smoothing, an angular mode's reference
// line and the prediction sample of every intra mode, one copy for K1,
// K20 and K23 (JAX ops/intra.py substitute_refs_general,
// predict_modes_batch), and
// the residual chain's tables and scalar steps: quant and dequant scales,
// rounding shifts, and the RDOQ stage's rate and cost (JAX ops/quant.py,
// ops/rdoq.py, ops/sbh.py).  The chain itself is chain_lanes.cuh's
// `group_chain`.  Header only; each kernel is its own library.  The RDOQ
// arithmetic is XLA's f32 order operation for operation (every product and
// sum an _rn intrinsic, __fmaf_rn where XLA fuses), so the files that
// include this build with --fmad=false.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace intra_chain {

// ---- K1: references and prediction ------------------------------------

__constant__ int kAngle[35] = {
    0, 0, 32, 26, 21, 17, 13, 9, 5, 2, 0, -2, -5, -9, -13, -17, -21, -26,
    -32, -26, -21, -17, -13, -9, -5, -2, 0, 2, 5, 9, 13, 17, 21, 26, 32};
__constant__ int kInvAngle[35] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, -4096, -1638, -910, -630, -482, -390,
    -315, -256, -315, -390, -482, -630, -910, -1638, -4096, 0, 0, 0, 0, 0,
    0, 0, 0, 0};

constexpr int kMaxN = 32;
constexpr int kMaxSeq = 4 * kMaxN + 1;   // left(2n) + corner + top(2n)

// Reference scan layout (spec 8.4.4.2.2): seq[0 .. 2n-1] = left[2n-1 .. 0],
// seq[2n] = corner, seq[2n+1 .. 4n] = top[0 .. 2n-1].
struct RefView {
  const int* s;   // substituted (unfiltered) scan
  const int* f;   // [1 2 1]-filtered scan
  int n;
};

__device__ __forceinline__ int top_at(const int* s, int n, int i) {
  return s[2 * n + 1 + i];
}
__device__ __forceinline__ int left_at(const int* s, int n, int i) {
  return s[2 * n - 1 - i];
}

__device__ __forceinline__ bool filter_flag(int mode, int n, int c_idx) {
  if (c_idx != 0 || n == 4) return false;
  if (mode == 1) return false;
  if (mode == 0) return true;
  int d26 = abs(mode - 26), d10 = abs(mode - 10);
  int md = d26 < d10 ? d26 : d10;
  int thres = n == 8 ? 7 : (n == 16 ? 1 : 0);
  return md > thres;
}

// Spec 8.4.4.2.2 substitution of the reference scan s[0 .. 4n] whose
// availability (0 / 1) is in f, by one thread, sequentially, exactly as the
// spec: an unavailable sample takes the previous one, a leading run the
// first available one, nothing available mid-grey 1 << (bd - 1).
template <int BD>
__device__ void substitute_serial(int* s, const int* f, int n) {
  const int m = 4 * n + 1;
  int first = -1;
  for (int i = 0; i < m && first < 0; ++i)
    if (f[i]) first = i;
  if (first < 0) {
    for (int i = 0; i < m; ++i) s[i] = 1 << (BD - 1);
  } else {
    int prev = s[first];   // a leading run takes the first sample
    for (int i = 0; i < m; ++i) {
      if (!f[i]) s[i] = prev;
      prev = s[i];
    }
  }
}

// The [1 2 1] smoothing of the substituted scan s into f, entry i.
__device__ __forceinline__ int smooth_121(const int* s, int m, int i) {
  return (i == 0 || i == m - 1) ? s[i]
                                : (s[i - 1] + 2 * s[i] + s[i + 1] + 2) >> 2;
}

// Entry i in [-n, 2n + 1] of an angular mode's reference line (spec
// 8.4.4.2.6): the corner at 0, the main side from 1 on (its last sample
// repeated past 2n), the other side projected through the inverse angle
// below 0.  R is the scan the mode reads (filtered or not).
__device__ __forceinline__ int line_at(const int* R, int n, int mode, int i) {
  const bool vertical = mode >= 18;
  if (i == 0) return R[2 * n];
  if (i >= 1) {
    const int t = i <= 2 * n ? i - 1 : 2 * n - 1;
    return vertical ? top_at(R, n, t) : left_at(R, n, t);
  }
  int e = ((i * kInvAngle[mode] + 128) >> 8) - 1;
  if (e < 0) return R[2 * n];
  if (e > 2 * n - 1) e = 2 * n - 1;
  return vertical ? left_at(R, n, e) : top_at(R, n, e);
}

// The prediction arithmetic, one copy for K1, K20 and K23, in parts, so
// that a kernel whose mode is fixed over a loop calls one part in it and
// composes the angular parts in the order its code runs fastest (K23's
// rows: the two taps, then the edge filters as overrides; K1: the edge
// filters as early returns, `angular_at`; each order measured faster on
// its kernel).  u is the substituted (unfiltered) scan, R the scan the
// mode reads, dc the DC value of u, edge the DC and mode 10/26 edge
// filters (luma below n 32), clipped to (1 << BD) - 1.

// Planar (mode 0) sample (y, x).
__device__ __forceinline__ int planar_at(const int* R, int n, int log2n,
                                         int y, int x) {
  return ((n - 1 - x) * left_at(R, n, y) + (x + 1) * top_at(R, n, n) +
          (n - 1 - y) * top_at(R, n, x) + (y + 1) * left_at(R, n, n) + n) >>
         (log2n + 1);
}

// DC (mode 1) sample (y, x).
__device__ __forceinline__ int dc_at(const int* u, int dc, int n, bool edge,
                                     int y, int x) {
  int v = dc;
  if (edge) {
    if (x == 0 && y == 0)
      v = (left_at(u, n, 0) + 2 * dc + top_at(u, n, 0) + 2) >> 2;
    else if (y == 0)
      v = (top_at(u, n, x) + 3 * dc + 2) >> 2;
    else if (x == 0)
      v = (left_at(u, n, y) + 3 * dc + 2) >> 2;
  }
  return v;
}

// v clipped to [0, (1 << BD) - 1]
template <int BD>
__device__ __forceinline__ int clip_bd(int v) {
  return v < 0 ? 0 : (v > (1 << BD) - 1 ? (1 << BD) - 1 : v);
}

// The edge filter of mode 26 at (y, 0) and of mode 10 at (0, x).
template <int BD>
__device__ __forceinline__ int edge26_at(const int* u, int n, int y) {
  return clip_bd<BD>(top_at(u, n, 0) + ((left_at(u, n, y) - u[2 * n]) >> 1));
}
template <int BD>
__device__ __forceinline__ int edge10_at(const int* u, int n, int x) {
  return clip_bd<BD>(left_at(u, n, 0) + ((top_at(u, n, x) - u[2 * n]) >> 1));
}

// Angular (mode >= 2) sample (y, x) before the edge filters: two taps of
// the mode's reference line L(i), i in [-n, 2n + 1] (line_at, or a copy).
template <class Line>
__device__ __forceinline__ int taps_at(int mode, const Line& L, int y,
                                       int x) {
  const bool vertical = mode >= 18;
  const int k = vertical ? y : x;
  const int j = vertical ? x : y;
  const int pos = (k + 1) * kAngle[mode];
  const int fr = pos & 31;
  const int i0 = (pos >> 5) + 1 + j;
  return ((32 - fr) * L(i0) + fr * L(i0 + 1) + 16) >> 5;
}

// Angular (mode >= 2) sample (y, x).
template <int BD, class Line>
__device__ __forceinline__ int angular_at(int mode, bool edge, const int* u,
                                          const Line& L, int n, int y,
                                          int x) {
  if (edge && mode == 26 && x == 0) return edge26_at<BD>(u, n, y);
  if (edge && mode == 10 && y == 0) return edge10_at<BD>(u, n, x);
  return taps_at(mode, L, y, x);
}

// Sample (y, x) of any mode.
template <int BD, class Line>
__device__ __forceinline__ int sample_at(int mode, bool edge, const int* u,
                                         const int* R, const Line& L, int dc,
                                         int n, int log2n, int y, int x) {
  if (mode == 0) return planar_at(R, n, log2n, y, x);
  if (mode == 1) return dc_at(u, dc, n, edge, y, x);
  return angular_at<BD>(mode, edge, u, L, n, y, x);
}

// Sample (y, x) of mode `mode` straight from the scans (the line entries
// it reads computed in place); dc is the DC value of the unfiltered refs.
template <int BD>
__device__ __forceinline__ int pred_sample(const RefView& r, int mode,
                                           int c_idx, int log2n, int dc,
                                           int y, int x) {
  const int n = r.n;
  const int* R = filter_flag(mode, n, c_idx) ? r.f : r.s;
  return sample_at<BD>(
      mode, c_idx == 0 && n < 32, r.s, R,
      [&](int i) { return line_at(R, n, mode, i); }, dc, n, log2n, y, x);
}

__device__ __forceinline__ int dc_value(const int* s, int n, int log2n) {
  int acc = 0;
  for (int i = 0; i < n; ++i) acc += top_at(s, n, i) + left_at(s, n, i);
  return (acc + n) >> (log2n + 1);
}

// ---- the residual chain's tables and scalar steps ------------------------

__constant__ int kQuantScale[6] = {26214, 23302, 20560, 18396, 16384,
                                   14564};
__constant__ int kInvQuantScale[6] = {40, 45, 51, 57, 64, 72};
// (y * 4 + x) -> position in the 4x4 up-right diagonal scan
__constant__ int kDiagPos[16] = {0, 2, 5, 9, 1, 4, 8, 12,
                                 3, 7, 11, 14, 6, 10, 13, 15};

__device__ __forceinline__ int round_shift(int x, int s) {
  return (x + (1 << (s - 1))) >> s;
}

__device__ __forceinline__ int clip16(long long v) {
  return v < -32768 ? -32768 : (v > 32767 ? 32767 : (int)v);
}

// floor(log2(x)) for 1 <= x <= 32762 as XLA's f32 log2 gives it: 8192
// comes out one low (ops/rdoq.py XLA_LOG2_LOW)
__device__ __forceinline__ int floor_log2_xla(int x) {
  return (31 - __clz(x)) - (x == 8192 ? 1 : 0);
}

// The row of the RDOQ table at one QP (ops/rdoq.py kernel_table).
struct RdoqRow {
  float step, r0, r1, r2, r3, csb0, csb1, lam;
};

// JAX _rate: bits of level l >= 0
__device__ __forceinline__ float level_rate(const RdoqRow& t, int l) {
  if (l == 0) return t.r0;
  if (l == 1) return t.r1;
  if (l == 2) return t.r2;
  const int rem = l - 3;
  float g = 0.0f;
  if (rem > 0) {
    const float pref = (float)(rem < 3 ? rem : 3) + 1.0f;
    const float esc =
        rem >= 3 ? 2.0f * ((float)floor_log2_xla(rem - 2) + 1.0f) : 0.0f;
    g = __fadd_rn(pref, esc);
  }
  return __fadd_rn(t.r3, g);
}

// ((L0 + L4) + (L2 + L6)) + ((L1 + L5) + (L3 + L7)): XLA's halving tree
// over eight lanes
__device__ __forceinline__ float lanes_tree(const float* v) {
  return __fadd_rn(__fadd_rn(__fadd_rn(v[0], v[4]), __fadd_rn(v[2], v[6])),
                   __fadd_rn(__fadd_rn(v[1], v[5]), __fadd_rn(v[3], v[7])));
}

// fma(step, (q - l)^2, lam * R(l))
__device__ __forceinline__ float coeff_cost(const RdoqRow& t, float q,
                                            int l) {
  const float d = __fsub_rn(q, (float)l);
  return __fmaf_rn(t.step, __fmul_rn(d, d),
                   __fmul_rn(t.lam, level_rate(t, l)));
}

}  // namespace intra_chain
