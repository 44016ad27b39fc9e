// Device functions of the intra chain, shared by K1 (`intra_pred.cu`), K20
// (`commit_intra.cu`), K23 (`intra16_scan.cu`) and, through
// chain_lanes.cuh, K2 (`residual_chain.cu`): K1's reference substitution
// (spec 8.4.4.2.2), [1 2 1] smoothing and prediction sample of every intra
// mode (JAX ops/intra.py substitute_refs_general, predict_modes_batch), and
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

// The substitution (one thread), then the smoothing (all threads).  Every
// thread of the block must call it.
template <int BD>
__device__ void substitute_smooth(int* s, int* f, int n) {
  const int m = 4 * n + 1;
  if (threadIdx.x == 0) substitute_serial<BD>(s, f, n);
  __syncthreads();
  for (int i = threadIdx.x; i < m; i += blockDim.x)
    f[i] = smooth_121(s, m, i);
  __syncthreads();
}

// Load raw refs of block b from K1's arrays into the scan (s: samples, f:
// availability), then substitute and smooth.
template <int BD>
__device__ void load_refs(const int32_t* top_raw, const int32_t* left_raw,
                          const int32_t* corner_raw, const uint8_t* av_top,
                          const uint8_t* av_left, const uint8_t* av_corner,
                          int b, int n, int* s, int* f) {
  const int m = 4 * n + 1;
  const int32_t* tr = top_raw + (size_t)b * 2 * n;
  const int32_t* lr = left_raw + (size_t)b * 2 * n;
  const uint8_t* at = av_top + (size_t)b * 2 * n;
  const uint8_t* al = av_left + (size_t)b * 2 * n;
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    if (i < 2 * n) {
      f[i] = al[2 * n - 1 - i];
      s[i] = lr[2 * n - 1 - i];
    } else if (i == 2 * n) {
      f[i] = av_corner[b];
      s[i] = corner_raw[b];
    } else {
      f[i] = at[i - 2 * n - 1];
      s[i] = tr[i - 2 * n - 1];
    }
  }
  __syncthreads();
  substitute_smooth<BD>(s, f, n);
}

// Sample (y, x) of mode `mode`; dc is the DC value of the unfiltered refs.
template <int BD>
__device__ __forceinline__ int pred_sample(const RefView& r, int mode,
                                           int c_idx, int log2n, int dc,
                                           int y, int x) {
  const int n = r.n;
  const int* u = r.s;
  const int* R = filter_flag(mode, n, c_idx) ? r.f : r.s;
  const bool edge = c_idx == 0 && n < 32;
  if (mode == 0) {
    return ((n - 1 - x) * left_at(R, n, y) + (x + 1) * top_at(R, n, n) +
            (n - 1 - y) * top_at(R, n, x) + (y + 1) * left_at(R, n, n) +
            n) >> (log2n + 1);
  }
  if (mode == 1) {
    if (edge) {
      if (x == 0 && y == 0)
        return (left_at(u, n, 0) + 2 * dc + top_at(u, n, 0) + 2) >> 2;
      if (y == 0) return (top_at(u, n, x) + 3 * dc + 2) >> 2;
      if (x == 0) return (left_at(u, n, y) + 3 * dc + 2) >> 2;
    }
    return dc;
  }
  if (edge && mode == 26 && x == 0) {
    int v = top_at(u, n, 0) + ((left_at(u, n, y) - u[2 * n]) >> 1);
    return v < 0 ? 0 : (v > (1 << BD) - 1 ? (1 << BD) - 1 : v);
  }
  if (edge && mode == 10 && y == 0) {
    int v = left_at(u, n, 0) + ((top_at(u, n, x) - u[2 * n]) >> 1);
    return v < 0 ? 0 : (v > (1 << BD) - 1 ? (1 << BD) - 1 : v);
  }
  const bool vertical = mode >= 18;
  const int angle = kAngle[mode];
  const int k = vertical ? y : x;
  const int j = vertical ? x : y;
  const int pos = (k + 1) * angle;
  const int idx = pos >> 5;
  const int fr = pos & 31;
  // reference line position i in [-n, 2n + 1] -> sample
  auto ref = [&](int i) -> int {
    if (i == 0) return R[2 * n];
    if (i >= 1) {
      int t = i <= 2 * n ? i - 1 : 2 * n - 1;
      return vertical ? top_at(R, n, t) : left_at(R, n, t);
    }
    int e = ((i * kInvAngle[mode] + 128) >> 8) - 1;
    if (e < 0) return R[2 * n];
    if (e > 2 * n - 1) e = 2 * n - 1;
    return vertical ? left_at(R, n, e) : top_at(R, n, e);
  };
  const int i0 = idx + 1 + j;
  const int a = ref(i0);
  const int bb = fr ? ref(i0 + 1) : a;
  return ((32 - fr) * a + fr * bb + 16) >> 5;
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
