// Device functions of the intra chain, shared by K1 (`intra_pred.cu`), K2
// (`residual_chain.cu`) and K20 (`commit_intra.cu`): K1's reference
// substitution (spec 8.4.4.2.2), [1 2 1] smoothing and prediction sample of
// every intra mode (JAX ops/intra.py substitute_refs_general,
// predict_modes_batch), and K2's residual chain: forward DCT, quant, the
// RDOQ stage, sign-bit hiding, dequant, inverse DCT and reconstruction
// (JAX ops/transforms.py, ops/quant.py, ops/rdoq.py, ops/sbh.py), templated
// on the bit depth (8 or 10) and RDOQ.  Each thread block runs one block's
// chain; the functions loop over the samples with the block's threads.
// Header only; each kernel is its own library.  The RDOQ arithmetic is
// XLA's f32 order operation for operation (every product and sum an _rn
// intrinsic, __fmaf_rn where XLA fuses), so the files that include this
// build with --fmad=false.

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
// availability (0 / 1) is in f (one thread, sequentially, exactly as the
// spec: an unavailable sample takes the previous one, a leading run the
// first available one, nothing available mid-grey 1 << (bd - 1)), then the
// [1 2 1] smoothing of it into f (all threads).  Every thread of the block
// must call it.
template <int BD>
__device__ void substitute_smooth(int* s, int* f, int n) {
  const int m = 4 * n + 1;
  if (threadIdx.x == 0) {
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
  __syncthreads();
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    f[i] = (i == 0 || i == m - 1)
               ? s[i]
               : (s[i - 1] + 2 * s[i] + s[i + 1] + 2) >> 2;
  }
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

// ---- K2: the residual chain -------------------------------------------

__constant__ int kC32[32] = {64, 90, 90, 90, 89, 88, 87, 85, 83, 82, 80,
                             78, 75, 73, 70, 67, 64, 61, 57, 54, 50, 46,
                             43, 38, 36, 31, 25, 22, 18, 13, 9, 4};
__constant__ int kQuantScale[6] = {26214, 23302, 20560, 18396, 16384,
                                   14564};
__constant__ int kInvQuantScale[6] = {40, 45, 51, 57, 64, 72};
// (y * 4 + x) -> position in the 4x4 up-right diagonal scan
__constant__ int kDiagPos[16] = {0, 2, 5, 9, 1, 4, 8, 12,
                                 3, 7, 11, 14, 6, 10, 13, 15};

__device__ __forceinline__ int tuned_cos(int m) {
  m &= 127;
  if (m <= 32) return m < 32 ? kC32[m] : 0;
  if (m <= 64) return (64 - m) < 32 ? -kC32[64 - m] : 0;
  if (m <= 96) return (m - 64) < 32 ? -kC32[m - 64] : 0;
  return kC32[128 - m];
}

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

// Per-block shared memory of the residual chain.
template <bool RDOQ>
struct ChainSmem {
  int T[kMaxN * kMaxN];
  int A[kMaxN * kMaxN];
  int Bm[kMaxN * kMaxN];
  float Q[RDOQ ? kMaxN * kMaxN : 1];
  int ssd;
};

// The residual chain of one n x n block by the whole thread block: forward
// DCT of orig - pred, quant (intra 171 or inter 85 rounding), the RDOQ
// stage (with RDOQ: K2's table rdoq_tab, lambda lam), SBH, dequant, inverse
// DCT, + pred, clip to the bit depth.  orig / pred are read at row strides
// os / ps; level_out(i, v) and recon_out(i, v) take the levels and the
// reconstruction at raster index i = y n + x; sm.ssd holds the SSD of the
// reconstruction on return.  Every thread of the block must call it.  sm
// is a ChainSmem (with RDOQ, a ChainSmem<true>).
template <int BD, bool RDOQ, class Smem, class LevelOut, class ReconOut>
__device__ void chain(Smem& sm, const int32_t* o, int os,
                      const int32_t* p, int ps, int n, int qp, int sbh,
                      int intra, const float* rdoq_tab, float lam,
                      LevelOut level_out, ReconOut recon_out) {
  int* T = sm.T;
  int* A = sm.A;
  int* Bm = sm.Bm;
  float* Q = sm.Q;
  const int nn = n * n;
  const int log2n = 31 - __clz(n);
  const int step = 32 / n;
  if (threadIdx.x == 0) sm.ssd = 0;
  for (int i = threadIdx.x; i < nn; i += blockDim.x) {
    const int k = i / n, j = i % n;
    T[i] = tuned_cos((k * step) * (2 * j + 1));
    A[i] = o[k * os + j] - p[k * ps + j];
  }
  __syncthreads();
  // forward stage 1: tmp[y][u] = rs(sum_x resi[y][x] * T[u][x], log2n+bd-9)
  const int s1 = log2n + BD - 9;
  for (int i = threadIdx.x; i < nn; i += blockDim.x) {
    const int y = i / n, u = i % n;
    int acc = 0;
    for (int x = 0; x < n; ++x) acc += A[y * n + x] * T[u * n + x];
    Bm[i] = round_shift(acc, s1);
  }
  __syncthreads();
  // forward stage 2: coeff[u][k] = rs(sum_y T[u][y] * tmp[y][k], log2n+6)
  const int qbits = 14 + qp / 6 + 15 - BD - log2n;
  // RDOQ's unrounded level uses the 8-bit shift (JAX ops/rdoq.py:106)
  const float q_div = (float)(1 << (14 + qp / 6 + 15 - 8 - log2n));
  for (int i = threadIdx.x; i < nn; i += blockDim.x) {
    const int u = i / n, k = i % n;
    int acc = 0;
    for (int y = 0; y < n; ++y) acc += T[u * n + y] * Bm[y * n + k];
    const int c = round_shift(acc, log2n + 6);
    // quant: offset (171 intra, 85 inter) << (qbits - 9), flat scaling
    const long long mag =
        ((long long)abs(c) * kQuantScale[qp % 6] +
         ((long long)(intra ? 171 : 85) << (qbits - 9))) >> qbits;
    A[i] = clip16(c < 0 ? -mag : (c > 0 ? mag : 0));
    if (RDOQ)
      Q[i] = __fdiv_rn(__fmul_rn((float)abs(c), (float)kQuantScale[qp % 6]),
                       q_div);
  }
  __syncthreads();
  if (RDOQ) {
    RdoqRow t;
    t.step = rdoq_tab[qp];
    t.r0 = rdoq_tab[52 + qp];
    t.r1 = rdoq_tab[104 + qp];
    t.r2 = rdoq_tab[156 + qp];
    t.r3 = rdoq_tab[208 + qp];
    t.csb0 = rdoq_tab[260];
    t.csb1 = rdoq_tab[261];
    t.lam = lam;
    // each coefficient: |l| or |l| - 1, a tie keeps |l|
    for (int i = threadIdx.x; i < nn; i += blockDim.x) {
      const int v = A[i];
      const int a = abs(v);
      if (a > 0 && coeff_cost(t, Q[i], a - 1) < coeff_cost(t, Q[i], a))
        A[i] = v > 0 ? a - 1 : 1 - a;
    }
    __syncthreads();
    // each 4x4 group: zero it when j_zero < j_code (sums in XLA's order)
    const int g4 = n / 4;
    for (int g = threadIdx.x; g < g4 * g4; g += blockDim.x) {
      const int base = (g / g4) * 4 * n + (g % g4) * 4;
      float dsq[16], zsq[16], rr[16];
      bool nz = false;
      for (int k = 0; k < 16; ++k) {
        const int idx = base + (k >> 2) * n + (k & 3);
        const int l = abs(A[idx]);
        const float q = Q[idx];
        const float d = __fsub_rn(q, (float)l);
        dsq[k] = __fmul_rn(d, d);
        zsq[k] = __fmul_rn(q, q);
        rr[k] = level_rate(t, l);
        nz |= l > 0;
      }
      if (!nz) continue;
      float ld[8], lr[8];
      for (int k = 0; k < 8; ++k) {
        ld[k] = __fmaf_rn(t.step, dsq[k + 8], __fmul_rn(t.step, dsq[k]));
        lr[k] = __fadd_rn(rr[k], rr[k + 8]);
      }
      const float d_code = lanes_tree(ld);
      const float r_code = lanes_tree(lr);
      float d_zero = __fmul_rn(t.step, zsq[0]);
      for (int k = 1; k < 16; ++k) d_zero = __fmaf_rn(t.step, zsq[k], d_zero);
      const float j_code = __fmaf_rn(t.lam, __fadd_rn(r_code, t.csb1), d_code);
      const float j_zero = __fadd_rn(d_zero, __fmul_rn(t.lam, t.csb0));
      if (j_zero < j_code) {
        for (int k = 0; k < 16; ++k) A[base + (k >> 2) * n + (k & 3)] = 0;
      }
    }
    __syncthreads();
  }
  if (sbh) {
    const int g4 = n / 4;
    for (int g = threadIdx.x; g < g4 * g4; g += blockDim.x) {
      const int gy = g / g4, gx = g % g4;
      int first = 16, last = -1, first_v = 0, last_i = 0, sum = 0;
      for (int q = 0; q < 16; ++q) {
        const int idx = (gy * 4 + q / 4) * n + gx * 4 + q % 4;
        const int v = A[idx];
        if (v != 0) {
          const int ps_ = kDiagPos[q];
          if (ps_ < first) { first = ps_; first_v = v; }
          if (ps_ > last) { last = ps_; last_i = idx; }
          sum += abs(v);
        }
      }
      if (last - first > 3 && (sum & 1) != (first_v < 0 ? 1 : 0)) {
        const int v = A[last_i];
        const int sg = v > 0 ? 1 : -1;
        A[last_i] = v + (abs(v) >= 2 ? -sg : sg);
      }
    }
    __syncthreads();
  }
  // levels out; dequant (spec 8.6.3, m = 16) into Bm
  {
    const int bd_shift = BD + log2n - 5;
    const long long scale = (long long)(kInvQuantScale[qp % 6] * 16)
                            << (qp / 6);
    for (int i = threadIdx.x; i < nn; i += blockDim.x) {
      level_out(i, A[i]);
      Bm[i] = clip16(((long long)A[i] * scale + (1 << (bd_shift - 1))) >>
                     bd_shift);
    }
  }
  __syncthreads();
  // inverse stage 1: g[y][x] = clip16(rs(sum_k T[k][y] * coeff[k][x], 7))
  for (int i = threadIdx.x; i < nn; i += blockDim.x) {
    const int y = i / n, x = i % n;
    int acc = 0;
    for (int k = 0; k < n; ++k) acc += T[k * n + y] * Bm[k * n + x];
    A[i] = clip16(round_shift(acc, 7));
  }
  __syncthreads();
  // inverse stage 2: r[y][x] = clip16(rs(sum_u g[y][u] * T[u][x], 20 - bd))
  constexpr int kMaxV = (1 << BD) - 1;
  int local = 0;
  for (int i = threadIdx.x; i < nn; i += blockDim.x) {
    const int y = i / n, x = i % n;
    int acc = 0;
    for (int u = 0; u < n; ++u) acc += A[y * n + u] * T[u * n + x];
    int rec = p[y * ps + x] + clip16(round_shift(acc, 20 - BD));
    rec = rec < 0 ? 0 : (rec > kMaxV ? kMaxV : rec);
    recon_out(i, rec);
    const int d = rec - o[y * os + x];
    local += d * d;
  }
  atomicAdd(&sm.ssd, local);
  __syncthreads();
}

}  // namespace intra_chain
