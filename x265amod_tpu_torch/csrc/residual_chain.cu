// Kernel K2 `residual_chain`: forward DCT -> quant -> RDOQ (optional) ->
// sign-bit hiding -> dequant -> inverse DCT -> add prediction -> clip, plus
// the SSD of the reconstruction, for K candidate predictions of each block,
// at bit depth 8 or 10.
//
// Replaces, from the JAX package: ops/transforms.py fwd_transform and
// inv_transform (DCT 8/16/32), ops/quant.py quant and dequant,
// ops/rdoq.py rdoq_adjust and ops/sbh.py sbh_adjust, as chained in
// models/intra_tree.py eval_intra_luma / eval_intra_chroma and the P and B
// trees' final coding (models/inter_tree.py:619,1626).
//
// Entry point (plain C, caller's stream, returns cudaGetLastError()):
//   residual_chain(orig [B,n,n] i32, pred [B,K,n,n] i32, qp [B] i32, B, K,
//                  n, sbh, intra, bd, rdoq_tab f32 [262] or NULL,
//                  lam [B] f32 or NULL, levels [B,K,n,n] i16,
//                  recon [B,K,n,n] i32 or NULL, ssd [B,K] i32)
// intra selects the quant rounding offset: 171 << (qbits - 9) for intra
// blocks, 85 << (qbits - 9) for inter blocks (ops/quant.py:100).
// rdoq_tab (step[52], rates[4][52], csb0, csb1; ops/rdoq.py kernel_table)
// switches the RDOQ stage on with the per-block lambdas lam.
//
// What bounds it on an H100: integer operations.  Per n x n block it reads
// 2 n^2 ints and writes n^2 int16 (+ n^2 int32 recon) but does four n-point
// matrix products (4 n^3 multiply-adds).  The JAX package splits 16-bit
// operands into bytes to keep exact f32 MXU products; here one thread block
// owns one candidate block, keeps every stage in shared memory and runs
// exact int32 dot products (every partial sum stays below 2^31, also at bit
// depth 10), with 64-bit products only in quant/dequant.  No TF32.
//
// The RDOQ stage works on the levels and the unrounded f32 levels q in
// shared memory: one thread per coefficient picks |l| or |l| - 1, then one
// thread per 4x4 group decides whether to zero the group.  Its f32
// arithmetic repeats XLA's CPU code operation for operation (see
// ops/rdoq.py): every product and sum is an explicit _rn intrinsic, the
// fused multiply-adds XLA forms are __fmaf_rn, and the file is built with
// --fmad=false so that the compiler fuses nothing else.  Like the
// reference, the stage takes qbits and step at bit depth 8.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

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

constexpr int kMaxN = 32;

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

template <int BD, bool RDOQ>
__global__ void chain_kernel(const int32_t* __restrict__ orig,
                             const int32_t* __restrict__ pred,
                             const int32_t* __restrict__ qp_arr, int K,
                             int n, int sbh, int intra,
                             const float* __restrict__ rdoq_tab,
                             const float* __restrict__ lam_arr,
                             int16_t* __restrict__ levels,
                             int32_t* __restrict__ recon,
                             int32_t* __restrict__ ssd) {
  __shared__ int T[kMaxN * kMaxN];
  __shared__ int A[kMaxN * kMaxN];
  __shared__ int Bm[kMaxN * kMaxN];
  __shared__ float Q[RDOQ ? kMaxN * kMaxN : 1];
  __shared__ int ssd_sh;
  const int bk = blockIdx.x;
  const int b = bk / K;
  const int nn = n * n;
  const int log2n = 31 - __clz(n);
  const int step = 32 / n;
  const int32_t* o = orig + (size_t)b * nn;
  const int32_t* p = pred + (size_t)bk * nn;
  const int qp = qp_arr[b];
  if (threadIdx.x == 0) ssd_sh = 0;
  for (int i = threadIdx.x; i < nn; i += blockDim.x) {
    const int k = i / n, j = i % n;
    T[i] = tuned_cos((k * step) * (2 * j + 1));
    A[i] = o[i] - p[i];
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
    t.lam = lam_arr[b];
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
    __syncthreads();
  }
  // levels out; dequant (spec 8.6.3, m = 16) into Bm
  {
    const int bd_shift = BD + log2n - 5;
    const long long scale = (long long)(kInvQuantScale[qp % 6] * 16)
                            << (qp / 6);
    for (int i = threadIdx.x; i < nn; i += blockDim.x) {
      levels[(size_t)bk * nn + i] = (int16_t)A[i];
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
    int rec = p[i] + clip16(round_shift(acc, 20 - BD));
    rec = rec < 0 ? 0 : (rec > kMaxV ? kMaxV : rec);
    if (recon) recon[(size_t)bk * nn + i] = rec;
    const int d = rec - o[i];
    local += d * d;
  }
  atomicAdd(&ssd_sh, local);
  __syncthreads();
  if (threadIdx.x == 0) ssd[bk] = ssd_sh;
}

template <int BD, bool RDOQ>
void launch(const int32_t* orig, const int32_t* pred, const int32_t* qp,
            int B, int K, int n, int sbh, int intra, const float* tab,
            const float* lam, int16_t* levels, int32_t* recon, int32_t* ssd,
            cudaStream_t stream) {
  const int threads = n == 8 ? 64 : 256;
  chain_kernel<BD, RDOQ><<<B * K, threads, 0, stream>>>(
      orig, pred, qp, K, n, sbh, intra, tab, lam, levels, recon, ssd);
}

}  // namespace

extern "C" int residual_chain(const int32_t* orig, const int32_t* pred,
                              const int32_t* qp, int B, int K, int n,
                              int sbh, int intra, int bd,
                              const float* rdoq_tab, const float* lam,
                              int16_t* levels, int32_t* recon, int32_t* ssd,
                              cudaStream_t stream) {
  if (n != 8 && n != 16 && n != 32) return (int)cudaErrorInvalidValue;
  if (bd != 8 && bd != 10) return (int)cudaErrorInvalidValue;
  if ((rdoq_tab == nullptr) != (lam == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool rdoq = rdoq_tab != nullptr;
  if (bd == 8 && !rdoq)
    launch<8, false>(orig, pred, qp, B, K, n, sbh, intra, rdoq_tab, lam,
                     levels, recon, ssd, stream);
  else if (bd == 8)
    launch<8, true>(orig, pred, qp, B, K, n, sbh, intra, rdoq_tab, lam,
                    levels, recon, ssd, stream);
  else if (!rdoq)
    launch<10, false>(orig, pred, qp, B, K, n, sbh, intra, rdoq_tab, lam,
                      levels, recon, ssd, stream);
  else
    launch<10, true>(orig, pred, qp, B, K, n, sbh, intra, rdoq_tab, lam,
                     levels, recon, ssd, stream);
  return (int)cudaGetLastError();
}
