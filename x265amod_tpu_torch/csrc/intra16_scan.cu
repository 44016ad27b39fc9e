// Kernel K23 `intra16_scan`: the flat CTB16 all-intra wavefront scan, for a
// batch of F frames: per CTU16 the 35-mode RD decision on true
// reconstructed references, the chosen mode's luma and DM chroma coding,
// and the reconstruction the next CTUs predict from.  Also the commit scan
// of the flat P and B frames: given per-CTU kinds, only the intra CTUs
// (kind 2) run; every other block returns at once.
//
// Replaces, from the JAX package: models/intra_frame.py, the scan body of
// `_encode_frame` (:183-234, `lax.scan` at :236); and the commit scans of
// models/inter_frame.py (:394-458, `lax.scan` at :457) and
// models/b_frame.py (:489-548, :547), whose inter cells the wrapper has
// already written (their recon and levels, mode 1, so that a left inter
// neighbour reads as mode 1: JAX `left_intra` :403-405) and whose rates
// read the P or B rows of the tu_bits table.  Per CTU (lane):
//   - the raw neighbours from the recon planes (:144-155) with the flat
//     grid's availability (left iff cx > 0, top iff cy > 0, top-right iff
//     also cx < wc - 1, below-left never), the spec 8.4.4.2.2 substitution
//     and the [1 2 1] smoothing, and all 35 luma predictions (K1's device
//     functions, intra_chain.cuh);
//   - for every mode the residual chain: forward DCT, quant (intra
//     rounding), sign-bit hiding, dequant, inverse DCT, clip (K2's
//     arithmetic, 35 blocks at once), the SSD, and the rate `tu_bits` at
//     I-slice states (tu_bits.cuh);
//     lossless: levels = residual, recon = source, SSD 0 (:165-172);
//   - the MPM bins from the left CTU's mode only (:202-210), the cost
//     fma(lam, rbits + mbits, ssd) (XLA's vfmadd231ss in the argmin
//     fusion), and the first minimum (jnp.argmin);
//   - the two chroma chains at the chosen mode (DM, 8x8, c_idx 1), K2's
//     chain from intra_chain.cuh;
//   - the levels into raster cells [F, hc, wc, 16, 16] / [.., 8, 8], the
//     mode into [F, hc, wc] (the next lane's left mode), the recon into the
//     raster planes, which the next diagonals read.
//
// Design: one launch per anti-diagonal d = cx + 2 cy (each CTU's left,
// top, top-left and top-right neighbours lie on earlier diagonals),
// enqueued back to back by one C call; a thread block per (frame, CTU) of
// the diagonal, 512 threads, the 35 modes' chains in shared memory side by
// side (about 100 KB), each stage one pass over 35 x 256 samples.
// Lossless is a template parameter.  Built with --fmad=false: the cost's
// only FMA is written out.
//
// What bounds it on an H100: the latency of a block's chain of dependent
// stages, once per diagonal (254 diagonals at 1920x1088, 84 at 640x368),
// far above its bytes and its integer operations.
//
// Entry point (plain C, caller's stream, returns cudaGetLastError() and the
// number of launches it enqueued in *launches):
//   intra16_scan(const ScanArgs* args, int* launches, cudaStream_t)

#include <cstdint>
#include <cuda_runtime.h>

#include "intra_chain.cuh"
#include "tu_bits.cuh"

extern "C" {
struct ScanArgs {
  // batch and geometry (luma plane W x H, CTB16 grid wc x hc)
  int F, W, H, wc, hc;
  int sbh, lossless;
  // source planes [F, H, W] and [F, H/2, W/2]
  const int32_t *src_y, *src_cb, *src_cr;
  // recon planes, read as references and written
  int32_t *rec_y, *rec_cb, *rec_cr;
  // levels [F, hc, wc, 16, 16] and [F, hc, wc, 8, 8]
  int16_t *ly, *lcb, *lcr;
  // chosen luma mode per CTU [F, hc, wc]
  int32_t* modes;
  // per-CTU QP, chroma QP and lambda [hc, wc] (shared by the batch)
  const int32_t *qp, *qpc;
  const float* lam;
  // tu_bits table [52 * 13] f32: luma rows at the slice type's states
  const float* bits;
  // per-CTU kinds [F, hc, wc] (2 = intra), or null: every CTU is intra
  const int32_t* kinds;
};
}

namespace {

using namespace intra_chain;

constexpr int kThreads = 512;
constexpr int kModes = 35;
constexpr int kN = 16;
constexpr int kNN = kN * kN;
constexpr int kAll = kModes * kNN;

struct ScanSmem {
  int s[4 * kN + 1], f[4 * kN + 1];
  int T[kNN];          // T[u][x]
  int Tt[kNN];         // T transposed: Tt[x][u]
  int orig[kNN];
  int16_t P[kAll];     // predictions
  int16_t R[kAll];     // residuals, then each mode's recon
  int16_t L[kAll];     // levels
  union {
    int X[kAll];       // transform intermediates
    ChainSmem<false> ch;
  } u;
  int ssd[kModes];
  tu_bits_dev::TuCounts cnt[kModes];
  float cost[kModes];
  int best, dc;
  int cpred[64];
};

struct Avail {
  bool t0, t1, l0, c;
};

// The reference scan of an n x n block at (x0, y0) of plane `rec` (width
// pw, height ph): left[2n-1 .. 0], corner, top[0 .. 2n-1], read clamped
// into the plane (an unavailable sample is substituted), then substituted
// and smoothed.  Every thread must call it.
__device__ void scan_refs(const int32_t* rec, int pw, int ph, int x0, int y0,
                          int n, const Avail& av, int* s, int* f) {
  for (int i = threadIdx.x; i < 4 * n + 1; i += blockDim.x) {
    int x, y;
    bool a;
    if (i < 2 * n) {
      const int j = 2 * n - 1 - i;
      x = x0 - 1;
      y = y0 + j;
      a = j < n && av.l0;
    } else if (i == 2 * n) {
      x = x0 - 1;
      y = y0 - 1;
      a = av.c;
    } else {
      const int j = i - 2 * n - 1;
      x = x0 + j;
      y = y0 - 1;
      a = j < n ? av.t0 : av.t1;
    }
    x = x < 0 ? 0 : (x > pw - 1 ? pw - 1 : x);
    y = y < 0 ? 0 : (y > ph - 1 ? ph - 1 : y);
    s[i] = rec[y * pw + x];
    f[i] = a;
  }
  __syncthreads();
  substitute_smooth<8>(s, f, n);
}

// One chroma plane of a CTU at the chosen mode: prediction, then the chain
// (or, lossless, levels = residual and recon = source).
template <bool LOSSLESS>
__device__ void code_chroma(ScanSmem& sm, const int32_t* src, int32_t* rec,
                            int pw, int ph, int x0, int y0, const Avail& av,
                            int mode, int qp, int sbh, int16_t* lv) {
  constexpr int n = 8;
  scan_refs(rec, pw, ph, x0, y0, n, av, sm.s, sm.f);
  if (threadIdx.x == 0) sm.dc = dc_value(sm.s, n, 3);
  __syncthreads();
  const RefView r{sm.s, sm.f, n};
  const int dc = sm.dc;
  for (int i = threadIdx.x; i < n * n; i += blockDim.x)
    sm.cpred[i] = pred_sample<8>(r, mode, 1, 3, dc, i / n, i % n);
  __syncthreads();
  const int32_t* o = src + y0 * pw + x0;
  int32_t* out = rec + y0 * pw + x0;
  if (LOSSLESS) {
    for (int i = threadIdx.x; i < n * n; i += blockDim.x) {
      const int v = o[(i / n) * pw + i % n];
      lv[i] = (int16_t)(v - sm.cpred[i]);
      out[(i / n) * pw + i % n] = v;
    }
    __syncthreads();
    return;
  }
  chain<8, false>(
      sm.u.ch, o, pw, sm.cpred, n, n, qp, sbh, 1, nullptr, 0.0f,
      [&](int i, int v) { lv[i] = (int16_t)v; },
      [&](int i, int v) { out[(i / n) * pw + i % n] = v; });
}

template <bool LOSSLESS>
__global__ void __launch_bounds__(kThreads)
    scan_kernel(const ScanArgs a, int d, int lo, int cnt) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ScanSmem& sm = *reinterpret_cast<ScanSmem*>(smem_raw);
  const int tid = threadIdx.x;
  const int fi = blockIdx.x / cnt;
  const int cy = lo + blockIdx.x % cnt;
  const int cx = d - 2 * cy;
  const int W = a.W, H = a.H, Wc = W / 2, Hc = H / 2;
  const int ctu = cy * a.wc + cx;
  const size_t nctu = (size_t)a.wc * a.hc;
  // a P/B commit codes only the intra CTUs (uniform over the block)
  if (a.kinds != nullptr && a.kinds[(size_t)fi * nctu + ctu] != 2) return;
  const int32_t* sy = a.src_y + (size_t)fi * H * W;
  int32_t* ry = a.rec_y + (size_t)fi * H * W;
  const Avail av{cy > 0, cy > 0 && cx < a.wc - 1, cx > 0, cx > 0 && cy > 0};
  const int qp = a.qp[ctu];
  const int x0 = 16 * cx, y0 = 16 * cy;

  // ---- references, source block, transform matrix -----------------------
  for (int i = tid; i < kNN; i += kThreads) {
    const int k = i / kN, j = i % kN;
    const int t = tuned_cos((k * 2) * (2 * j + 1));
    sm.T[i] = t;
    sm.Tt[j * kN + k] = t;
    sm.orig[i] = sy[(y0 + k) * W + x0 + j];
  }
  if (tid < kModes) {
    sm.ssd[tid] = 0;
    tu_bits_dev::clear(&sm.cnt[tid]);
  }
  scan_refs(ry, W, H, x0, y0, kN, av, sm.s, sm.f);
  if (tid == 0) sm.dc = dc_value(sm.s, kN, 4);
  __syncthreads();

  // ---- the 35 predictions and residuals ----------------------------------
  {
    const RefView r{sm.s, sm.f, kN};
    const int dc = sm.dc;
    for (int e = tid; e < kAll; e += kThreads) {
      const int m = e / kNN, i = e % kNN;
      const int p = pred_sample<8>(r, m, 0, 4, dc, i / kN, i % kN);
      sm.P[e] = (int16_t)p;
      sm.R[e] = (int16_t)(sm.orig[i] - p);
      if (LOSSLESS) sm.L[e] = sm.R[e];
    }
  }
  __syncthreads();

  if (!LOSSLESS) {
    // forward stage 1: X[m][y][u] = rs(sum_x R[m][y][x] T[u][x], 3)
    for (int e = tid; e < kAll; e += kThreads) {
      const int m = e / kNN, y = (e / kN) % kN, uu = e % kN;
      const int16_t* rr = sm.R + m * kNN + y * kN;
      int acc = 0;
#pragma unroll
      for (int x = 0; x < kN; ++x) acc += rr[x] * sm.Tt[x * kN + uu];
      sm.u.X[e] = round_shift(acc, 3);
    }
    __syncthreads();
    // forward stage 2 + quant: c[m][u][k] = rs(sum_y T[u][y] X[m][y][k], 10)
    const int qbits = 14 + qp / 6 + 15 - 8 - 4;
    const long long qoff = (long long)171 << (qbits - 9);
    const int qs = kQuantScale[qp % 6];
    for (int e = tid; e < kAll; e += kThreads) {
      const int m = e / kNN, uu = (e / kN) % kN, k = e % kN;
      const int* xm = sm.u.X + m * kNN + k;
      int acc = 0;
#pragma unroll
      for (int y = 0; y < kN; ++y) acc += sm.T[uu * kN + y] * xm[y * kN];
      const int c = round_shift(acc, 10);
      const long long mag = ((long long)abs(c) * qs + qoff) >> qbits;
      sm.L[e] = (int16_t)clip16(c < 0 ? -mag : (c > 0 ? mag : 0));
    }
    __syncthreads();
    if (a.sbh) {
      for (int e = tid; e < kModes * 16; e += kThreads) {
        int16_t* A = sm.L + (e / 16) * kNN;
        const int gy = (e % 16) / 4, gx = e % 4;
        int first = 16, last = -1, first_v = 0, last_i = 0, sum = 0;
        for (int q = 0; q < 16; ++q) {
          const int idx = (gy * 4 + q / 4) * kN + gx * 4 + q % 4;
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
          A[last_i] = (int16_t)(v + (abs(v) >= 2 ? -sg : sg));
        }
      }
      __syncthreads();
    }
  }

  // ---- rates (and, lossy, inverse stage 1 with the dequant inline) -------
  for (int e = tid; e < kModes * 16; e += kThreads)
    tu_bits_dev::group_counts(sm.L + (e / 16) * kNN, kN, e % 16,
                              &sm.cnt[e / 16]);
  if (!LOSSLESS) {
    const long long scale = (long long)(kInvQuantScale[qp % 6] * 16)
                            << (qp / 6);
    for (int e = tid; e < kAll; e += kThreads) {
      const int m = e / kNN, y = (e / kN) % kN, x = e % kN;
      const int16_t* lm = sm.L + m * kNN + x;
      int acc = 0;
#pragma unroll
      for (int k = 0; k < kN; ++k)
        acc += sm.T[k * kN + y] *
               clip16(((long long)lm[k * kN] * scale + 64) >> 7);
      sm.u.X[e] = clip16(round_shift(acc, 7));
    }
    __syncthreads();
    // inverse stage 2, recon and SSD: a warp's 32 samples share one mode
    const int lane = tid & 31;
    for (int e0 = 0; e0 < kAll; e0 += kThreads) {
      const int e = e0 + tid;
      if (e >= kAll) break;           // whole warps: kAll % 32 == 0
      const int m = e / kNN, i = e % kNN, y = i / kN, x = i % kN;
      const int* xm = sm.u.X + m * kNN + y * kN;
      int acc = 0;
#pragma unroll
      for (int uu = 0; uu < kN; ++uu) acc += xm[uu] * sm.T[uu * kN + x];
      int rec = sm.P[e] + clip16(round_shift(acc, 12));
      rec = rec < 0 ? 0 : (rec > 255 ? 255 : rec);
      sm.R[e] = (int16_t)rec;
      int dd = (rec - sm.orig[i]) * (rec - sm.orig[i]);
      for (int o = 16; o; o >>= 1) dd += __shfl_down_sync(0xffffffffu, dd, o);
      if (lane == 0) atomicAdd(&sm.ssd[m], dd);
    }
  }
  __syncthreads();

  // ---- costs and the decision ---------------------------------------------
  if (tid < kModes) {
    const int left = cx > 0 ? a.modes[(size_t)fi * nctu + ctu - 1] : 1;
    const bool small = left < 2;
    const int mpm0 = small ? 0 : left, mpm2 = small ? 26 : 0;
    const float mbits = tid == mpm0 ? 2.0f
                        : (tid == 1 || tid == mpm2) ? 3.0f : 6.0f;
    const float rbits = tu_bits_dev::total_bits(
        sm.cnt[tid], kN, a.bits + (qp < 0 ? 0 : (qp > 51 ? 51 : qp)) * 13);
    sm.cost[tid] = __fmaf_rn(a.lam[ctu], __fadd_rn(mbits, rbits),
                             (float)sm.ssd[tid]);
  }
  __syncthreads();
  if (tid == 0) {
    int b = 0;
    for (int m = 1; m < kModes; ++m)
      if (sm.cost[m] < sm.cost[b]) b = m;
    sm.best = b;
    a.modes[(size_t)fi * nctu + ctu] = b;
  }
  __syncthreads();
  const int best = sm.best;
  {
    int16_t* lv = a.ly + ((size_t)fi * nctu + ctu) * kNN;
    for (int i = tid; i < kNN; i += kThreads) {
      lv[i] = sm.L[best * kNN + i];
      ry[(y0 + i / kN) * W + x0 + i % kN] =
          LOSSLESS ? sm.orig[i] : sm.R[best * kNN + i];
    }
  }
  __syncthreads();

  // ---- chroma at the chosen mode ------------------------------------------
  const int qpc = a.qpc[ctu];
  const size_t coff = (size_t)fi * Hc * Wc;
  code_chroma<LOSSLESS>(sm, a.src_cb + coff, a.rec_cb + coff, Wc, Hc, 8 * cx,
                        8 * cy, av, best, qpc, a.sbh,
                        a.lcb + ((size_t)fi * nctu + ctu) * 64);
  code_chroma<LOSSLESS>(sm, a.src_cr + coff, a.rec_cr + coff, Wc, Hc, 8 * cx,
                        8 * cy, av, best, qpc, a.sbh,
                        a.lcr + ((size_t)fi * nctu + ctu) * 64);
}

template <bool LOSSLESS>
int launch_all(const ScanArgs& a, int* launches, cudaStream_t stream) {
  const size_t smem = sizeof(ScanSmem);
  cudaError_t e = cudaFuncSetAttribute(
      scan_kernel<LOSSLESS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int n_diags = a.wc - 1 + 2 * (a.hc - 1) + 1;
  for (int d = 0; d < n_diags; ++d) {
    const int lo = d - a.wc + 1 > 0 ? (d - a.wc + 2) / 2 : 0;
    const int hi = d / 2 < a.hc - 1 ? d / 2 : a.hc - 1;
    if (hi < lo) continue;
    const int cnt = hi - lo + 1;
    scan_kernel<LOSSLESS><<<a.F * cnt, kThreads, smem, stream>>>(a, d, lo,
                                                                 cnt);
    ++*launches;
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace

extern "C" int intra16_scan(const ScanArgs* args, int* launches,
                            cudaStream_t stream) {
  const ScanArgs& a = *args;
  *launches = 0;
  if (a.F < 1 || a.wc < 1 || a.hc < 1 || a.W != 16 * a.wc ||
      a.H != 16 * a.hc)
    return (int)cudaErrorInvalidValue;
  return a.lossless ? launch_all<true>(a, launches, stream)
                    : launch_all<false>(a, launches, stream);
}
