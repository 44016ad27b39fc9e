// Kernel K20 `commit_intra`: the forced intra commit over the CTU32
// wavefront, on true reconstruction, for a batch of F frames.
//
// Replaces, from the JAX package:
//   - models/intra_tree.py, the `lax.scan` of `_encode_frame` (:308-596)
//     with forced split and modes: every CTU codes its CU32 (TU32 luma,
//     TU16 chroma) or its four CU16 quadrants in z-order, each from the
//     reconstruction of the CTUs and quadrants before it;
//   - models/inter_tree.py `_commit_scan` (:829-1044): in a P or B frame
//     the 16-cells the decide scan made intra (kind 2) are coded again from
//     the true neighbouring reconstruction (inter cells are final already).
// Per cell: the reference samples from the recon planes with z-scan
// availability (spec 6.4.1; below-left and top-right per quadrant), the
// spec 8.4.4.2.2 substitution and the [1 2 1] smoothing, the prediction at
// the forced mode (chroma at the same mode): intra_chain.cuh's device
// functions, which K1 shares; then the residual chain with intra rounding
// and sign hiding: chain_lanes.cuh's `group_chain`, which K2 and K23
// share.  With RDOQ the luma chains run K2's RDOQ stage (the intra tree:
// luma only, slice type I; the P/B commit also cb and cr with the luma
// lambda, JAX :883-906), a flag of the launch.
//
// Design: one launch per anti-diagonal d = cx + 2 cy of the CTU32 grid,
// enqueued back to back by one C call with no host sync between them; a
// thread block per (frame, CTU) of the diagonal, kThreads threads.  A block
// runs its CTU's cells in z-order, the three planes of a cell at once: the
// block reads, substitutes (a thread a plane), smooths and predicts all
// three, then warps 0, 1 and 2 run the luma, Cb and Cr chains side by
// side, n lanes each; __syncthreads() orders a cell's recon stores before
// the next cell's reference loads, and the launch order orders the
// diagonals.  A block whose CTU holds no intra cell returns at once (the
// P/B case, where intra cells are rare).  Recon planes are raster int32
// [F, H, W] (chroma [F, H/2, W/2]), updated in place; levels are raster
// 16-cells, int16 [F, h16, w16, 16, 16] and [F, h16, w16, 8, 8] (a TU32's
// quadrants in its four cells), the layout the level pack (K15) reads.
//
// What bounds it on an H100: neither bytes (each source and recon sample
// read and written once) nor the transforms' integer operations (partial
// butterflies, 22, 86 or 342 multiplies a line for n 8, 16 and 32); its
// time is the latency of one block's chain of cells per diagonal (126
// diagonals at 1920x1088, 42 at 640x384).
//
// Entry point (plain C, caller's stream, returns cudaGetLastError() and the
// number of launches it enqueued in *launches):
//   commit_intra(const CommitArgs* args, int bd, int rdoq, int* launches,
//                cudaStream_t)

#include <cstdint>
#include <cuda_runtime.h>

#include "chain_lanes.cuh"

extern "C" {
struct CommitArgs {
  // batch and geometry (luma plane W x H, CTU32 grid wc x hc)
  int F, W, H, wc, hc, w16, h16;
  // sign hiding; RDOQ on the chroma chains too (the P/B commit)
  int sbh, rdoq_chroma;
  // source planes [F, H, W] and [F, H/2, W/2]
  const int32_t *src_y, *src_cb, *src_cr;
  // recon planes, read as references and written in place
  int32_t *rec_y, *rec_cb, *rec_cr;
  // levels [F, h16, w16, 16, 16] and [F, h16, w16, 8, 8]
  int16_t *ly, *lcb, *lcr;
  // intra mode per 16-cell [F, h16, w16]
  const int32_t* modes;
  // the intra tree: forced split per CTU [F, hc, wc]; the P/B commit:
  // null, and kinds [F, h16, w16] (2 = intra) select the cells
  const int32_t *split, *kinds;
  // QP maps [h16, w16] and [hc, wc] and the luma lambdas (one frame's,
  // shared by the batch)
  const int32_t *qp16, *qc16, *qp32, *qc32;
  const float *lam16, *lam32;
  // RDOQ tables (262 f32, K2's layout; null without RDOQ): luma TU16,
  // luma TU32, chroma TU8
  const float *tab_y16, *tab_y32, *tab_c8;
};
}

namespace {

using namespace chain_lanes;

// Threads a block: the three chain warps and one more for the reference
// and prediction passes.  At about 235 registers a thread two blocks fit
// on an SM, so a 16-frame 1088p diagonal (up to 272 CTUs) runs in about
// one wave.
constexpr int kThreads = 128;

// Per plane p (0 luma, 1 Cb, 2 Cr) of the cell being coded: the chain's
// tile and, with RDOQ, its unrounded levels (chain_lanes.cuh), the
// prediction, the reference scan and its smoothed copy, the DC value.
template <bool RDOQ>
struct CommitSmem {
  int S[3][kMaxN * (kMaxN + 1)];
  float Q[3][RDOQ ? kMaxN * (kMaxN + 1) : 1];
  int pred[3][kMaxN * kMaxN];
  int s[3][kMaxSeq];
  int f[3][kMaxSeq];
  int dc[3];
};

// Availability of a block's reference runs: top (n), top-right (n), left
// (n), below-left (n), corner.
struct Avail {
  bool t0, t1, l0, l1, c;
};

// One plane's block of a cell (frame-offset pointers): its source, its
// recon (read for the references, written back), its levels (16-cell
// layout, cs x cs samples a cell), plane width and height, the block's
// position, QP, and RDOQ table and lambda (null and 0 without RDOQ).
struct Blk {
  const int32_t* src;
  int32_t* rec;
  int16_t* lv;
  int pw, ph, x0, y0, qp, cs;
  const float* tab;
  float lam;
};

// The chain of plane p's N x N block by lanes 0..N-1 of warp p
// (chain_lanes.cuh `group_chain`): levels into the 16-cell layout at cell
// (cr0, cc0), recon written back into the plane.
template <int N, int BD, bool RDOQ, class Smem>
__device__ void chain_plane(Smem& sm, int p, const Blk& b, int sbh, int w16,
                            int cr0, int cc0) {
  RdoqRow t{};
  if (RDOQ) {
    t.step = b.tab[b.qp];
    t.r0 = b.tab[52 + b.qp];
    t.r1 = b.tab[104 + b.qp];
    t.r2 = b.tab[156 + b.qp];
    t.r3 = b.tab[208 + b.qp];
    t.csb0 = b.tab[260];
    t.csb1 = b.tab[261];
    t.lam = b.lam;
  }
  const int pw = b.pw, cs = b.cs;
  const int32_t* o = b.src + b.y0 * pw + b.x0;
  int32_t* out = b.rec + b.y0 * pw + b.x0;
  int16_t* lvf = b.lv;
  const int* pr = sm.pred[p];
  group_chain<N, BD, RDOQ>(
      threadIdx.x & 31, group_mask<N>(), sm.S[p], sm.Q[p], b.qp, sbh, 1, t,
      [&](int y, int* v) {
#pragma unroll
        for (int x = 0; x < N; ++x) v[x] = o[y * pw + x] - pr[y * N + x];
      },
      [&](int y, int* v) {
#pragma unroll
        for (int x = 0; x < N; ++x) v[x] = pr[y * N + x];
      },
      [&](int y, int* v) {
#pragma unroll
        for (int x = 0; x < N; ++x) v[x] = o[y * pw + x];
      },
      [&](int y, int x, int v) {
        const size_t cell = (size_t)(cr0 + y / cs) * w16 + cc0 + x / cs;
        lvf[cell * cs * cs + (y % cs) * cs + x % cs] = (int16_t)v;
      },
      [&](int y, const int* rr) {
#pragma unroll
        for (int x = 0; x < N; ++x) out[y * pw + x] = rr[x];
      });
}

// One cell: its luma block (NL x NL) and its Cb and Cr blocks (NL/2) at
// `mode`.  The thread block reads the three reference scans (clamped into
// the plane where unavailable), threads 0, 32 and 64 substitute one plane
// each, then the block smooths and predicts all three; the three chains
// run at once, warp p coding plane p.  The cell's recon is the next
// cell's reference, so the block meets at the end.  Luma takes RDOQ with
// RDOQ_L, chroma with RDOQ_C.
template <int NL, int BD, bool RDOQ_L, bool RDOQ_C, class Smem>
__device__ void code_cell(Smem& sm, const Blk (&b)[3], int mode,
                          const Avail& av, int sbh, int w16, int cr0,
                          int cc0) {
  constexpr int NC = NL / 2;
  constexpr int mL = 4 * NL + 1, mC = 4 * NC + 1, mAll = mL + 2 * mC;
  // reference scans: left[2n-1 .. 0], corner, top[0 .. 2n-1]
  for (int t = threadIdx.x; t < mAll; t += blockDim.x) {
    const int p = t < mL ? 0 : (t < mL + mC ? 1 : 2);
    const int i = p == 0 ? t : (p == 1 ? t - mL : t - mL - mC);
    const int n = p == 0 ? NL : NC;
    const Blk& bp = b[p];
    int x, y;
    bool a;
    if (i < 2 * n) {
      const int j = 2 * n - 1 - i;
      x = bp.x0 - 1;
      y = bp.y0 + j;
      a = j < n ? av.l0 : av.l1;
    } else if (i == 2 * n) {
      x = bp.x0 - 1;
      y = bp.y0 - 1;
      a = av.c;
    } else {
      const int j = i - 2 * n - 1;
      x = bp.x0 + j;
      y = bp.y0 - 1;
      a = j < n ? av.t0 : av.t1;
    }
    // an unavailable sample is substituted: read it clamped into the plane
    x = x < 0 ? 0 : (x > bp.pw - 1 ? bp.pw - 1 : x);
    y = y < 0 ? 0 : (y > bp.ph - 1 ? bp.ph - 1 : y);
    sm.s[p][i] = bp.rec[y * bp.pw + x];
    sm.f[p][i] = a;
  }
  __syncthreads();
  if (threadIdx.x < 96 && (threadIdx.x & 31) == 0) {
    const int p = threadIdx.x >> 5;
    const int n = p == 0 ? NL : NC;
    substitute_serial<BD>(sm.s[p], sm.f[p], n);
    sm.dc[p] = dc_value(sm.s[p], n, 31 - __clz(n));
  }
  __syncthreads();
  for (int t = threadIdx.x; t < mAll; t += blockDim.x) {
    const int p = t < mL ? 0 : (t < mL + mC ? 1 : 2);
    const int i = p == 0 ? t : (p == 1 ? t - mL : t - mL - mC);
    sm.f[p][i] = smooth_121(sm.s[p], p == 0 ? mL : mC, i);
  }
  __syncthreads();
  constexpr int nnL = NL * NL, nnC = NC * NC;
  for (int t = threadIdx.x; t < nnL + 2 * nnC; t += blockDim.x) {
    const int p = t < nnL ? 0 : (t < nnL + nnC ? 1 : 2);
    const int i = p == 0 ? t : (p == 1 ? t - nnL : t - nnL - nnC);
    const int n = p == 0 ? NL : NC;
    const RefView r{sm.s[p], sm.f[p], n};
    sm.pred[p][i] = pred_sample<BD>(r, mode, p, 31 - __clz(n), sm.dc[p],
                                    i / n, i % n);
  }
  __syncthreads();
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (w == 0 && lane < NL)
    chain_plane<NL, BD, RDOQ_L>(sm, 0, b[0], sbh, w16, cr0, cc0);
  else if ((w == 1 || w == 2) && lane < NC)
    chain_plane<NC, BD, RDOQ_C>(sm, w, b[w], sbh, w16, cr0, cc0);
  __syncthreads();
}

// availability of quadrant q of a CTU with a left, top and top-right CTU
// (the same table for the intra tree's CU16s and the P/B commit's cells)
__device__ __forceinline__ Avail quad_avail(int q, bool left, bool top,
                                            bool tr) {
  switch (q) {
    case 0: return Avail{top, top, left, left, top && left};
    case 1: return Avail{top, tr, true, false, top};
    case 2: return Avail{true, true, left, false, left};
    default: return Avail{true, false, true, false, true};
  }
}

template <int BD, bool RDOQ>
__global__ void __launch_bounds__(kThreads)
    commit_kernel(const CommitArgs a, int d, int lo, int cnt) {
  __shared__ CommitSmem<RDOQ> sm;
  const int fi = blockIdx.x / cnt;
  const int cy = lo + blockIdx.x % cnt;
  const int cx = d - 2 * cy;
  const int bx = 2 * cx, by = 2 * cy;
  const bool left = cx > 0, top = cy > 0;
  const bool tr = top && cx < a.wc - 1;
  const int W = a.W, H = a.H, Wc = W / 2, Hc = H / 2;
  const size_t n16 = (size_t)a.h16 * a.w16;
  const int32_t* sy = a.src_y + (size_t)fi * H * W;
  const int32_t* scb = a.src_cb + (size_t)fi * Hc * Wc;
  const int32_t* scr = a.src_cr + (size_t)fi * Hc * Wc;
  int32_t* ry = a.rec_y + (size_t)fi * H * W;
  int32_t* rcb = a.rec_cb + (size_t)fi * Hc * Wc;
  int32_t* rcr = a.rec_cr + (size_t)fi * Hc * Wc;
  int16_t* ly = a.ly + (size_t)fi * n16 * 256;
  int16_t* lcb = a.lcb + (size_t)fi * n16 * 64;
  int16_t* lcr = a.lcr + (size_t)fi * n16 * 64;
  const int32_t* modes = a.modes + (size_t)fi * n16;
  const bool intra_tree = a.split != nullptr;
  const int i32 = cy * a.wc + cx;
  if (intra_tree && a.split[(size_t)fi * a.wc * a.hc + i32] == 0) {
    // one CU32: TU32 luma, TU16 chroma; below-left unavailable
    const Avail av{top, tr, left, false, top && left};
    const int mode = modes[by * a.w16 + bx];
    const Blk b[3] = {
        {sy, ry, ly, W, H, 32 * cx, 32 * cy, a.qp32[i32], 16, a.tab_y32,
         RDOQ ? a.lam32[i32] : 0.0f},
        {scb, rcb, lcb, Wc, Hc, 16 * cx, 16 * cy, a.qc32[i32], 8, nullptr,
         0.0f},
        {scr, rcr, lcr, Wc, Hc, 16 * cx, 16 * cy, a.qc32[i32], 8, nullptr,
         0.0f}};
    code_cell<32, BD, RDOQ, false>(sm, b, mode, av, a.sbh, a.w16, by, bx);
    return;
  }
  if (!intra_tree) {
    bool any = false;
    for (int q = 0; q < 4; ++q)
      any |= a.kinds[(size_t)fi * n16 + (by + (q >> 1)) * a.w16 + bx +
                     (q & 1)] == 2;
    if (!any) return;   // uniform across the block
  }
  for (int q = 0; q < 4; ++q) {
    const int rr = by + (q >> 1), cc = bx + (q & 1);
    const int c16 = rr * a.w16 + cc;
    if (!intra_tree && a.kinds[(size_t)fi * n16 + c16] != 2) continue;
    const Avail av = quad_avail(q, left, top, tr);
    const int mode = modes[c16];
    const float lam = RDOQ ? a.lam16[c16] : 0.0f;
    const Blk b[3] = {
        {sy, ry, ly, W, H, 16 * cc, 16 * rr, a.qp16[c16], 16, a.tab_y16, lam},
        {scb, rcb, lcb, Wc, Hc, 8 * cc, 8 * rr, a.qc16[c16], 8, a.tab_c8,
         lam},
        {scr, rcr, lcr, Wc, Hc, 8 * cc, 8 * rr, a.qc16[c16], 8, a.tab_c8,
         lam}};
    // the P/B commit's chroma takes RDOQ with the luma lambda (rdoq_chroma)
    if (RDOQ && a.rdoq_chroma)
      code_cell<16, BD, RDOQ, RDOQ>(sm, b, mode, av, a.sbh, a.w16, rr, cc);
    else
      code_cell<16, BD, RDOQ, false>(sm, b, mode, av, a.sbh, a.w16, rr, cc);
  }
}

template <int BD, bool RDOQ>
int launch_all(const CommitArgs& a, int* launches, cudaStream_t stream) {
  const int n_diags = a.wc - 1 + 2 * (a.hc - 1) + 1;
  for (int d = 0; d < n_diags; ++d) {
    // the CTUs (d - 2 cy, cy) of the frame on diagonal d
    int lo = d - a.wc + 1 > 0 ? (d - a.wc + 2) / 2 : 0;
    const int hi = d / 2 < a.hc - 1 ? d / 2 : a.hc - 1;
    if (hi < lo) continue;
    const int cnt = hi - lo + 1;
    commit_kernel<BD, RDOQ><<<a.F * cnt, kThreads, 0, stream>>>(a, d, lo,
                                                                cnt);
    ++*launches;
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace

extern "C" int commit_intra(const CommitArgs* args, int bd, int rdoq,
                            int* launches, cudaStream_t stream) {
  const CommitArgs& a = *args;
  *launches = 0;
  if (bd != 8 && bd != 10) return (int)cudaErrorInvalidValue;
  if (a.F < 1 || a.wc < 1 || a.hc < 1) return (int)cudaErrorInvalidValue;
  if ((a.split == nullptr) == (a.kinds == nullptr))
    return (int)cudaErrorInvalidValue;
  if (rdoq && (a.tab_y16 == nullptr || a.lam16 == nullptr ||
               (a.split != nullptr &&
                (a.tab_y32 == nullptr || a.lam32 == nullptr)) ||
               (a.rdoq_chroma && a.tab_c8 == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (bd == 8)
    return rdoq ? launch_all<8, true>(a, launches, stream)
                : launch_all<8, false>(a, launches, stream);
  return rdoq ? launch_all<10, true>(a, launches, stream)
              : launch_all<10, false>(a, launches, stream);
}
