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
// the forced mode (chroma at the same mode), then the residual chain with
// intra rounding and sign hiding: intra_chain.cuh's device functions,
// which K1 and K2 share.  With RDOQ the luma chains run K2's RDOQ stage
// (the intra tree: luma only, slice type I; the P/B commit also cb and cr
// with the luma lambda, JAX :883-906), a flag of the launch.
//
// Design: one launch per anti-diagonal d = cx + 2 cy of the CTU32 grid,
// enqueued back to back by one C call with no host sync between them; a
// thread block per (frame, CTU) of the diagonal, 256 threads.  A block
// runs its CTU's cells in z-order, each cell luma first, then cb and cr;
// __syncthreads() orders a cell's recon stores before the next cell's
// reference loads, and the launch order orders the diagonals.  A block
// whose CTU holds no intra cell returns at once (the P/B case, where intra
// cells are rare).  Recon planes are raster int32 [F, H, W] (chroma [F,
// H/2, W/2]), updated in place; levels are raster 16-cells, int16 [F, h16,
// w16, 16, 16] and [F, h16, w16, 8, 8] (a TU32's quadrants in its four
// cells), the layout the level pack (K15) reads.
//
// What bounds it on an H100: neither bytes (each source and recon sample
// read and written once) nor the transforms' integer operations (4 n^3
// multiply-adds a block); its time is the latency of one block's chain of
// cells per diagonal (126 diagonals at 1920x1088, 42 at 640x384).
//
// Entry point (plain C, caller's stream, returns cudaGetLastError() and the
// number of launches it enqueued in *launches):
//   commit_intra(const CommitArgs* args, int bd, int rdoq, int* launches,
//                cudaStream_t)

#include <cstdint>
#include <cuda_runtime.h>

#include "intra_chain.cuh"

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

using namespace intra_chain;

template <bool RDOQ>
struct CommitSmem {
  ChainSmem<RDOQ> ch;
  int pred[kMaxN * kMaxN];
  int s[kMaxSeq];
  int f[kMaxSeq];
  int dc;
};

// Availability of a block's reference runs: top (n), top-right (n), left
// (n), below-left (n), corner.
struct Avail {
  bool t0, t1, l0, l1, c;
};

// One block's intra chain on plane (rec, src) of width pw, height ph
// (frame-offset pointers): references at (x0, y0) read from rec, the
// prediction at `mode`, the chain, recon written back into rec and levels
// into the 16-cell layout at cell (cr0, cc0), cs x cs samples a cell.
template <int BD, bool RDOQ_CHAIN, class Smem>
__device__ void code_block(Smem& sm, const int32_t* src, int32_t* rec,
                           int pw, int ph, int x0, int y0, int n, int c_idx,
                           int mode, const Avail& av, int qp, int sbh,
                           const float* tab, float lam, int16_t* lv_frame,
                           int w16, int cr0, int cc0, int cs) {
  const int m = 4 * n + 1;
  // reference scan: left[2n-1 .. 0], corner, top[0 .. 2n-1]
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    int x, y;
    bool a;
    if (i < 2 * n) {
      const int j = 2 * n - 1 - i;
      x = x0 - 1;
      y = y0 + j;
      a = j < n ? av.l0 : av.l1;
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
    // an unavailable sample is substituted: read it clamped into the plane
    x = x < 0 ? 0 : (x > pw - 1 ? pw - 1 : x);
    y = y < 0 ? 0 : (y > ph - 1 ? ph - 1 : y);
    sm.s[i] = rec[y * pw + x];
    sm.f[i] = a;
  }
  __syncthreads();
  substitute_smooth<BD>(sm.s, sm.f, n);
  const int log2n = 31 - __clz(n);
  if (threadIdx.x == 0) sm.dc = dc_value(sm.s, n, log2n);
  __syncthreads();
  const RefView r{sm.s, sm.f, n};
  const int dc = sm.dc;
  for (int i = threadIdx.x; i < n * n; i += blockDim.x)
    sm.pred[i] = pred_sample<BD>(r, mode, c_idx, log2n, dc, i / n, i % n);
  __syncthreads();
  int32_t* out = rec + y0 * pw + x0;
  chain<BD, RDOQ_CHAIN>(
      sm.ch, src + y0 * pw + x0, pw, sm.pred, n, n, qp, sbh, 1, tab, lam,
      [&](int i, int v) {
        const int y = i / n, x = i % n;
        const size_t cell = (size_t)(cr0 + y / cs) * w16 + cc0 + x / cs;
        lv_frame[cell * cs * cs + (y % cs) * cs + x % cs] = (int16_t)v;
      },
      [&](int i, int v) { out[(i / n) * pw + i % n] = v; });
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
__global__ void commit_kernel(const CommitArgs a, int d, int lo, int cnt) {
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
    code_block<BD, RDOQ>(sm, sy, ry, W, H, 32 * cx, 32 * cy, 32, 0, mode, av,
                         a.qp32[i32], a.sbh, a.tab_y32,
                         RDOQ ? a.lam32[i32] : 0.0f, ly, a.w16, by, bx, 16);
    code_block<BD, false>(sm, scb, rcb, Wc, Hc, 16 * cx, 16 * cy, 16, 1,
                          mode, av, a.qc32[i32], a.sbh, nullptr, 0.0f, lcb,
                          a.w16, by, bx, 8);
    code_block<BD, false>(sm, scr, rcr, Wc, Hc, 16 * cx, 16 * cy, 16, 2,
                          mode, av, a.qc32[i32], a.sbh, nullptr, 0.0f, lcr,
                          a.w16, by, bx, 8);
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
    code_block<BD, RDOQ>(sm, sy, ry, W, H, 16 * cc, 16 * rr, 16, 0, mode, av,
                         a.qp16[c16], a.sbh, a.tab_y16, lam, ly, a.w16, rr,
                         cc, 16);
    if constexpr (RDOQ) {
      if (a.rdoq_chroma) {
        code_block<BD, true>(sm, scb, rcb, Wc, Hc, 8 * cc, 8 * rr, 8, 1,
                             mode, av, a.qc16[c16], a.sbh, a.tab_c8, lam,
                             lcb, a.w16, rr, cc, 8);
        code_block<BD, true>(sm, scr, rcr, Wc, Hc, 8 * cc, 8 * rr, 8, 2,
                             mode, av, a.qc16[c16], a.sbh, a.tab_c8, lam,
                             lcr, a.w16, rr, cc, 8);
        continue;
      }
    }
    {
      code_block<BD, false>(sm, scb, rcb, Wc, Hc, 8 * cc, 8 * rr, 8, 1, mode,
                            av, a.qc16[c16], a.sbh, nullptr, 0.0f, lcb,
                            a.w16, rr, cc, 8);
      code_block<BD, false>(sm, scr, rcr, Wc, Hc, 8 * cc, 8 * rr, 8, 2, mode,
                            av, a.qc16[c16], a.sbh, nullptr, 0.0f, lcr,
                            a.w16, rr, cc, 8);
    }
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
    commit_kernel<BD, RDOQ><<<a.F * cnt, 256, 0, stream>>>(a, d, lo, cnt);
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
