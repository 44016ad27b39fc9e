// Kernel K17 `decide_p`: the whole decide scan of a P frame (CTU32 quadtree,
// 1 to 4 L0 references) in one launch.
//
// Replaces, from the JAX package: models/inter_tree.py, the `lax.scan` of
// `decide_body` (:336-544) over the anti-diagonals of the CTU32 grid.  Each
// CTU of a diagonal decides, from the motion already committed by earlier
// diagonals (spec 8.5.3.2 z-scan availability): one CU32 (skip on merge
// candidate 0 or 1, or AMVP inter; no intra at 32), then its four CU16
// quadrants in z-order (skip, AMVP inter or intra), the later quadrants
// reading the earlier ones' results; then split against no split by RD
// cost, and commits the cells' motion.  Merge candidates are pruned on (MV,
// reference); AMVP scales a neighbour's MV to the CU's reference through
// dsf (spec 8.5.3.2.8, JAX `scale_to` :355); the inter cost carries the
// ref_idx bins; a skip candidate is priced from the SSD grid of its own
// reference (its half-pel grid when it is sub-pel): row base + (sub R + r)
// n + idx of the stacked grids.
//
// Three costs take an FMA where XLA's CPU code contracts a product with one
// use into the add that follows it (read from the decide body's optimized
// HLO and LLVM IR; the plain version uses an exact f32 fma):
//   j_inter = fma(lam, ((rb + min(b0, b1)) + refbits[ref]) + 6, d)
//   j_skip  = fma(lam, 2 or 3, grid value or 1e18 outside the window)
//   j_intra = fma(lam, intra header bits, intra trial cost)
// The file is built with --fmad=false so that nothing else contracts.
//
// Design: one thread block; thread j is lane j of the current diagonal
// (one CTU32).  The block loops over the diagonals with __syncthreads()
// between them; the committed motion (MV, inter flag, reference per 16x16
// cell, int32 each: 16 bytes a cell, 59 KB at 1280x736, 131 KB at
// 1920x1088) lives in a global scratch the wrapper allocates, which the
// one SM's L1 holds (a block's global writes are visible to its threads
// after __syncthreads(); on an H100 this timed no slower than shared memory
// at 720p and within 4 % of it at 1080p).  Every input and output is in raster
// order.  A forced mode replays given decisions
// (choice, MVD, MVP index, reference per CU, split per CTU) through the same
// candidate derivation.
//
// What bounds it on an H100: neither bytes nor operations (it reads each
// SSD-grid entry it needs once, a few thousand of the 9.6 MB at 720p, R 1,
// sr 8); its time is the latency of one thread's chain of dependent steps
// per diagonal times the number of diagonals (84 at 1280x736, 126 at
// 1920x1088).  The device helpers it shares with K19 (`decide_b.cu`) are
// in decide_common.cuh.
//
// Entry point (plain C, caller's stream, returns cudaGetLastError()):
//   decide_p(const DecideArgs* args, cudaStream_t stream)

#include <cstdint>
#include <cuda_runtime.h>

#include "decide_common.cuh"

extern "C" {
struct DecideArgs {
  // geometry
  int wc, hc, w16, h16, n_diags, bmax, sr, R;
  // stacked SSD grids [rows, S, S] f32 (rows = 2 R (n16 + n32))
  const float* grid;
  // phase-1 outputs per CTU32 and per 16-cell (raster)
  const float *d32, *rb32, *lam32;
  const int32_t *mv32, *ref32;
  const float *d16, *rb16, *di16, *lam16;
  const int32_t *mv16, *ref16;
  // reference tables: dsf [R, R] (dsf[j * R + i] scales a neighbour's MV on
  // reference j to reference i), ref_idx bins [R]
  const int32_t* dsf;
  const float* refbits;
  float intra_hdr_bits;
  // wavefront schedule: slot -> raster CTU, diagonal d holds slots
  // diag_off[d] .. diag_off[d + 1] - 1
  const int32_t *slot_ctu, *diag_off;
  // forced mode (all null when free): choice, MVD, MVP index and reference
  // per CU16 cell and per CTU (the CU32 hypothesis), split per CTU
  const int32_t *f_ch16, *f_mvd16, *f_mvp16, *f_ref16;
  const int32_t *f_ch32, *f_mvd32, *f_mvp32, *f_ref32, *f_split;
  // outputs (raster)
  int32_t *split, *ch32, *mvd32, *mvp32, *ref32_out;
  int32_t *chq, *mvdq, *mvpq, *refq, *mv_cell, *ref_cell;
  // optional cost rows (null unless wanted)
  float *jsq, *js32, *jsplit, *j32;
  // global scratch for the motion maps, 4 * w16 * h16 int32
  int32_t* maps;
};
}

namespace {

using decide::mvd_bits;
using decide::scale_mv;

struct Cand {
  bool av;
  int mx, my, rf;
};

struct Decision {
  int choice, mx, my, rf, mvdx, mvdy, mvp;
  float js[4];
  float j;
};

struct Maps {
  int32_t *mv, *inter, *ref;

  __device__ Cand nb(decide::NbPos p) const {
    Cand r;
    r.av = p.ok && inter[p.cell] != 0;
    r.mx = r.av ? mv[2 * p.cell] : 0;
    r.my = r.av ? mv[2 * p.cell + 1] : 0;
    r.rf = r.av ? ref[p.cell] : 0;
    return r;
  }
};

__device__ __forceinline__ Cand local(const Decision& d) {
  Cand c;
  c.av = d.choice <= 2;
  c.mx = d.mx;
  c.my = d.my;
  c.rf = d.rf;
  return c;
}

__device__ __forceinline__ bool same(const Cand& a, const Cand& b) {
  return a.mx == b.mx && a.my == b.my && a.rf == b.rf;
}

// One CU decision (JAX decide_cu :363-476).  row: the CU's grid row base +
// idx; ngrid: rows per (sub-pel phase, reference) block.  forced >= 0 gives
// the choice to replay (with fmvd, fmvp, fref).
__device__ Decision decide_cu(const DecideArgs& a, const Cand c[4],
                              bool with_intra, int64_t row, int ngrid,
                              float dd, float rbd, int mex, int mey,
                              int refme, float lamv, float di, int forced,
                              int fmvdx, int fmvdy, int fmvp, int fref) {
  // merge list: B1 pruned against A1, B0 against B1, B2 against A1 and B1
  bool m_av[4];
  m_av[0] = c[0].av;
  m_av[1] = c[1].av && !(c[0].av && same(c[1], c[0]));
  m_av[2] = c[2].av && !(c[1].av && same(c[2], c[1]));
  m_av[3] = c[3].av && !(c[0].av && same(c[3], c[0])) &&
            !(c[1].av && same(c[3], c[1]));
  int mrg_x[2] = {0, 0}, mrg_y[2] = {0, 0}, mrg_r[2] = {0, 0};
  int k = 0;
  for (int i = 0; i < 4; ++i) {
    if (m_av[i] && k < 2) {
      mrg_x[k] = c[i].mx;
      mrg_y[k] = c[i].my;
      mrg_r[k] = c[i].rf;
      ++k;
    }
  }
  // AMVP: A = A1, B = first of (B0, B1, B2), each scaled to the CU's
  // reference; B pruned against A
  const int cur = forced >= 0 ? fref : refme;
  const int R = a.R;
  const bool avb = c[1].av || c[2].av || c[3].av;
  const Cand& cb = c[2].av ? c[2] : (c[1].av ? c[1] : c[3]);
  int sax = c[0].mx, say = c[0].my, sbx = cb.mx, sby = cb.my;
  if (c[0].rf != cur) {
    const int f = a.dsf[c[0].rf * R + cur];
    sax = scale_mv(sax, f);
    say = scale_mv(say, f);
  }
  if (cb.rf != cur) {
    const int f = a.dsf[cb.rf * R + cur];
    sbx = scale_mv(sbx, f);
    sby = scale_mv(sby, f);
  }
  const bool dup = sbx == sax && sby == say;
  const int a0x = c[0].av ? sax : (avb ? sbx : 0);
  const int a0y = c[0].av ? say : (avb ? sby : 0);
  const bool a1ok = c[0].av && avb && !dup;
  const int a1x = a1ok ? sbx : 0, a1y = a1ok ? sby : 0;
  Decision o;
  if (forced >= 0) {
    o.choice = forced;
    o.mvdx = fmvdx;
    o.mvdy = fmvdy;
    o.mvp = fmvp == 1;
    const int px = fmvp == 1 ? a1x : a0x, py = fmvp == 1 ? a1y : a0y;
    if (forced <= 1) {
      o.mx = mrg_x[forced];
      o.my = mrg_y[forced];
      o.rf = mrg_r[forced];
    } else if (forced == 2) {
      o.mx = px + fmvdx;
      o.my = py + fmvdy;
      o.rf = fref;
    } else {
      o.mx = o.my = o.rf = 0;
    }
    for (int i = 0; i < 4; ++i) o.js[i] = 0.0f;
    o.j = 0.0f;
    return o;
  }
  const int d0x = mex - a0x, d0y = mey - a0y;
  const int d1x = mex - a1x, d1y = mey - a1y;
  const float b0 = mvd_bits(d0x, d0y), b1 = mvd_bits(d1x, d1y);
  const bool use1 = b1 < b0;
  o.mvdx = use1 ? d1x : d0x;
  o.mvdy = use1 ? d1y : d0y;
  o.mvp = use1;
  const float m = b1 < b0 ? b1 : b0;
  const float x = ((rbd + m) + a.refbits[refme]) + 6.0f;
  const float j_inter = __fmaf_rn(lamv, x, dd);
  for (int i = 0; i < 2; ++i) {
    const bool sub = decide::sub_pel(mrg_x[i], mrg_y[i]);
    const int64_t r = row + (int64_t)((sub ? R : 0) + mrg_r[i]) * ngrid;
    const float v = decide::grid_at(a.grid, r, a.sr, mrg_x[i], mrg_y[i]);
    o.js[i] = __fmaf_rn(lamv, i == 0 ? 2.0f : 3.0f, v);
  }
  o.js[2] = j_inter;
  o.js[3] = with_intra ? __fmaf_rn(lamv, a.intra_hdr_bits, di)
                       : __int_as_float(0x7f800000);  // +inf
  int best = 0;
  for (int i = 1; i < 4; ++i)
    if (o.js[i] < o.js[best]) best = i;
  o.choice = best;
  o.j = o.js[best];
  if (best <= 1) {
    o.mx = mrg_x[best];
    o.my = mrg_y[best];
    o.rf = mrg_r[best];
  } else if (best == 2) {
    o.mx = mex;
    o.my = mey;
    o.rf = refme;
  } else {
    o.mx = o.my = o.rf = 0;
  }
  return o;
}

__global__ void decide_kernel(const DecideArgs a) {
  const int cells = a.w16 * a.h16;
  int32_t* base = a.maps;
  Maps mp;
  mp.mv = base;
  mp.inter = base + 2 * cells;
  mp.ref = base + 3 * cells;
  const int w16 = a.w16, h16 = a.h16;
  for (int i = threadIdx.x; i < 4 * cells; i += blockDim.x) base[i] = 0;
  __syncthreads();
  const int n16 = cells, n32 = a.wc * a.hc;
  const bool forced = a.f_ch16 != nullptr;
  const int64_t base32 = (int64_t)2 * a.R * n16;
  for (int d = 0; d < a.n_diags; ++d) {
    const int s0 = a.diag_off[d], cnt = a.diag_off[d + 1] - s0;
    const int lane = threadIdx.x;
    if (lane < cnt) {
      const int i32 = a.slot_ctu[s0 + lane];
      const int cx = i32 % a.wc, cy = i32 / a.wc;
      const int bx = 2 * cx, by = 2 * cy;
      const bool left = cx > 0, top = cy > 0;
      const bool tr = top && cx < a.wc - 1;
      const int q16[4] = {by * a.w16 + bx, by * a.w16 + bx + 1,
                          (by + 1) * a.w16 + bx, (by + 1) * a.w16 + bx + 1};
      // hypothesis A: one CU32
      Cand c[4];
      for (int k = 0; k < 4; ++k)
        c[k] = mp.nb(decide::nb_cu32(k, bx, by, left, top, tr, w16, h16));
      Decision r32 = forced
          ? decide_cu(a, c, false, base32 + i32, n32, 0.f, 0.f, 0, 0, 0, 0.f,
                      0.f, a.f_ch32[i32], a.f_mvd32[2 * i32],
                      a.f_mvd32[2 * i32 + 1], a.f_mvp32[i32],
                      a.f_ref32[i32])
          : decide_cu(a, c, false, base32 + i32, n32, a.d32[i32],
                      a.rb32[i32], a.mv32[2 * i32], a.mv32[2 * i32 + 1],
                      a.ref32[i32], a.lam32[i32], 0.f, -1, 0, 0, 0, 0);
      // hypothesis B: four CU16 quadrants in z-order
      Decision q[4];
      for (int k = 0; k < 4; ++k) {
        auto ext = [&](int j) {
          return mp.nb(decide::nb_quad(k, j, bx, by, left, top, tr, w16,
                                       h16));
        };
        if (k == 0) {
          for (int j = 0; j < 4; ++j) c[j] = ext(j);
        } else if (k == 1) {
          c[0] = local(q[0]);
          c[1] = ext(1);
          c[2] = ext(2);
          c[3] = ext(3);
        } else if (k == 2) {
          c[0] = ext(0);
          c[1] = local(q[0]);
          c[2] = local(q[1]);
          c[3] = ext(3);
        } else {
          c[0] = local(q[2]);
          c[1] = local(q[1]);
          c[2].av = false;
          c[2].mx = c[2].my = c[2].rf = 0;
          c[3] = local(q[0]);
        }
        const int i = q16[k];
        q[k] = forced
            ? decide_cu(a, c, true, i, n16, 0.f, 0.f, 0, 0, 0, 0.f, 0.f,
                        a.f_ch16[i], a.f_mvd16[2 * i], a.f_mvd16[2 * i + 1],
                        a.f_mvp16[i], a.f_ref16[i])
            : decide_cu(a, c, true, i, n16, a.d16[i], a.rb16[i],
                        a.mv16[2 * i], a.mv16[2 * i + 1], a.ref16[i],
                        a.lam16[i], a.di16[i], -1, 0, 0, 0, 0);
      }
      bool split;
      if (forced) {
        split = a.f_split[i32] != 0;
      } else {
        const float js = ((q[0].j + q[1].j) + q[2].j) + q[3].j;
        split = js < r32.j;
        if (a.jsplit != nullptr) {
          a.jsplit[i32] = js;
          a.j32[i32] = r32.j;
        }
      }
      a.split[i32] = split;
      a.ch32[i32] = r32.choice;
      a.mvd32[2 * i32] = r32.mvdx;
      a.mvd32[2 * i32 + 1] = r32.mvdy;
      a.mvp32[i32] = r32.mvp;
      a.ref32_out[i32] = r32.rf;
      if (a.js32 != nullptr)
        for (int t = 0; t < 4; ++t) a.js32[4 * i32 + t] = r32.js[t];
      for (int k = 0; k < 4; ++k) {
        const int i = q16[k];
        a.chq[i] = q[k].choice;
        a.mvdq[2 * i] = q[k].mvdx;
        a.mvdq[2 * i + 1] = q[k].mvdy;
        a.mvpq[i] = q[k].mvp;
        a.refq[i] = q[k].rf;
        if (a.jsq != nullptr)
          for (int t = 0; t < 4; ++t) a.jsq[4 * i + t] = q[k].js[t];
        const int mx = split ? q[k].mx : r32.mx;
        const int my = split ? q[k].my : r32.my;
        const int rf = split ? q[k].rf : r32.rf;
        a.mv_cell[2 * i] = mx;
        a.mv_cell[2 * i + 1] = my;
        a.ref_cell[i] = rf;
        mp.mv[2 * i] = mx;
        mp.mv[2 * i + 1] = my;
        mp.ref[i] = rf;
        mp.inter[i] = split ? q[k].choice <= 2 : 1;
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int decide_p(const DecideArgs* args, cudaStream_t stream) {
  const DecideArgs& a = *args;
  if (a.R < 1 || a.R > 4 || a.bmax < 1 || a.bmax > 1024)
    return (int)cudaErrorInvalidValue;
  const int threads = ((a.bmax + 31) / 32) * 32;
  decide_kernel<<<1, threads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}
