// Kernel K19 `decide_b`: the whole decide scan of a B frame (CTU32
// quadtree, one reference per list) in one launch.
//
// Replaces, from the JAX package: models/inter_tree.py, the `lax.scan` of
// the B tree's `decide_body` (:1317-1570) over the anti-diagonals of the
// CTU32 grid.  Each CTU of a diagonal decides, from the motion already
// committed by earlier diagonals (spec 8.5.3.2 z-scan availability): one CU32
// (skip on merge candidate 0 or 1, or AMVP inter on L0, L1 or bi; no intra
// at 32), then its four CU16 quadrants in z-order (the same five options
// and intra), the later quadrants reading the earlier ones' results; then
// split against no split by RD cost, and commits each 16-cell's direction
// and MVs.  Merge candidates are pruned on (direction, MV0, MV1) and the
// list is filled with zero-bi candidates (direction 3, zero MVs); the AMVP
// pair of each list takes a neighbour's own-list MV, or its other-list MV
// scaled by that list's dsf (spec 8.5.3.2.8, JAX `amvp` :1370-1403), and
// `pick_mvp` takes the one with fewer MVD bins.  A skip candidate is priced
// from the SSD grids of the lists it uses (the half-pel grid for a sub-pel
// MV, the mean of both lists' for bi): row base + sub n + idx of each list's
// stacked grids [CU16 integer, CU16 half-pel, CU32 integer, CU32 half-pel].
//
// The six costs take an FMA where XLA's CPU code contracts a product whose
// one use is the add after it (the decide fusion's object code has a
// vfmadd for each; the plain version uses an exact f32 fma):
//   j_skip_k = fma(lam, 2 or 3, grid value, or 0.5 (l0 + l1) for bi)
//   j_l0     = fma(lam, (rb_l0 + bits0) + 8, d_l0)
//   j_l1     = fma(lam, (rb_l1 + bits1) + 8, d_l1)
//   j_bi     = fma(lam, ((rb_bi + bits0) + bits1) + 10, d_bi)
//   j_intra  = fma(lam, intra header bits, intra trial cost)
// The file is built with --fmad=false so that nothing else contracts.
//
// Design (K17's): one thread block; thread j is lane j of the current
// diagonal (one CTU32, at most 34 lanes at 1920x1088).  The block loops
// over the diagonals with __syncthreads() between them; the committed motion
// (direction, MV0, MV1 per 16x16 cell, int32 each: 20 bytes a cell, 163 KB
// at 1920x1088) lives in a global scratch the wrapper allocates, which the
// one SM's L1 holds.  Every input and output is in raster order.  A forced
// mode replays given decisions (choice, MVDs and MVP indices of both lists
// per CU, split per CTU) through the same candidate derivation.
//
// What bounds it on an H100: neither bytes nor operations (it reads the few
// SSD-grid entries its merge candidates need, two per list and CU, of the
// 71 MB of grids at 1080p, sr 16); its time is the latency of one thread's
// chain of dependent steps per diagonal times the number of diagonals (126
// at 1920x1088).
//
// Entry point (plain C, caller's stream, returns cudaGetLastError()):
//   decide_b(const DecideBArgs* args, cudaStream_t stream)

#include <cstdint>
#include <cuda_runtime.h>

#include "decide_common.cuh"

extern "C" {
struct DecideBArgs {
  // geometry; dsf0 / dsf1 scale a neighbour's other-list MV to list 0 / 1
  int wc, hc, w16, h16, n_diags, bmax, sr, dsf0, dsf1;
  // the stacked SSD grids of list 0 and list 1, [2 (n16 + n32), S, S] f32
  const float *grid0, *grid1;
  // phase-1 outputs per CTU32 and per 16-cell (raster): d and rb [., 3]
  // (L0, L1, bi), the ME MVs of both lists [., 2], lambda, intra cost
  const float *d32, *rb32, *lam32;
  const int32_t *mv0_32, *mv1_32;
  const float *d16, *rb16, *di16, *lam16;
  const int32_t *mv0_16, *mv1_16;
  float intra_hdr_bits;
  // wavefront schedule: slot -> raster CTU, diagonal d holds slots
  // diag_off[d] .. diag_off[d + 1] - 1
  const int32_t *slot_ctu, *diag_off;
  // forced mode (all null when free): choice, MVD and MVP index of each
  // list per CU16 cell and per CTU (the CU32 hypothesis), split per CTU
  const int32_t *f_ch16, *f_mvd0_16, *f_mvp0_16, *f_mvd1_16, *f_mvp1_16;
  const int32_t *f_ch32, *f_mvd0_32, *f_mvp0_32, *f_mvd1_32, *f_mvp1_32;
  const int32_t* f_split;
  // outputs (raster)
  int32_t *split, *ch32, *mvd0_32, *mvp0_32, *mvd1_32, *mvp1_32;
  int32_t *chq, *mvd0q, *mvp0q, *mvd1q, *mvp1q, *dir, *mv0, *mv1;
  // optional cost rows [., 6] and split costs (null unless wanted)
  float *jsq, *js32, *jsplit, *j32;
  // global scratch for the motion maps, 5 * w16 * h16 int32
  int32_t* maps;
};
}

namespace {

using decide::mvd_bits;
using decide::scale_mv;

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

// a merge / AMVP candidate: availability, direction (bit 0 L0, bit 1 L1)
// and both MVs
struct Cand {
  bool av;
  int dir, m0x, m0y, m1x, m1y;
};

struct Decision {
  int choice, dir, m0x, m0y, m1x, m1y;
  int mvd0x, mvd0y, mvp0, mvd1x, mvd1y, mvp1;
  float js[6];
  float j;
};

struct Maps {
  int32_t *dir, *mv0, *mv1;

  __device__ Cand nb(decide::NbPos p) const {
    Cand r;
    r.av = p.ok && dir[p.cell] > 0;
    r.dir = r.av ? dir[p.cell] : 0;
    r.m0x = r.av ? mv0[2 * p.cell] : 0;
    r.m0y = r.av ? mv0[2 * p.cell + 1] : 0;
    r.m1x = r.av ? mv1[2 * p.cell] : 0;
    r.m1y = r.av ? mv1[2 * p.cell + 1] : 0;
    return r;
  }
};

__device__ __forceinline__ Cand local(const Decision& d) {
  return Cand{d.choice <= 4, d.dir, d.m0x, d.m0y, d.m1x, d.m1y};
}

__device__ __forceinline__ bool same(const Cand& a, const Cand& b) {
  return a.dir == b.dir && a.m0x == b.m0x && a.m0y == b.m0y &&
         a.m1x == b.m1x && a.m1y == b.m1y;
}

// the MV of list li (own) and of the other list of candidate x
__device__ __forceinline__ void own_mv(const Cand& x, int li, int& vx,
                                       int& vy) {
  vx = li == 0 ? x.m0x : x.m1x;
  vy = li == 0 ? x.m0y : x.m1y;
}

// candidate x's predictor for list li: its own MV when it holds list li,
// else its other-list MV scaled by dsf (JAX `mvp_of`)
__device__ __forceinline__ void mvp_of(const Cand& x, int li, int dsf,
                                       int& vx, int& vy) {
  if ((x.dir >> li) & 1) {
    own_mv(x, li, vx, vy);
  } else {
    int ox, oy;
    own_mv(x, 1 - li, ox, oy);
    vx = scale_mv(ox, dsf);
    vy = scale_mv(oy, dsf);
  }
}

// AMVP pair of list li (JAX `amvp` :1370-1403): A from A1; B the first of
// B0, B1, B2 holding list li unscaled, else the first available scaled;
// pruned and zero-filled.
__device__ void amvp(const Cand c[4], int li, int dsf, int p[4]) {
  int cax = 0, cay = 0;
  const bool ca_v = c[0].av;
  if (ca_v) mvp_of(c[0], li, dsf, cax, cay);
  const int order[3] = {2, 1, 3};     // B0, B1, B2
  bool bp1_v = false, bs_v = false;
  int bp1x = 0, bp1y = 0, bsx = 0, bsy = 0;
  for (int k = 0; k < 3; ++k) {
    const Cand& x = c[order[k]];
    if (!bp1_v && x.av && ((x.dir >> li) & 1)) {
      bp1_v = true;
      own_mv(x, li, bp1x, bp1y);
    }
    if (!bs_v && x.av) {
      bs_v = true;
      mvp_of(x, li, dsf, bsx, bsy);
    }
  }
  int c0x, c0y;
  if (ca_v) {
    c0x = cax;
    c0y = cay;
  } else if (bp1_v) {
    c0x = bp1x;
    c0y = bp1y;
  } else if (bs_v) {
    c0x = bsx;
    c0y = bsy;
  } else {
    c0x = c0y = 0;
  }
  int c1x = 0, c1y = 0;
  bool c1_v;
  if (ca_v) {
    c1_v = bp1_v;
    if (bp1_v) {
      c1x = bp1x;
      c1y = bp1y;
    }
  } else {
    c1_v = bp1_v && bs_v;
    if (c1_v) {
      c1x = bsx;
      c1y = bsy;
    }
  }
  const bool keep = c1_v && !(c1x == c0x && c1y == c0y);
  p[0] = c0x;
  p[1] = c0y;
  p[2] = keep ? c1x : 0;
  p[3] = keep ? c1y : 0;
}

// Per-CU inputs of a free decision.
struct CuIn {
  const float *d, *rb;      // [3]: L0, L1, bi
  int m0x, m0y, m1x, m1y;   // the ME MVs of both lists
  float lam, di;
  bool with_intra;
};

// One B CU decision (JAX decide_cu :1336-1462).  row: the CU's grid row;
// ngrid: the offset of the half-pel grids.  forced >= 0 gives the choice to
// replay with f = (mvd0x, mvd0y, mvp0, mvd1x, mvd1y, mvp1).
__device__ Decision decide_cu(const DecideBArgs& a, const Cand c[4],
                              int64_t row, int ngrid, const CuIn& in,
                              int forced, const int f[6]) {
  // merge list: B1 pruned against A1, B0 against B1, B2 against A1 and B1;
  // the first two kept, the rest of the list zero-bi
  bool m_av[4];
  m_av[0] = c[0].av;
  m_av[1] = c[1].av && !(c[0].av && same(c[1], c[0]));
  m_av[2] = c[2].av && !(c[1].av && same(c[2], c[1]));
  m_av[3] = c[3].av && !(c[0].av && same(c[3], c[0])) &&
            !(c[1].av && same(c[3], c[1]));
  Cand mrg[2];
  mrg[0] = mrg[1] = Cand{true, 3, 0, 0, 0, 0};
  int k = 0;
  for (int i = 0; i < 4; ++i) {
    if (m_av[i] && k < 2) mrg[k++] = c[i];
  }
  int p0[4], p1[4];
  amvp(c, 0, a.dsf0, p0);
  amvp(c, 1, a.dsf1, p1);
  Decision o;
  int me0x, me0y, me1x, me1y;
  if (forced >= 0) {
    o.choice = forced;
    o.mvd0x = f[0];
    o.mvd0y = f[1];
    o.mvp0 = f[2];
    o.mvd1x = f[3];
    o.mvd1y = f[4];
    o.mvp1 = f[5];
    me0x = (f[2] == 1 ? p0[2] : p0[0]) + f[0];
    me0y = (f[2] == 1 ? p0[3] : p0[1]) + f[1];
    me1x = (f[5] == 1 ? p1[2] : p1[0]) + f[3];
    me1y = (f[5] == 1 ? p1[3] : p1[1]) + f[4];
    for (int i = 0; i < 6; ++i) o.js[i] = 0.0f;
    o.j = 0.0f;
  } else {
    me0x = in.m0x;
    me0y = in.m0y;
    me1x = in.m1x;
    me1y = in.m1y;
    // pick_mvp per list: the predictor with fewer MVD bins, A on a tie
    const int d00x = me0x - p0[0], d00y = me0y - p0[1];
    const int d01x = me0x - p0[2], d01y = me0y - p0[3];
    const float b00 = mvd_bits(d00x, d00y), b01 = mvd_bits(d01x, d01y);
    o.mvp0 = b01 < b00;
    o.mvd0x = o.mvp0 ? d01x : d00x;
    o.mvd0y = o.mvp0 ? d01y : d00y;
    const float bits0 = b01 < b00 ? b01 : b00;
    const int d10x = me1x - p1[0], d10y = me1y - p1[1];
    const int d11x = me1x - p1[2], d11y = me1y - p1[3];
    const float b10 = mvd_bits(d10x, d10y), b11 = mvd_bits(d11x, d11y);
    o.mvp1 = b11 < b10;
    o.mvd1x = o.mvp1 ? d11x : d10x;
    o.mvd1y = o.mvp1 ? d11y : d10y;
    const float bits1 = b11 < b10 ? b11 : b10;
    const float lamv = in.lam;
    for (int i = 0; i < 2; ++i) {
      const Cand& m = mrg[i];
      const float l0 = decide::grid_at(
          a.grid0, row + (decide::sub_pel(m.m0x, m.m0y) ? ngrid : 0), a.sr,
          m.m0x, m.m0y);
      const float l1 = decide::grid_at(
          a.grid1, row + (decide::sub_pel(m.m1x, m.m1y) ? ngrid : 0), a.sr,
          m.m1x, m.m1y);
      const float v = m.dir == 3 ? __fmul_rn(0.5f, __fadd_rn(l0, l1))
                                 : (m.dir == 1 ? l0 : l1);
      o.js[i] = __fmaf_rn(lamv, i == 0 ? 2.0f : 3.0f, v);
    }
    o.js[2] = __fmaf_rn(lamv, __fadd_rn(__fadd_rn(in.rb[0], bits0), 8.0f),
                        in.d[0]);
    o.js[3] = __fmaf_rn(lamv, __fadd_rn(__fadd_rn(in.rb[1], bits1), 8.0f),
                        in.d[1]);
    o.js[4] = __fmaf_rn(
        lamv,
        __fadd_rn(__fadd_rn(__fadd_rn(in.rb[2], bits0), bits1), 10.0f),
        in.d[2]);
    o.js[5] = in.with_intra ? __fmaf_rn(lamv, a.intra_hdr_bits, in.di)
                            : inf();
    int best = 0;
    for (int i = 1; i < 6; ++i)
      if (o.js[i] < o.js[best]) best = i;
    o.choice = best;
    o.j = o.js[best];
  }
  // the final direction and MVs: a merge choice takes its candidate's, an
  // AMVP choice its list(s) of the ME (or replayed) MVs, intra none
  const int ch = o.choice;
  o.dir = ch <= 1 ? mrg[ch].dir : (ch == 2 ? 1 : (ch == 3 ? 2 : (ch == 4 ? 3
                                                                      : 0)));
  const int v0x = ch <= 1 ? mrg[ch].m0x : me0x;
  const int v0y = ch <= 1 ? mrg[ch].m0y : me0y;
  const int v1x = ch <= 1 ? mrg[ch].m1x : me1x;
  const int v1y = ch <= 1 ? mrg[ch].m1y : me1y;
  o.m0x = (o.dir & 1) ? v0x : 0;
  o.m0y = (o.dir & 1) ? v0y : 0;
  o.m1x = (o.dir & 2) ? v1x : 0;
  o.m1y = (o.dir & 2) ? v1y : 0;
  return o;
}

__device__ __forceinline__ void forced_of(const int32_t* ch,
                                          const int32_t* mvd0,
                                          const int32_t* mvp0,
                                          const int32_t* mvd1,
                                          const int32_t* mvp1, int i,
                                          int& choice, int f[6]) {
  choice = ch[i];
  f[0] = mvd0[2 * i];
  f[1] = mvd0[2 * i + 1];
  f[2] = mvp0[i];
  f[3] = mvd1[2 * i];
  f[4] = mvd1[2 * i + 1];
  f[5] = mvp1[i];
}

__global__ void decide_b_kernel(const DecideBArgs a) {
  const int cells = a.w16 * a.h16;
  int32_t* base = a.maps;
  Maps mp;
  mp.dir = base;
  mp.mv0 = base + cells;
  mp.mv1 = base + 3 * cells;
  const int w16 = a.w16, h16 = a.h16;
  for (int i = threadIdx.x; i < 5 * cells; i += blockDim.x) base[i] = 0;
  __syncthreads();
  const int n16 = cells, n32 = a.wc * a.hc;
  const bool forced = a.f_ch16 != nullptr;
  const int64_t base32 = (int64_t)2 * n16;
  for (int d = 0; d < a.n_diags; ++d) {
    const int s0 = a.diag_off[d], cnt = a.diag_off[d + 1] - s0;
    const int lane = threadIdx.x;
    if (lane < cnt) {
      const int i32 = a.slot_ctu[s0 + lane];
      const int cx = i32 % a.wc, cy = i32 / a.wc;
      const int bx = 2 * cx, by = 2 * cy;
      const bool left = cx > 0, top = cy > 0;
      const bool tr = top && cx < a.wc - 1;
      const int q16[4] = {by * w16 + bx, by * w16 + bx + 1,
                          (by + 1) * w16 + bx, (by + 1) * w16 + bx + 1};
      int fch = -1, f[6] = {0, 0, 0, 0, 0, 0};
      CuIn in{};
      // hypothesis A: one CU32
      Cand c[4];
      for (int k = 0; k < 4; ++k)
        c[k] = mp.nb(decide::nb_cu32(k, bx, by, left, top, tr, w16, h16));
      if (forced) {
        forced_of(a.f_ch32, a.f_mvd0_32, a.f_mvp0_32, a.f_mvd1_32,
                  a.f_mvp1_32, i32, fch, f);
      } else {
        in = CuIn{a.d32 + 3 * i32, a.rb32 + 3 * i32, a.mv0_32[2 * i32],
                  a.mv0_32[2 * i32 + 1], a.mv1_32[2 * i32],
                  a.mv1_32[2 * i32 + 1], a.lam32[i32], 0.0f, false};
      }
      const Decision r32 = decide_cu(a, c, base32 + i32, n32, in, fch, f);
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
          c[2] = Cand{false, 0, 0, 0, 0, 0};
          c[3] = local(q[0]);
        }
        const int i = q16[k];
        if (forced) {
          forced_of(a.f_ch16, a.f_mvd0_16, a.f_mvp0_16, a.f_mvd1_16,
                    a.f_mvp1_16, i, fch, f);
        } else {
          in = CuIn{a.d16 + 3 * i, a.rb16 + 3 * i, a.mv0_16[2 * i],
                    a.mv0_16[2 * i + 1], a.mv1_16[2 * i],
                    a.mv1_16[2 * i + 1], a.lam16[i], a.di16[i], true};
        }
        q[k] = decide_cu(a, c, i, n16, in, fch, f);
      }
      bool split;
      if (forced) {
        split = a.f_split[i32] != 0;
      } else {
        const float js = __fadd_rn(__fadd_rn(__fadd_rn(q[0].j, q[1].j),
                                             q[2].j), q[3].j);
        split = js < r32.j;
        if (a.jsplit != nullptr) {
          a.jsplit[i32] = js;
          a.j32[i32] = r32.j;
        }
      }
      a.split[i32] = split;
      a.ch32[i32] = r32.choice;
      a.mvd0_32[2 * i32] = r32.mvd0x;
      a.mvd0_32[2 * i32 + 1] = r32.mvd0y;
      a.mvp0_32[i32] = r32.mvp0;
      a.mvd1_32[2 * i32] = r32.mvd1x;
      a.mvd1_32[2 * i32 + 1] = r32.mvd1y;
      a.mvp1_32[i32] = r32.mvp1;
      if (a.js32 != nullptr)
        for (int t = 0; t < 6; ++t) a.js32[6 * i32 + t] = r32.js[t];
      for (int k = 0; k < 4; ++k) {
        const int i = q16[k];
        a.chq[i] = q[k].choice;
        a.mvd0q[2 * i] = q[k].mvd0x;
        a.mvd0q[2 * i + 1] = q[k].mvd0y;
        a.mvp0q[i] = q[k].mvp0;
        a.mvd1q[2 * i] = q[k].mvd1x;
        a.mvd1q[2 * i + 1] = q[k].mvd1y;
        a.mvp1q[i] = q[k].mvp1;
        if (a.jsq != nullptr)
          for (int t = 0; t < 6; ++t) a.jsq[6 * i + t] = q[k].js[t];
        const Decision& s = split ? q[k] : r32;
        a.dir[i] = s.dir;
        a.mv0[2 * i] = s.m0x;
        a.mv0[2 * i + 1] = s.m0y;
        a.mv1[2 * i] = s.m1x;
        a.mv1[2 * i + 1] = s.m1y;
        mp.dir[i] = s.dir;
        mp.mv0[2 * i] = s.m0x;
        mp.mv0[2 * i + 1] = s.m0y;
        mp.mv1[2 * i] = s.m1x;
        mp.mv1[2 * i + 1] = s.m1y;
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int decide_b(const DecideBArgs* args, cudaStream_t stream) {
  const DecideBArgs& a = *args;
  if (a.bmax < 1 || a.bmax > 1024 || a.sr < 1)
    return (int)cudaErrorInvalidValue;
  const int threads = ((a.bmax + 31) / 32) * 32;
  decide_b_kernel<<<1, threads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}
