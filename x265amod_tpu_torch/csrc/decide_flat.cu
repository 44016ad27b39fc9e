// Kernels K24 and K25 `decide_flat`: the whole decide scan of a flat CTB16
// P frame (K24) or B frame (K25) in one launch.
//
// Replaces, from the JAX package: the `lax.scan` of `decide_body` in
// models/inter_frame.py (:240-315, P) and models/b_frame.py (:242-390, B)
// over the anti-diagonals d = cx + 2 cy of the CTB16 grid.  Each CTU16 of a
// diagonal reads the motion its left (A1), top (B1), top-right (B0) and
// top-left (B2) CTUs committed on earlier diagonals, and:
//   P: builds the merge list (B1 pruned against A1, B0 against B1, B2
//      against A1 and B1, on MVs; the first two kept, the rest the zero
//      MV) and the AMVP pair (A1; the first of B0, B1, B2, pruned against
//      A1), picks the predictor with fewer MVD bins, and takes the first
//      minimum of [skip 0, skip 1, AMVP inter, intra];
//   B: prunes on (direction, MV0, MV1) and fills with zero bi; each list's
//      AMVP pair takes a neighbour's own-list MV, or its other-list MV
//      scaled by that list's dsf (spec 8.5.3.2.8); the first minimum of
//      [skip 0, skip 1, L0, L1, bi, intra].
// A skip candidate is priced in the integer SSD grid at MV >> 2 (an
// arithmetic shift: a negative quarter-pel MV floors), 1e18 outside +-sr; a
// bi candidate at 0.5 (l0 + l1).  The costs take an FMA wherever XLA's CPU
// code contracts a product whose one use is the add after it (the object
// code of both decide fusions has a vfmadd for each):
//   skip_k  = fma(lam, 2 or 3, grid value)
//   P inter = fma(lam, (rb + min(b0, b1)) + 6, d)
//   B L0/L1 = fma(lam, (rb + bits) + 8, d)
//   B bi    = fma(lam, ((rb + bits0) + bits1) + 10, d)
//   intra   = fma(lam, intra header bins, intra trial cost)
// The file is built with --fmad=false so that nothing else contracts.
//
// What bounds it on an H100: neither bytes nor operations (a CTU reads two
// grid entries per list of its [S, S] grids and does a few hundred
// operations); its time is the latency of the dependent chain of one CTU
// times the number of wavefront steps (254 at 1920x1088).
//
// K24's design (`decide_rows_p`): one thread block, a thread a CTU row.
// Thread r walks row r left to right and decides CTU (t - 2 r, r) at step
// t, the same wavefront as the diagonals, so the same decisions.  What a
// CTU reads is then in registers or one shared-memory word away:
//   - A1 is the thread's own commit of step t - 1;
//   - B0, B1, B2 are row r - 1's commits of steps t - 1, t - 2, t - 3: a
//     three-entry register window, fed each step from a shared-memory
//     slot the upper row writes (one barrier a step);
//   - the inputs that do not depend on the neighbours (lambda, the ME MV,
//     the trial distortion, rate and intra cost; forced: the given choice,
//     MVD and MVP index) are loaded a step ahead, the next CTU of a row
//     being the next raster index;
//   - the grid entries at the four neighbours' final MVs and at the zero
//     MV are read as the step starts (the window holds the MVs), beside
//     the merge and AMVP derivation; the pruning then picks two of them.
// So one grid read is the only memory round trip on a step's chain: an L2
// hit when the grids are warm (0.16 ms a 1080p frame), a device-memory
// read in the frame's flow, where the intra trial's traffic has evicted
// them (0.25 ms).  Three ways of taking it off the chain were slower on
// the H100 (PERF.md, PR 13): reading every entry a step ahead at each MV
// a neighbour may end on (its mrg0, mrg1 or ME MV), with the row above's
// three handed down through a second barrier a step; a bulk L2 prefetch
// of each CTU's grid row two steps ahead; and single-line L2 prefetches
// of those entries a step ahead.  Each cost more on the one thread's
// chain than the read it hid.
// A forced mode replays given decisions (choice, MVD, MVP index) through
// the same candidate derivation, without lookups.  Every input and output
// is raster.
//
// K25 (`decide_kernel<true>`, launch name `decide_flat_b`) is still one
// thread a lane of the current diagonal, with __syncthreads() between the
// 254 diagonals and the committed motion (direction, MV0, MV1 per CTU) in a
// global scratch the wrapper allocates; the row walk above is the design
// it, K17 and K19 can take next.
//
// Entry point (plain C, caller's stream, returns cudaGetLastError()):
//   decide_flat(const FlatArgs* args, int bidir, cudaStream_t stream)

#include <cstdint>
#include <cuda_runtime.h>

#include "decide_common.cuh"

extern "C" {
struct FlatArgs {
  // CTB16 grid, wavefront width, search range; dsf0 / dsf1 scale a
  // neighbour's other-list MV to list 0 / 1 (B only)
  int wc, hc, n_diags, bmax, sr, dsf0, dsf1;
  // integer SSD grids [n, S, S] of list 0 and list 1 (P: grid0 only)
  const float *grid0, *grid1;
  // trial distortion and rate: P [n], B [n, 3] (L0, L1, bi); the intra
  // trial cost and lambda [n]; the ME MVs of both lists [n, 2] (qpel)
  const float *d, *rb, *di, *lam;
  const int32_t *me0, *me1;
  float intra_hdr_bits;
  // K25's wavefront schedule: slot -> raster CTU, diagonal k holds slots
  // diag_off[k] .. diag_off[k + 1] - 1 (K24 walks rows and reads neither)
  const int32_t *slot_ctu, *diag_off;
  // forced mode (null when free): choice, MVD and MVP index of each list
  const int32_t *f_ch, *f_mvd0, *f_mvp0, *f_mvd1, *f_mvp1;
  // outputs (raster): choice, direction (B), final MVs (an unused list
  // zeroed in B; P's intra cells keep the ME MV), MVDs, MVP indices
  int32_t *choice, *dir, *mv0, *mv1, *mvd0, *mvp0, *mvd1, *mvp1;
  // optional cost rows [n, 4] (P) or [n, 6] (B)
  float* js;
  // K25's global scratch, 5 n int32: direction, MV0, MV1 (K24: null)
  int32_t* maps;
};
}

namespace {

using decide::mvd_bits;
using decide::scale_mv;

// a merge / AMVP candidate: availability, direction (bit 0 L0, bit 1 L1)
// and both MVs
struct Cand {
  bool av;
  int dir, m0x, m0y, m1x, m1y;
};

__device__ __forceinline__ bool same_p(const Cand& a, const Cand& b) {
  return a.m0x == b.m0x && a.m0y == b.m0y;
}

__device__ __forceinline__ bool same_b(const Cand& a, const Cand& b) {
  return a.dir == b.dir && a.m0x == b.m0x && a.m0y == b.m0y &&
         a.m1x == b.m1x && a.m1y == b.m1y;
}

// the integer SSD-grid entry of a qpel MV's floor (JAX `grid_lookup`)
__device__ __forceinline__ float lookup(const float* grid, int ctu, int sr,
                                        int mx, int my) {
  const int S = 2 * sr + 1;
  const int ix = mx >> 2, iy = my >> 2;
  if (abs(ix) > sr || abs(iy) > sr) return 1e18f;
  return grid[((size_t)ctu * S + (iy + sr)) * S + (ix + sr)];
}

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

// B AMVP pair of list li (JAX `amvp` :293-325), c in the order A1, B1, B0,
// B2; p = (c0x, c0y, c1x, c1y)
__device__ void amvp_b(const Cand c[4], int li, int dsf, int p[4]) {
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
  int c0x = 0, c0y = 0;
  if (ca_v) {
    c0x = cax;
    c0y = cay;
  } else if (bp1_v) {
    c0x = bp1x;
    c0y = bp1y;
  } else if (bs_v) {
    c0x = bsx;
    c0y = bsy;
  }
  int c1x = 0, c1y = 0;
  bool c1_v;
  if (ca_v) {
    c1_v = bp1_v;
    c1x = bp1x;
    c1y = bp1y;
  } else {
    c1_v = bp1_v && bs_v;
    c1x = bsx;
    c1y = bsy;
  }
  const bool keep = c1_v && !(c1x == c0x && c1y == c0y);
  p[0] = c0x;
  p[1] = c0y;
  p[2] = keep ? c1x : 0;
  p[3] = keep ? c1y : 0;
}

// P AMVP pair (JAX :271-278): A = A1; B = the first of B0, B1, B2, pruned
// against A (selected by value: a reference chosen at run time would put
// the candidates in local memory)
__device__ __forceinline__ void amvp_p(const Cand c[4], int p[4]) {
  const int bx = c[2].av ? c[2].m0x : (c[1].av ? c[1].m0x : c[3].m0x);
  const int by = c[2].av ? c[2].m0y : (c[1].av ? c[1].m0y : c[3].m0y);
  const bool avb = c[1].av || c[2].av || c[3].av;
  const bool avb2 =
      avb && !(c[0].av && bx == c[0].m0x && by == c[0].m0y);
  p[0] = c[0].av ? c[0].m0x : (avb2 ? bx : 0);
  p[1] = c[0].av ? c[0].m0y : (avb2 ? by : 0);
  p[2] = c[0].av && avb2 ? bx : 0;
  p[3] = c[0].av && avb2 ? by : 0;
}

// the MVD against the predictor with fewer bins (A on a tie): mvd, index,
// and the bins of the better one
__device__ __forceinline__ float pick_mvp(int mx, int my, const int p[4],
                                          int& dx, int& dy, int& idx) {
  const int d0x = mx - p[0], d0y = my - p[1];
  const int d1x = mx - p[2], d1y = my - p[3];
  const float b0 = mvd_bits(d0x, d0y), b1 = mvd_bits(d1x, d1y);
  idx = b1 < b0;
  dx = idx ? d1x : d0x;
  dy = idx ? d1y : d0y;
  return b1 < b0 ? b1 : b0;
}

// ---- K24: a thread a CTU row -------------------------------------------

// the most CTU rows K24 takes (8192 luma rows)
constexpr int kMaxRows = 512;

// What a CTU of the row above (or the thread's own previous CTU) committed:
// inter or not and its final MV.  An idle step commits nothing (inter 0).
struct Commit {
  int inter, x, y;
};

// A CTU's inputs that do not depend on its neighbours, loaded a step ahead:
// free, lambda, trial distortion and rate, intra cost and ME MV; forced,
// the given choice, MVD and MVP index.
struct RowIn {
  float lam, d, rb, di;
  int mx, my, ch, mvp;
};

template <bool FORCED>
__device__ __forceinline__ RowIn row_in(const FlatArgs& a, int ctu) {
  RowIn v;
  if (FORCED) {
    v.lam = v.d = v.rb = v.di = 0.0f;
    v.ch = a.f_ch[ctu];
    v.mx = a.f_mvd0[2 * ctu];
    v.my = a.f_mvd0[2 * ctu + 1];
    v.mvp = a.f_mvp0[ctu];
  } else {
    v.lam = a.lam[ctu];
    v.d = a.d[ctu];
    v.rb = a.rb[ctu];
    v.di = a.di[ctu];
    v.mx = a.me0[2 * ctu];
    v.my = a.me0[2 * ctu + 1];
    v.ch = v.mvp = 0;
  }
  return v;
}

// the row state between steps: A1 (own previous commit) and the upper
// row's window B0, B1, B2 (its commits of the last three steps)
struct RowState {
  Commit A, U0, U1, U2;
};

// Step t of row r: decide CTU (t - 2 r, r) from the window and `cur` (its
// inputs, loaded a step ahead), load the next CTU's inputs into `nxt`,
// exchange commits with the rows around (two slots by the step's parity:
// a row may write its next commit before the row below has read this
// one).
template <bool FORCED>
__device__ __forceinline__ void row_step(const FlatArgs& a, int t, int r,
                                         RowState& st, const RowIn& cur,
                                         RowIn& nxt,
                                         int4 (&com)[2][kMaxRows]) {
  const int wc = a.wc, sr = a.sr;
  const bool row = r < a.hc;
  const int x = t - 2 * r;
  const bool act = row && x >= 0 && x < wc;
  const int ctu = r * wc + x;
  const Commit none{0, 0, 0};
  if (row && x + 1 >= 0 && x + 1 < wc) nxt = row_in<FORCED>(a, ctu + 1);
  Commit mine = none;
  if (act) {
    const Commit& A = st.A;
    // candidates in the order A1, B1, B0, B2 (an idle step commits no
    // inter CTU, so the frame borders need no test)
    const Cand c[4] = {{A.inter != 0, 1, A.x, A.y, 0, 0},
                       {st.U1.inter != 0, 1, st.U1.x, st.U1.y, 0, 0},
                       {st.U0.inter != 0, 1, st.U0.x, st.U0.y, 0, 0},
                       {st.U2.inter != 0, 1, st.U2.x, st.U2.y, 0, 0}};
    // every grid entry a merge candidate may take, read at once: the
    // neighbours' final MVs are known when the step starts (a neighbour
    // that is not inter reads the zero MV's entry, unused: unconditional
    // reads measured faster than reads behind the availability test)
    float gv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      gv[i] = FORCED ? 0.0f : lookup(a.grid0, ctu, sr, c[i].m0x, c[i].m0y);
    const float gz = FORCED ? 0.0f : lookup(a.grid0, ctu, sr, 0, 0);
    bool m_av[4];
    m_av[0] = c[0].av;
    m_av[1] = c[1].av && !(c[0].av && same_p(c[1], c[0]));
    m_av[2] = c[2].av && !(c[1].av && same_p(c[2], c[1]));
    m_av[3] = c[3].av && !(c[0].av && same_p(c[3], c[0])) &&
              !(c[1].av && same_p(c[3], c[1]));
    int m0x = 0, m0y = 0, m1x = 0, m1y = 0, k2 = 0;
    float g0 = gz, g1 = gz;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (m_av[i]) {
        if (k2 == 0) {
          m0x = c[i].m0x;
          m0y = c[i].m0y;
          g0 = gv[i];
        } else if (k2 == 1) {
          m1x = c[i].m0x;
          m1y = c[i].m0y;
          g1 = gv[i];
        }
        ++k2;
      }
    }
    int p0[4];
    amvp_p(c, p0);
    int ch, mvdx, mvdy, mvp, mex, mey;
    if (FORCED) {
      ch = cur.ch;
      mvdx = cur.mx;
      mvdy = cur.my;
      mvp = cur.mvp;
      mex = (mvp == 1 ? p0[2] : p0[0]) + mvdx;
      mey = (mvp == 1 ? p0[3] : p0[1]) + mvdy;
    } else {
      mex = cur.mx;
      mey = cur.my;
      const float bits = pick_mvp(mex, mey, p0, mvdx, mvdy, mvp);
      float js[4];
      js[0] = __fmaf_rn(cur.lam, 2.0f, g0);
      js[1] = __fmaf_rn(cur.lam, 3.0f, g1);
      js[2] = __fmaf_rn(cur.lam, __fadd_rn(__fadd_rn(cur.rb, bits), 6.0f),
                        cur.d);
      js[3] = __fmaf_rn(cur.lam, a.intra_hdr_bits, cur.di);
      ch = 0;
      float best = js[0];
#pragma unroll
      for (int i = 1; i < 4; ++i) {
        if (js[i] < best) {
          best = js[i];
          ch = i;
        }
      }
      if (a.js != nullptr)
        reinterpret_cast<float4*>(a.js)[ctu] =
            make_float4(js[0], js[1], js[2], js[3]);
    }
    // the final MV: the merge candidate, or the ME MV (an intra cell
    // outputs it too; the row's commit holds it only for an inter cell)
    const int vx = ch == 0 ? m0x : (ch == 1 ? m1x : mex);
    const int vy = ch == 0 ? m0y : (ch == 1 ? m1y : mey);
    a.choice[ctu] = ch;
    reinterpret_cast<int2*>(a.mv0)[ctu] = make_int2(vx, vy);
    reinterpret_cast<int2*>(a.mvd0)[ctu] = make_int2(mvdx, mvdy);
    a.mvp0[ctu] = mvp;
    if (ch <= 2) mine = Commit{1, vx, vy};
  }
  // publish this step's commit; take the upper row's
  int4* slot = com[t & 1];
  if (row) slot[r] = make_int4(mine.inter, mine.x, mine.y, 0);
  __syncthreads();
  st.U2 = st.U1;
  st.U1 = st.U0;
  if (row && r > 0) {
    const int4 u = slot[r - 1];
    st.U0 = Commit{u.x, u.y, u.z};
  }
  st.A = mine;
}

// K24: thread r walks row r (see the file's head).  Step -1 only loads the
// first CTU of row 0; the two input buffers swap roles each step.
template <bool FORCED>
__global__ void decide_rows_p(const FlatArgs a) {
  __shared__ int4 com[2][kMaxRows];
  const int r = threadIdx.x;
  const int steps = a.wc + 2 * (a.hc - 1);
  const Commit none{0, 0, 0};
  RowState st{none, none, none, none};
  RowIn b0{}, b1{};
  for (int t = -1; t < steps; t += 2) {
    row_step<FORCED>(a, t, r, st, b0, b1, com);
    row_step<FORCED>(a, t + 1, r, st, b1, b0, com);
  }
}

// ---- K25: a thread a lane of the current diagonal ----------------------

template <bool BIDIR>
__global__ void decide_kernel(const FlatArgs a) {
  const int n = a.wc * a.hc;
  int32_t* dmap = a.maps;
  int32_t* m0map = a.maps + n;
  int32_t* m1map = a.maps + 3 * n;
  for (int i = threadIdx.x; i < 5 * n; i += blockDim.x) a.maps[i] = 0;
  __syncthreads();
  const bool forced = a.f_ch != nullptr;
  for (int dg = 0; dg < a.n_diags; ++dg) {
    const int s0 = a.diag_off[dg], cnt = a.diag_off[dg + 1] - s0;
    const int lane = threadIdx.x;
    if (lane < cnt) {
      const int ctu = a.slot_ctu[s0 + lane];
      const int cx = ctu % a.wc, cy = ctu / a.wc;
      const int cyu = cy > 0 ? cy - 1 : 0, cxl = cx > 0 ? cx - 1 : 0;
      const int cxr = cx < a.wc - 1 ? cx + 1 : a.wc - 1;
      const int pos[4] = {cy * a.wc + cxl, cyu * a.wc + cx,
                          cyu * a.wc + cxr, cyu * a.wc + cxl};
      const bool ok[4] = {cx > 0, cy > 0, cy > 0 && cx < a.wc - 1,
                          cx > 0 && cy > 0};
      Cand c[4];
      for (int k = 0; k < 4; ++k) {
        const int q = pos[k];
        c[k].av = ok[k] && dmap[q] > 0;
        c[k].dir = c[k].av ? dmap[q] : 0;
        c[k].m0x = c[k].av ? m0map[2 * q] : 0;
        c[k].m0y = c[k].av ? m0map[2 * q + 1] : 0;
        c[k].m1x = c[k].av ? m1map[2 * q] : 0;
        c[k].m1y = c[k].av ? m1map[2 * q + 1] : 0;
      }
      // merge list: the first two survivors of the pruning, then the fill
      bool m_av[4];
      m_av[0] = c[0].av;
      if (BIDIR) {
        m_av[1] = c[1].av && !(c[0].av && same_b(c[1], c[0]));
        m_av[2] = c[2].av && !(c[1].av && same_b(c[2], c[1]));
        m_av[3] = c[3].av && !(c[0].av && same_b(c[3], c[0])) &&
                  !(c[1].av && same_b(c[3], c[1]));
      } else {
        m_av[1] = c[1].av && !(c[0].av && same_p(c[1], c[0]));
        m_av[2] = c[2].av && !(c[1].av && same_p(c[2], c[1]));
        m_av[3] = c[3].av && !(c[0].av && same_p(c[3], c[0])) &&
                  !(c[1].av && same_p(c[3], c[1]));
      }
      Cand mrg[2];
      mrg[0] = mrg[1] = Cand{true, BIDIR ? 3 : 1, 0, 0, 0, 0};
      int k2 = 0;
      for (int i = 0; i < 4; ++i)
        if (m_av[i] && k2 < 2) mrg[k2++] = c[i];
      int p0[4], p1[4] = {0, 0, 0, 0};
      if (BIDIR) {
        amvp_b(c, 0, a.dsf0, p0);
        amvp_b(c, 1, a.dsf1, p1);
      } else {
        amvp_p(c, p0);
      }
      int ch, mvd0x, mvd0y, mvp0, mvd1x = 0, mvd1y = 0, mvp1 = 0;
      int me0x, me0y, me1x = 0, me1y = 0;
      if (forced) {
        ch = a.f_ch[ctu];
        mvd0x = a.f_mvd0[2 * ctu];
        mvd0y = a.f_mvd0[2 * ctu + 1];
        mvp0 = a.f_mvp0[ctu];
        me0x = (mvp0 == 1 ? p0[2] : p0[0]) + mvd0x;
        me0y = (mvp0 == 1 ? p0[3] : p0[1]) + mvd0y;
        if (BIDIR) {
          mvd1x = a.f_mvd1[2 * ctu];
          mvd1y = a.f_mvd1[2 * ctu + 1];
          mvp1 = a.f_mvp1[ctu];
          me1x = (mvp1 == 1 ? p1[2] : p1[0]) + mvd1x;
          me1y = (mvp1 == 1 ? p1[3] : p1[1]) + mvd1y;
        }
      } else {
        constexpr int K = BIDIR ? 6 : 4;
        float js[K];
        const float lam = a.lam[ctu];
        me0x = a.me0[2 * ctu];
        me0y = a.me0[2 * ctu + 1];
        const float bits0 = pick_mvp(me0x, me0y, p0, mvd0x, mvd0y, mvp0);
        for (int i = 0; i < 2; ++i) {
          const Cand& m = mrg[i];
          float v;
          if (BIDIR) {
            const float l0 = lookup(a.grid0, ctu, a.sr, m.m0x, m.m0y);
            const float l1 = lookup(a.grid1, ctu, a.sr, m.m1x, m.m1y);
            v = m.dir == 3 ? __fmul_rn(0.5f, __fadd_rn(l0, l1))
                           : (m.dir == 1 ? l0 : l1);
          } else {
            v = lookup(a.grid0, ctu, a.sr, m.m0x, m.m0y);
          }
          js[i] = __fmaf_rn(lam, i == 0 ? 2.0f : 3.0f, v);
        }
        if (BIDIR) {
          me1x = a.me1[2 * ctu];
          me1y = a.me1[2 * ctu + 1];
          const float bits1 = pick_mvp(me1x, me1y, p1, mvd1x, mvd1y, mvp1);
          const float* d = a.d + 3 * ctu;
          const float* rb = a.rb + 3 * ctu;
          js[2] = __fmaf_rn(lam, __fadd_rn(__fadd_rn(rb[0], bits0), 8.0f),
                            d[0]);
          js[3] = __fmaf_rn(lam, __fadd_rn(__fadd_rn(rb[1], bits1), 8.0f),
                            d[1]);
          js[4] = __fmaf_rn(
              lam,
              __fadd_rn(__fadd_rn(__fadd_rn(rb[2], bits0), bits1), 10.0f),
              d[2]);
        } else {
          js[2] = __fmaf_rn(
              lam, __fadd_rn(__fadd_rn(a.rb[ctu], bits0), 6.0f), a.d[ctu]);
        }
        js[K - 1] = __fmaf_rn(lam, a.intra_hdr_bits, a.di[ctu]);
        ch = 0;
        for (int i = 1; i < K; ++i)
          if (js[i] < js[ch]) ch = i;
        if (a.js != nullptr)
          for (int i = 0; i < K; ++i) a.js[K * ctu + i] = js[i];
      }
      // the final direction and motion
      int dir, v0x, v0y, v1x, v1y;
      if (ch <= 1) {
        dir = mrg[ch].dir;
        v0x = mrg[ch].m0x;
        v0y = mrg[ch].m0y;
        v1x = mrg[ch].m1x;
        v1y = mrg[ch].m1y;
      } else {
        dir = BIDIR ? (ch == 2 ? 1 : (ch == 3 ? 2 : (ch == 4 ? 3 : 0)))
                    : (ch == 2 ? 1 : 0);
        v0x = me0x;
        v0y = me0y;
        v1x = me1x;
        v1y = me1y;
      }
      if (BIDIR) {
        if (!(dir & 1)) v0x = v0y = 0;
        if (!(dir & 2)) v1x = v1y = 0;
        a.dir[ctu] = dir;
        a.mv1[2 * ctu] = v1x;
        a.mv1[2 * ctu + 1] = v1y;
        a.mvd1[2 * ctu] = mvd1x;
        a.mvd1[2 * ctu + 1] = mvd1y;
        a.mvp1[ctu] = mvp1;
      }
      a.choice[ctu] = ch;
      // P: every cell outputs its final MV (intra: the ME MV), the map
      // holds 0 where the cell is not inter
      a.mv0[2 * ctu] = v0x;
      a.mv0[2 * ctu + 1] = v0y;
      a.mvd0[2 * ctu] = mvd0x;
      a.mvd0[2 * ctu + 1] = mvd0y;
      a.mvp0[ctu] = mvp0;
      const bool inter = BIDIR ? dir > 0 : ch <= 2;
      dmap[ctu] = BIDIR ? dir : (inter ? 1 : 0);
      m0map[2 * ctu] = inter ? v0x : 0;
      m0map[2 * ctu + 1] = inter ? v0y : 0;
      m1map[2 * ctu] = v1x;
      m1map[2 * ctu + 1] = v1y;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int decide_flat(const FlatArgs* args, int bidir,
                           cudaStream_t stream) {
  const FlatArgs& a = *args;
  if (a.bmax < 1 || a.bmax > 1024 || a.sr < 1 || a.wc < 1 || a.hc < 1 ||
      a.hc > kMaxRows)
    return (int)cudaErrorInvalidValue;
  if (bidir) {
    decide_kernel<true><<<1, ((a.bmax + 31) / 32) * 32, 0, stream>>>(a);
  } else {
    const int threads = ((a.hc + 31) / 32) * 32;
    if (a.f_ch != nullptr)
      decide_rows_p<true><<<1, threads, 0, stream>>>(a);
    else
      decide_rows_p<false><<<1, threads, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}
