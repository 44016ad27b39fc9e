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
//      [skip 0, skip 1, L0, L1, bi, intra]; an unused list's MV is zeroed.
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
// What bounds it on an H100: neither bytes nor operations (a CTU reads a
// few grid entries per list of its [S, S] grids and does a few hundred
// operations); its time is the latency of the dependent chain of one CTU
// times the number of wavefront steps (255 at 1920x1088).
//
// Design (K24 `decide_rows_p`, K25 `decide_rows_b`): one thread block, a
// thread a CTU row.  Thread r walks row r left to right and decides CTU
// (t - 2 r, r) at step t, the same wavefront as the diagonals, so the same
// decisions.  What a CTU reads is then in registers or one shared-memory
// word away:
//   - A1 is the thread's own commit of step t - 1;
//   - B0, B1, B2 are row r - 1's commits of steps t - 1, t - 2, t - 3: a
//     three-entry register window, fed each step from a shared-memory
//     slot the upper row writes (one barrier a step).  A P commit is
//     (inter, MV), an int4; a B commit (direction, MV0, MV1), an int4 and
//     an int in a second slot array: the MVs stay int32, so no range
//     argument is needed;
//   - the inputs that do not depend on the neighbours (lambda, the ME MVs,
//     the trial distortions and rates, the intra cost; forced: the given
//     choice, MVDs and MVP indices) are loaded a step ahead, the next CTU
//     of a row being the next raster index;
//   - the grid entries at the four neighbours' final MVs and at the zero
//     MV (B: of each list) are read as the step starts (the window holds
//     the MVs), beside the merge and AMVP derivation; the pruning then
//     picks two of them.  A neighbour that is not inter reads the zero
//     MV's entry, unused: unconditional reads measured faster than reads
//     behind the availability test (PERF.md).
// So one grid read is the only memory round trip on a step's chain: an L2
// hit when the grids are warm, a device-memory read in the frame's flow,
// where the intra trial's traffic has evicted them.  Three ways of taking
// it off K24's chain were slower on the H100 (PERF.md): reading
// every entry a step ahead at each MV a neighbour may end on, with the row
// above's three handed down through a second barrier a step; a bulk L2
// prefetch of each CTU's grid row two steps ahead; and single-line L2
// prefetches of those entries a step ahead.
// The rows of a warp walk different CTUs, so a branch on a CTU's data
// splits the warp: K25 forms every choice (merge list, AMVP pair, first
// minimum) with selects, and loads a grid entry from a selected address
// (`grid_ptr`: an outside MV's 1e18 lies in device memory), since a select
// on the loaded value let the compiler put each load behind a branch of its
// own, one after another.  K25 keeps K24's walk in its own
// functions: one template over both slowed K24 by 16 % (0.164 -> 0.190 ms
// a 1080p frame on an H100 80GB HBM3 at 700 W; PERF.md), its code taking
// more branches.
// An idle step (a row before its first CTU or after its last) commits
// nothing, which is what the frame's borders make unavailable, so no
// availability test is needed.  A forced mode replays given decisions
// (choice, MVDs, MVP indices) through the same candidate derivation,
// without lookups.  Every input and output is raster; neither kernel needs
// scratch.
//
// Entry point (plain C, caller's stream, returns cudaGetLastError()):
//   decide_flat(const FlatArgs* args, int bidir, cudaStream_t stream)

#include <cstdint>
#include <cuda_runtime.h>

#include "decide_common.cuh"

extern "C" {
struct FlatArgs {
  // CTB16 grid, search range; dsf0 / dsf1 scale a neighbour's other-list
  // MV to list 0 / 1 (B only)
  int wc, hc, sr, dsf0, dsf1;
  // integer SSD grids [n, S, S] of list 0 and list 1 (P: grid0 only)
  const float *grid0, *grid1;
  // trial distortion and rate: P [n], B [n, 3] (L0, L1, bi); the intra
  // trial cost and lambda [n]; the ME MVs of both lists [n, 2] (qpel)
  const float *d, *rb, *di, *lam;
  const int32_t *me0, *me1;
  float intra_hdr_bits;
  // forced mode (null when free): choice, MVD and MVP index of each list
  const int32_t *f_ch, *f_mvd0, *f_mvp0, *f_mvd1, *f_mvp1;
  // outputs (raster): choice, direction (B), final MVs (an unused list
  // zeroed in B; P's intra cells keep the ME MV), MVDs, MVP indices
  int32_t *choice, *dir, *mv0, *mv1, *mvd0, *mvp0, *mvd1, *mvp1;
  // optional cost rows [n, 4] (P) or [n, 6] (B)
  float* js;
};
}

namespace {

using decide::Cand;
using decide::amvp_b;
using decide::pick_mvp;
using decide::same_b;

__device__ __forceinline__ bool same_p(const Cand& a, const Cand& b) {
  return a.m0x == b.m0x && a.m0y == b.m0y;
}

// the integer SSD-grid entry of a qpel MV's floor (JAX `grid_lookup`)
__device__ __forceinline__ float lookup(const float* grid, int ctu, int sr,
                                        int mx, int my) {
  return decide::grid_at(grid, ctu, sr, mx, my);
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

// ---- K25: K24's walk with the B derivation ------------------------------

// What a B CTU committed: direction (0: intra, or an idle step) and both
// MVs (zero where the list is unused).
struct BCommit {
  int dir, m0x, m0y, m1x, m1y;
};

__device__ __forceinline__ Cand cand_of(const BCommit& c) {
  return Cand{c.dir != 0, c.dir, c.m0x, c.m0y, c.m1x, c.m1y};
}

// A B CTU's inputs that do not depend on its neighbours, loaded a step
// ahead: free, lambda, trial distortions and rates (L0, L1, bi), intra
// cost and both ME MVs; forced, the given choice, both MVDs (in the ME
// MVs' places) and MVP indices.
struct BRowIn {
  float lam, d[3], rb[3], di;
  int m0x, m0y, m1x, m1y, ch, mvp0, mvp1;
};

template <bool FORCED>
__device__ __forceinline__ BRowIn b_row_in(const FlatArgs& a, int ctu) {
  BRowIn v{};
  if (FORCED) {
    v.ch = a.f_ch[ctu];
    v.m0x = a.f_mvd0[2 * ctu];
    v.m0y = a.f_mvd0[2 * ctu + 1];
    v.mvp0 = a.f_mvp0[ctu];
    v.m1x = a.f_mvd1[2 * ctu];
    v.m1y = a.f_mvd1[2 * ctu + 1];
    v.mvp1 = a.f_mvp1[ctu];
  } else {
    v.lam = a.lam[ctu];
    v.di = a.di[ctu];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      v.d[i] = a.d[3 * ctu + i];
      v.rb[i] = a.rb[3 * ctu + i];
    }
    v.m0x = a.me0[2 * ctu];
    v.m0y = a.me0[2 * ctu + 1];
    v.m1x = a.me1[2 * ctu];
    v.m1y = a.me1[2 * ctu + 1];
  }
  return v;
}

// the grid entry of a qpel MV (1e18 outside +-sr), one unconditional load
__device__ __forceinline__ float entry_at(const float* grid, int ctu,
                                          int sr, int mx, int my) {
  return __ldg(decide::grid_ptr(grid, ctu, sr, mx, my));
}

// the skip value of a merge candidate of direction dir from its lists'
// entries: the mean of both for bi
__device__ __forceinline__ float skip_value(int dir, float l0, float l1) {
  return dir == 3 ? __fmul_rn(0.5f, __fadd_rn(l0, l1))
                  : (dir == 1 ? l0 : l1);
}

// The grid entries a B CTU's merge candidates may take: both lists' at the
// four neighbours' MVs (g[0..3]) and at the zero MV (g[4]).
struct BEntries {
  float g0[5], g1[5];
};

// A B CTU: merge and both lists' AMVP candidates, the six costs, its
// outputs.  Returns its commit.
template <bool FORCED>
__device__ __forceinline__ BCommit decide_ctu_b(const FlatArgs& a, int ctu,
                                                const Cand c[4],
                                                const BEntries& e,
                                                const BRowIn& cur) {
  const float *g0 = e.g0, *g1 = e.g1;
  const float gz0 = g0[4], gz1 = g1[4];
  // merge list: the first two survivors of the pruning, then zero bi,
  // chosen by selects
  bool m_av[4];
  m_av[0] = c[0].av;
  m_av[1] = c[1].av & !(c[0].av & same_b(c[1], c[0]));
  m_av[2] = c[2].av & !(c[1].av & same_b(c[2], c[1]));
  m_av[3] = c[3].av & !(c[0].av & same_b(c[3], c[0])) &
            !(c[1].av & same_b(c[3], c[1]));
  int md[2] = {3, 3}, mv[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
  float ml0[2] = {gz0, gz0}, ml1[2] = {gz1, gz1};
  int k2 = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const bool take = m_av[i] & (k2 == m);
      md[m] = take ? c[i].dir : md[m];
      mv[m][0] = take ? c[i].m0x : mv[m][0];
      mv[m][1] = take ? c[i].m0y : mv[m][1];
      mv[m][2] = take ? c[i].m1x : mv[m][2];
      mv[m][3] = take ? c[i].m1y : mv[m][3];
      ml0[m] = take ? g0[i] : ml0[m];
      ml1[m] = take ? g1[i] : ml1[m];
    }
    k2 += m_av[i];
  }
  int p0[4], p1[4];
  amvp_b(c, 0, a.dsf0, p0);
  amvp_b(c, 1, a.dsf1, p1);
  int ch, mvd0x, mvd0y, mvp0, mvd1x, mvd1y, mvp1, me0x, me0y, me1x, me1y;
  if (FORCED) {
    ch = cur.ch;
    mvd0x = cur.m0x;
    mvd0y = cur.m0y;
    mvp0 = cur.mvp0;
    mvd1x = cur.m1x;
    mvd1y = cur.m1y;
    mvp1 = cur.mvp1;
    me0x = (mvp0 == 1 ? p0[2] : p0[0]) + mvd0x;
    me0y = (mvp0 == 1 ? p0[3] : p0[1]) + mvd0y;
    me1x = (mvp1 == 1 ? p1[2] : p1[0]) + mvd1x;
    me1y = (mvp1 == 1 ? p1[3] : p1[1]) + mvd1y;
  } else {
    me0x = cur.m0x;
    me0y = cur.m0y;
    me1x = cur.m1x;
    me1y = cur.m1y;
    const float bits0 = pick_mvp(me0x, me0y, p0, mvd0x, mvd0y, mvp0);
    const float bits1 = pick_mvp(me1x, me1y, p1, mvd1x, mvd1y, mvp1);
    const float lam = cur.lam;
    float js[6];
    js[0] = __fmaf_rn(lam, 2.0f, skip_value(md[0], ml0[0], ml1[0]));
    js[1] = __fmaf_rn(lam, 3.0f, skip_value(md[1], ml0[1], ml1[1]));
    js[2] = __fmaf_rn(lam, __fadd_rn(__fadd_rn(cur.rb[0], bits0), 8.0f),
                      cur.d[0]);
    js[3] = __fmaf_rn(lam, __fadd_rn(__fadd_rn(cur.rb[1], bits1), 8.0f),
                      cur.d[1]);
    js[4] = __fmaf_rn(
        lam, __fadd_rn(__fadd_rn(__fadd_rn(cur.rb[2], bits0), bits1), 10.0f),
        cur.d[2]);
    js[5] = __fmaf_rn(lam, a.intra_hdr_bits, cur.di);
    ch = 0;
    float best = js[0];
#pragma unroll
    for (int i = 1; i < 6; ++i) {
      const bool lt = js[i] < best;
      best = lt ? js[i] : best;
      ch = lt ? i : ch;
    }
    if (a.js != nullptr) {
      float2* o = reinterpret_cast<float2*>(a.js) + 3 * ctu;
      o[0] = make_float2(js[0], js[1]);
      o[1] = make_float2(js[2], js[3]);
      o[2] = make_float2(js[4], js[5]);
    }
  }
  // the final direction and motion, an unused list zeroed
  const bool mg = ch <= 1, m1 = ch == 1;
  const int dir = mg ? (m1 ? md[1] : md[0])
                     : (ch == 2 ? 1 : (ch == 3 ? 2 : (ch == 4 ? 3 : 0)));
  const bool u0 = dir & 1, u1 = dir & 2;
  const int v0x = u0 ? (mg ? (m1 ? mv[1][0] : mv[0][0]) : me0x) : 0;
  const int v0y = u0 ? (mg ? (m1 ? mv[1][1] : mv[0][1]) : me0y) : 0;
  const int v1x = u1 ? (mg ? (m1 ? mv[1][2] : mv[0][2]) : me1x) : 0;
  const int v1y = u1 ? (mg ? (m1 ? mv[1][3] : mv[0][3]) : me1y) : 0;
  a.choice[ctu] = ch;
  a.dir[ctu] = dir;
  reinterpret_cast<int2*>(a.mv0)[ctu] = make_int2(v0x, v0y);
  reinterpret_cast<int2*>(a.mv1)[ctu] = make_int2(v1x, v1y);
  reinterpret_cast<int2*>(a.mvd0)[ctu] = make_int2(mvd0x, mvd0y);
  reinterpret_cast<int2*>(a.mvd1)[ctu] = make_int2(mvd1x, mvd1y);
  a.mvp0[ctu] = mvp0;
  a.mvp1[ctu] = mvp1;
  return BCommit{dir, v0x, v0y, v1x, v1y};
}

// the row state between steps: A1 (own previous commit) and the upper
// row's window B0, B1, B2 (its commits of the last three steps)
struct BRowState {
  BCommit A, U0, U1, U2;
};

// Step t of row r, as K24's `row_step`: a B commit is five words, an int4
// and an int in two slot arrays.
template <bool FORCED>
__device__ __forceinline__ void b_row_step(const FlatArgs& a, int t, int r,
                                           BRowState& st, const BRowIn& cur,
                                           BRowIn& nxt,
                                           int4 (&com)[2][kMaxRows],
                                           int (&com1)[2][kMaxRows]) {
  const int wc = a.wc;
  const bool row = r < a.hc;
  const int x = t - 2 * r;
  const bool act = row && x >= 0 && x < wc;
  const int ctu = r * wc + x;
  if (row && x + 1 >= 0 && x + 1 < wc) nxt = b_row_in<FORCED>(a, ctu + 1);
  BCommit mine{0, 0, 0, 0, 0};
  const Cand c[4] = {cand_of(st.A), cand_of(st.U1), cand_of(st.U0),
                     cand_of(st.U2)};
  // every grid entry a merge candidate may take, both lists, read as the
  // step starts by every row (an idle one at CTU 0): issued before the
  // branch on the row's activity, so in a block of their own, the
  // scheduler cannot move them after the derivation, onto the chain
  BEntries e{};
  if (!FORCED) {
    const int at = act ? ctu : 0, sr = a.sr;
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      const Cand& ci = c[i < 4 ? i : 0];
      e.g0[i] = entry_at(a.grid0, at, sr, i < 4 ? ci.m0x : 0,
                         i < 4 ? ci.m0y : 0);
      e.g1[i] = entry_at(a.grid1, at, sr, i < 4 ? ci.m1x : 0,
                         i < 4 ? ci.m1y : 0);
    }
  }
  if (act) mine = decide_ctu_b<FORCED>(a, ctu, c, e, cur);
  if (row) {
    com[t & 1][r] = make_int4(mine.dir, mine.m0x, mine.m0y, mine.m1x);
    com1[t & 1][r] = mine.m1y;
  }
  __syncthreads();
  st.U2 = st.U1;
  st.U1 = st.U0;
  if (row && r > 0) {
    const int4 u = com[t & 1][r - 1];
    st.U0 = BCommit{u.x, u.y, u.z, u.w, com1[t & 1][r - 1]};
  }
  st.A = mine;
}

// K25: thread r walks row r, as K24.
template <bool FORCED>
__global__ void decide_rows_b(const FlatArgs a) {
  __shared__ int4 com[2][kMaxRows];
  __shared__ int com1[2][kMaxRows];
  const int r = threadIdx.x;
  const int steps = a.wc + 2 * (a.hc - 1);
  const BCommit none{0, 0, 0, 0, 0};
  BRowState st{none, none, none, none};
  BRowIn b0{}, b1{};
  for (int t = -1; t < steps; t += 2) {
    b_row_step<FORCED>(a, t, r, st, b0, b1, com, com1);
    b_row_step<FORCED>(a, t + 1, r, st, b1, b0, com, com1);
  }
}

}  // namespace

extern "C" int decide_flat(const FlatArgs* args, int bidir,
                           cudaStream_t stream) {
  const FlatArgs& a = *args;
  if (a.sr < 1 || a.wc < 1 || a.hc < 1 || a.hc > kMaxRows)
    return (int)cudaErrorInvalidValue;
  const int threads = ((a.hc + 31) / 32) * 32;
  const bool forced = a.f_ch != nullptr;
  if (bidir) {
    if (forced)
      decide_rows_b<true><<<1, threads, 0, stream>>>(a);
    else
      decide_rows_b<false><<<1, threads, 0, stream>>>(a);
  } else {
    if (forced)
      decide_rows_p<true><<<1, threads, 0, stream>>>(a);
    else
      decide_rows_p<false><<<1, threads, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}
