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
// `pick_mvp` takes the one with fewer MVD bins (decide_common.cuh, shared
// with K24 and K25).  A skip candidate is priced from the SSD grids of the
// lists it uses (the half-pel grid for a sub-pel MV, the mean of both
// lists' for bi): row base + sub n + idx of each list's stacked grids [CU16
// integer, CU16 half-pel, CU32 integer, CU32 half-pel].
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
// What bounds it on an H100: neither bytes nor operations (it reads a few
// dozen SSD-grid entries a CTU of the 71 MB of grids at 1080p, sr 16); its
// time is the latency of one thread's chain of five CU decisions a step
// times the number of wavefront steps (126 at 1920x1088).
//
// Design (`decide_rows_b`, K24's row walk): one thread block, a thread a
// CTU32 row.  Thread r decides CTU (t - 2 r, r) at step t, the wavefront of
// the diagonals, so the same decisions.  What a CTU reads of its
// neighbours is, by cell (spec 6.4.2; the table in
// decide_common.cuh): the left CTU's q1 and q3, the top-left CTU's q3, the
// top CTU's q2 and q3 and the top-right CTU's q2.  So
//   - the left CTU's cells are the thread's own commit of step t - 1;
//   - the row above's are a register window of its commits of steps t - 1
//     (top-right), t - 2 (top) and t - 3 (top-left): each step a row
//     publishes its CTU's bottom cells q2 and q3 (direction and both MVs,
//     int32, ten words) into a shared-memory slot by the step's parity, and
//     one barrier a step hands them down;
//   - a row before its first CTU or after its last commits nothing, so an
//     unavailable neighbour reads as zeros, as the committed maps of an
//     intra cell do.  Every position the JAX `nb` clamps is inside the
//     frame whenever its availability flag is set (the wrapper gives w16 =
//     2 wc and h16 = 2 hc), so the window holds every cell the JAX `nb`
//     reads;
//   - the inputs that do not depend on the neighbours (per CU: the trial
//     distortions and rates, the ME MVs of both lists, lambda, the intra
//     cost; forced: the given choices, MVDs, MVP indices and split), 60
//     words, are copied a step ahead into the thread's column of shared
//     memory by `cp.async`, the next CTU of a row being the next raster
//     index (held in registers, two CTUs' inputs spilled);
//   - every SSD-grid entry any of the CTU's five decisions can price is
//     read as the step starts, so one memory round trip is on the step's
//     chain.  A candidate's motion, list by list, is one of ten sources:
//     the zero MV, one of the six neighbour cells above, or the ME MV of
//     quadrant q0, q1 or q2 (a quadrant ends on its merge candidate 0 or
//     1, which carries an earlier source, on its own ME motion, or as
//     intra, which no one reads).  Each decision carries its lists'
//     sources; the entries of each CU's row at each source it can meet
//     (CU32 5, q0 5, q1 7, q2 9, q3 10 per list) are copied into the
//     thread's column of shared memory by `cp.async` (no registers held),
//     and a merge candidate's skip price is the entry of its sources.
//     Reading instead each quadrant's merge candidates' entries once they
//     are known (three dependent reads a step) measured slower, the more
//     so with L2 flushed (PERF.md);
//   - the rows of a warp walk different CTUs, so a branch on a CTU's data
//     splits the warp: the merge list, the AMVP pairs, the first minimum
//     and an outside MV's 1e18 are selects.
// A forced mode replays the given split, choices, MVDs and MVP indices
// through the same derivation, without reads.  Every input and output is
// raster; the kernel needs no scratch in device memory.
//
// Entry point (plain C, caller's stream, returns cudaGetLastError()):
//   decide_b(const DecideBArgs* args, cudaStream_t stream)

#include <cstdint>
#include <cuda_runtime.h>

#include "decide_common.cuh"

extern "C" {
struct DecideBArgs {
  // geometry (w16 = 2 wc, h16 = 2 hc); dsf0 / dsf1 scale a neighbour's
  // other-list MV to list 0 / 1
  int wc, hc, w16, h16, sr, dsf0, dsf1;
  // the stacked SSD grids of list 0 and list 1, [2 (n16 + n32), S, S] f32
  const float *grid0, *grid1;
  // phase-1 outputs per CTU32 and per 16-cell (raster): d and rb [., 3]
  // (L0, L1, bi), the ME MVs of both lists [., 2], lambda, intra cost
  const float *d32, *rb32, *lam32;
  const int32_t *mv0_32, *mv1_32;
  const float *d16, *rb16, *di16, *lam16;
  const int32_t *mv0_16, *mv1_16;
  float intra_hdr_bits;
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
};
}

namespace {

using decide::amvp_b;
using decide::Cand;
using decide::cp_async4;
using decide::cp_async_wait_all;
using decide::kSources;
using decide::need;
using decide::pick_mvp;
using decide::same_b;

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

// the most CTU32 rows a launch takes (7168 luma rows: the shared memory of
// 224 threads)
constexpr int kMaxRows = 224;

// A committed 16-cell: direction (0: intra or nothing) and both MVs (zero
// where the list is unused).
struct Cell {
  int dir, m0x, m0y, m1x, m1y;
};

// a candidate with the source of each list's MV
struct SCand {
  Cand c;
  int s0, s1;
};

__device__ __forceinline__ SCand ext(const Cell& e, int s) {
  return SCand{Cand{e.dir != 0, e.dir, e.m0x, e.m0y, e.m1x, e.m1y}, s, s};
}

// what a CU decision hands on: its choice, final direction and MVs (an
// unused list zeroed), their sources, and its cost
struct Decision {
  int choice, dir, m0x, m0y, m1x, m1y, s0, s1;
  float j;
};

__device__ __forceinline__ SCand local(const Decision& d) {
  return SCand{Cand{d.choice <= 4, d.dir, d.m0x, d.m0y, d.m1x, d.m1y}, d.s0,
               d.s1};
}

__device__ __forceinline__ Cell cell_of(const Decision& d) {
  return Cell{d.dir, d.m0x, d.m0y, d.m1x, d.m1y};
}

// A CU's inputs: free, trial distortions and rates (L0, L1, bi), lambda,
// intra cost (CU32: none) and the ME MVs; forced, the choice, the MVDs (in
// the ME MVs' places) and MVP indices.
struct CuIn {
  float d[3], rb[3], lam, di;
  int m0x, m0y, m1x, m1y, ch, mvp0, mvp1;
};

// ---- a CTU's inputs, staged a step ahead in shared memory ----------------

// Words a CU's inputs take: free, d[3] rb[3] lam di m0x m0y m1x m1y; forced,
// ch mvd0x mvd0y mvp0 mvd1x mvd1y mvp1, and the CU32's word 7 the split.
constexpr int kInWords = 12;
constexpr int kStepWords = 5 * kInWords;

// Copy the inputs of CTU i32 (top-left 16-cell c0) into `in`, the thread's
// column of one input buffer (word w of CU k at ((k kInWords + w) T)).
template <bool FORCED>
__device__ __forceinline__ void stage_in(const DecideBArgs& a, int i32,
                                         int c0, uint32_t* in, int T) {
  const int q16[4] = {c0, c0 + 1, c0 + a.w16, c0 + a.w16 + 1};
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const bool is32 = k == 0;
    const int i = is32 ? i32 : q16[k - 1];
    uint32_t* w = in + k * kInWords * T;
    if (FORCED) {
      cp_async4(w, (is32 ? a.f_ch32 : a.f_ch16) + i);
      const int32_t* d0 = (is32 ? a.f_mvd0_32 : a.f_mvd0_16) + 2 * i;
      const int32_t* d1 = (is32 ? a.f_mvd1_32 : a.f_mvd1_16) + 2 * i;
      cp_async4(w + T, d0);
      cp_async4(w + 2 * T, d0 + 1);
      cp_async4(w + 3 * T, (is32 ? a.f_mvp0_32 : a.f_mvp0_16) + i);
      cp_async4(w + 4 * T, d1);
      cp_async4(w + 5 * T, d1 + 1);
      cp_async4(w + 6 * T, (is32 ? a.f_mvp1_32 : a.f_mvp1_16) + i);
      if (is32) cp_async4(w + 7 * T, a.f_split + i32);
    } else {
      const float* d = (is32 ? a.d32 : a.d16) + 3 * i;
      const float* rb = (is32 ? a.rb32 : a.rb16) + 3 * i;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        cp_async4(w + j * T, d + j);
        cp_async4(w + (3 + j) * T, rb + j);
      }
      cp_async4(w + 6 * T, (is32 ? a.lam32 : a.lam16) + i);
      if (!is32) cp_async4(w + 7 * T, a.di16 + i);
      const int32_t* e0 = (is32 ? a.mv0_32 : a.mv0_16) + 2 * i;
      const int32_t* e1 = (is32 ? a.mv1_32 : a.mv1_16) + 2 * i;
      cp_async4(w + 8 * T, e0);
      cp_async4(w + 9 * T, e0 + 1);
      cp_async4(w + 10 * T, e1);
      cp_async4(w + 11 * T, e1 + 1);
    }
  }
}

// CU k's inputs from the thread's column of the current input buffer.
template <bool FORCED>
__device__ __forceinline__ CuIn read_in(const uint32_t* in, int k, int T) {
  const uint32_t* w = in + k * kInWords * T;
  CuIn v{};
  if (FORCED) {
    v.ch = (int)w[0];
    v.m0x = (int)w[T];
    v.m0y = (int)w[2 * T];
    v.mvp0 = (int)w[3 * T];
    v.m1x = (int)w[4 * T];
    v.m1y = (int)w[5 * T];
    v.mvp1 = (int)w[6 * T];
  } else {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      v.d[j] = __uint_as_float(w[j * T]);
      v.rb[j] = __uint_as_float(w[(3 + j) * T]);
    }
    v.lam = __uint_as_float(w[6 * T]);
    v.di = k == 0 ? 0.0f : __uint_as_float(w[7 * T]);
    v.m0x = (int)w[8 * T];
    v.m0y = (int)w[9 * T];
    v.m1x = (int)w[10 * T];
    v.m1y = (int)w[11 * T];
  }
  return v;
}

__device__ __forceinline__ bool inside(int mx, int my, int sr) {
  return abs(mx >> 2) <= sr && abs(my >> 2) <= sr;
}

// The entry of CU k, list l at source s lives at pre[((k 2 + l) 10 + s) T]
// of the thread's column (T threads).
__device__ __forceinline__ int pre_at(int k, int l, int s, int T) {
  return ((k * 2 + l) * kSources + s) * T;
}

// ---- one CU decision -----------------------------------------------------

// Output rows of one CU size.
struct CuOut {
  int32_t *ch, *mvd0, *mvp0, *mvd1, *mvp1;
  float* js;
};

// One B CU decision (JAX decide_cu :1336-1462) from its candidates c in the
// order A1, B1, B0, B2; K is the CU (0 the CU32, 1..4 q0..q3) whose inputs
// lie in `inputs` and grid entries in `pre` (the thread's columns, T
// threads); me_src the source id of its ME MVs; i its output row.
template <bool FORCED, int K>
__device__ __forceinline__ Decision decide_cu(const DecideBArgs& a,
                                              const SCand c[4],
                                              const uint32_t* inputs,
                                              const float* pre, int T,
                                              int me_src, const CuOut& out,
                                              int i) {
  const CuIn in = read_in<FORCED>(inputs, K, T);
  // merge list: B1 pruned against A1, B0 against B1, B2 against A1 and B1;
  // the first two kept, the rest of the list zero-bi
  bool m_av[4];
  m_av[0] = c[0].c.av;
  m_av[1] = c[1].c.av & !(c[0].c.av & same_b(c[1].c, c[0].c));
  m_av[2] = c[2].c.av & !(c[1].c.av & same_b(c[2].c, c[1].c));
  m_av[3] = c[3].c.av & !(c[0].c.av & same_b(c[3].c, c[0].c)) &
            !(c[1].c.av & same_b(c[3].c, c[1].c));
  // (chosen field by field with selects: no row of a warp branches)
  SCand mrg[2];
  mrg[0] = mrg[1] = SCand{Cand{true, 3, 0, 0, 0, 0}, 0, 0};
  int k2 = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const bool take = m_av[j] & (k2 == m);
      SCand& o = mrg[m];
      o.c.dir = take ? c[j].c.dir : o.c.dir;
      o.c.m0x = take ? c[j].c.m0x : o.c.m0x;
      o.c.m0y = take ? c[j].c.m0y : o.c.m0y;
      o.c.m1x = take ? c[j].c.m1x : o.c.m1x;
      o.c.m1y = take ? c[j].c.m1y : o.c.m1y;
      o.s0 = take ? c[j].s0 : o.s0;
      o.s1 = take ? c[j].s1 : o.s1;
    }
    k2 += m_av[j];
  }
  Cand cc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) cc[j] = c[j].c;
  int p0[4], p1[4];
  amvp_b(cc, 0, a.dsf0, p0);
  amvp_b(cc, 1, a.dsf1, p1);
  int ch, mvd0x, mvd0y, mvp0, mvd1x, mvd1y, mvp1, me0x, me0y, me1x, me1y;
  float j = 0.0f;
  if (FORCED) {
    ch = in.ch;
    mvd0x = in.m0x;
    mvd0y = in.m0y;
    mvp0 = in.mvp0;
    mvd1x = in.m1x;
    mvd1y = in.m1y;
    mvp1 = in.mvp1;
    me0x = (mvp0 == 1 ? p0[2] : p0[0]) + mvd0x;
    me0y = (mvp0 == 1 ? p0[3] : p0[1]) + mvd0y;
    me1x = (mvp1 == 1 ? p1[2] : p1[0]) + mvd1x;
    me1y = (mvp1 == 1 ? p1[3] : p1[1]) + mvd1y;
  } else {
    me0x = in.m0x;
    me0y = in.m0y;
    me1x = in.m1x;
    me1y = in.m1y;
    const float bits0 = pick_mvp(me0x, me0y, p0, mvd0x, mvd0y, mvp0);
    const float bits1 = pick_mvp(me1x, me1y, p1, mvd1x, mvd1y, mvp1);
    const float lam = in.lam;
    if (K == 0) cp_async_wait_all();
    float js[6];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const Cand& mc = mrg[m].c;
      const float e0 = pre[pre_at(K, 0, mrg[m].s0, T)];
      const float e1 = pre[pre_at(K, 1, mrg[m].s1, T)];
      const float l0 = inside(mc.m0x, mc.m0y, a.sr) ? e0 : 1e18f;
      const float l1 = inside(mc.m1x, mc.m1y, a.sr) ? e1 : 1e18f;
      const float v = mc.dir == 3 ? __fmul_rn(0.5f, __fadd_rn(l0, l1))
                                  : (mc.dir == 1 ? l0 : l1);
      js[m] = __fmaf_rn(lam, m == 0 ? 2.0f : 3.0f, v);
    }
    js[2] = __fmaf_rn(lam, __fadd_rn(__fadd_rn(in.rb[0], bits0), 8.0f),
                      in.d[0]);
    js[3] = __fmaf_rn(lam, __fadd_rn(__fadd_rn(in.rb[1], bits1), 8.0f),
                      in.d[1]);
    js[4] = __fmaf_rn(
        lam, __fadd_rn(__fadd_rn(__fadd_rn(in.rb[2], bits0), bits1), 10.0f),
        in.d[2]);
    js[5] = K == 0 ? inf() : __fmaf_rn(lam, a.intra_hdr_bits, in.di);
    ch = 0;
    j = js[0];
#pragma unroll
    for (int m = 1; m < 6; ++m) {
      const bool lt = js[m] < j;
      j = lt ? js[m] : j;
      ch = lt ? m : ch;
    }
    if (out.js != nullptr) {
      float2* o = reinterpret_cast<float2*>(out.js) + 3 * i;
      o[0] = make_float2(js[0], js[1]);
      o[1] = make_float2(js[2], js[3]);
      o[2] = make_float2(js[4], js[5]);
    }
  }
  out.ch[i] = ch;
  reinterpret_cast<int2*>(out.mvd0)[i] = make_int2(mvd0x, mvd0y);
  out.mvp0[i] = mvp0;
  reinterpret_cast<int2*>(out.mvd1)[i] = make_int2(mvd1x, mvd1y);
  out.mvp1[i] = mvp1;
  // the final direction, MVs and sources: a merge choice takes its
  // candidate's, an AMVP choice its list(s) of the ME (or replayed) MVs,
  // intra none (selected field by field: a reference chosen at run time
  // would put the merge list in local memory)
  const bool mg = ch <= 1, m1 = ch == 1;
  Decision o;
  o.choice = ch;
  o.j = j;
  o.dir = mg ? (m1 ? mrg[1].c.dir : mrg[0].c.dir)
             : (ch == 2 ? 1 : (ch == 3 ? 2 : (ch == 4 ? 3 : 0)));
  const bool u0 = o.dir & 1, u1 = o.dir & 2;
  o.m0x = u0 ? (mg ? (m1 ? mrg[1].c.m0x : mrg[0].c.m0x) : me0x) : 0;
  o.m0y = u0 ? (mg ? (m1 ? mrg[1].c.m0y : mrg[0].c.m0y) : me0y) : 0;
  o.m1x = u1 ? (mg ? (m1 ? mrg[1].c.m1x : mrg[0].c.m1x) : me1x) : 0;
  o.m1y = u1 ? (mg ? (m1 ? mrg[1].c.m1y : mrg[0].c.m1y) : me1y) : 0;
  o.s0 = u0 ? (mg ? (m1 ? mrg[1].s0 : mrg[0].s0) : me_src) : 0;
  o.s1 = u1 ? (mg ? (m1 ? mrg[1].s1 : mrg[0].s1) : me_src) : 0;
  return o;
}

// ---- the row walk ----------------------------------------------------------

// A row's state between steps: the left CTU's q1 and q3 (its own commit)
// and the window of the row above: the top-right CTU's q2 and q3 (step t -
// 1), the top CTU's (t - 2), the top-left CTU's q3 (t - 3).
struct RowState {
  Cell L1, L3, TR2, TR3, T2, T3, TL3;
};

// Dynamic shared memory, each thread's data in its column (word j of
// thread r at j T + r): the commit slots by parity (a row's q2 and q3: ten
// words in an int4, an int4 and an int2), the two input buffers (the
// current CTU's and the next's, by the step's parity), then (free) the
// grid entries.
struct Smem {
  int4 *sa, *sb;
  int2* sc;
  uint32_t* in;
  float* pre;
};

__device__ __forceinline__ Smem smem_of(unsigned char* base, int T) {
  Smem s;
  s.sa = reinterpret_cast<int4*>(base);
  s.sb = s.sa + 2 * T;
  s.sc = reinterpret_cast<int2*>(s.sb + 2 * T);
  s.in = reinterpret_cast<uint32_t*>(s.sc + 2 * T);
  s.pre = reinterpret_cast<float*>(s.in + 2 * kStepWords * T);
  return s;
}

// bytes of shared memory a launch of T threads takes
constexpr size_t smem_bytes(bool forced, int T) {
  return (size_t)T * (2 * (2 * sizeof(int4) + sizeof(int2)) +
                      2 * kStepWords * sizeof(uint32_t) +
                      (forced ? 0 : 5 * 2 * kSources * sizeof(float)));
}

// Step t of row r: decide CTU (t - 2 r, r) from the window and its
// inputs (staged a step ahead in input buffer t & 1), stage the next CTU's
// inputs into the other buffer, exchange commits with the rows around.
template <bool FORCED>
__device__ __forceinline__ void row_step(const DecideBArgs& a, int t, int r,
                                         RowState& st, const Smem& sm) {
  const int wc = a.wc, w16 = a.w16, T = blockDim.x;
  const bool row = r < a.hc;
  const int x = t - 2 * r;
  const bool act = row && x >= 0 && x < wc;
  const int i32 = r * wc + x;
  const int c0 = 2 * r * w16 + 2 * x;
  // this CTU's inputs have landed (a no-op after an active step, whose
  // decisions waited for all its copies)
  cp_async_wait_all();
  const uint32_t* in = sm.in + (t & 1) * kStepWords * T + r;
  if (row && x + 1 >= 0 && x + 1 < wc)
    stage_in<FORCED>(a, i32 + 1, c0 + 2,
                     sm.in + ((t + 1) & 1) * kStepWords * T + r, T);
  const Cell none{0, 0, 0, 0, 0};
  Cell o1 = none, o2 = none, o3 = none;
  if (act) {
    const int q16[4] = {c0, c0 + 1, c0 + w16, c0 + w16 + 1};
    const float* pre = sm.pre + r;
    if (!FORCED) {
      // every entry the five decisions can price, by source (the wait
      // for them is in the CU32's decision, after its derivation)
      const Cell nbr[7] = {none, st.L1, st.L3, st.T2, st.T3, st.TL3,
                           st.TR2};
      int sx[2][kSources], sy[2][kSources];
#pragma unroll
      for (int s = 0; s <= 6; ++s) {
        sx[0][s] = nbr[s].m0x;
        sy[0][s] = nbr[s].m0y;
        sx[1][s] = nbr[s].m1x;
        sy[1][s] = nbr[s].m1y;
      }
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const uint32_t* w = in + (q + 1) * kInWords * T;
        sx[0][7 + q] = (int)w[8 * T];
        sy[0][7 + q] = (int)w[9 * T];
        sx[1][7 + q] = (int)w[10 * T];
        sy[1][7 + q] = (int)w[11 * T];
      }
      // each source's entry within a CU's [S, S] grid (its integer part
      // clamped into the window: an outside MV's entry is read and
      // ignored), plus the half-pel grids' offset (CU16 and CU32 rows)
      // for a sub-pel MV; then one address add a copy
      const int sr = a.sr, S = 2 * sr + 1, SS = S * S;
      const int n16 = w16 * a.h16, n32 = wc * a.hc;
      int off16[2][kSources], off32[2][kSources];
#pragma unroll
      for (int l = 0; l < 2; ++l) {
#pragma unroll
        for (int s = 0; s < kSources; ++s) {
          const int ix = min(max(sx[l][s] >> 2, -sr), sr);
          const int iy = min(max(sy[l][s] >> 2, -sr), sr);
          const int o = (iy + sr) * S + (ix + sr);
          const bool hp = decide::sub_pel(sx[l][s], sy[l][s]);
          off16[l][s] = o + (hp ? n16 * SS : 0);
          off32[l][s] = o + (hp ? n32 * SS : 0);
        }
      }
      float* dst = sm.pre + r;
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        const int64_t rowk = k == 0 ? (int64_t)2 * n16 + i32 : q16[k - 1];
#pragma unroll
        for (int l = 0; l < 2; ++l) {
          const float* base = (l == 0 ? a.grid0 : a.grid1) + rowk * SS;
#pragma unroll
          for (int s = 0; s < kSources; ++s) {
            if ((need(k) >> s) & 1u)
              cp_async4(dst + pre_at(k, l, s, T),
                        base + (k == 0 ? off32[l][s] : off16[l][s]));
          }
        }
      }
    }
    const CuOut o32{a.ch32, a.mvd0_32, a.mvp0_32, a.mvd1_32, a.mvp1_32,
                    a.js32};
    const CuOut o16{a.chq, a.mvd0q, a.mvp0q, a.mvd1q, a.mvp1q, a.jsq};
    // hypothesis A: one CU32 (A1 left q3, B1 top q3, B0 top-right q2, B2
    // top-left q3)
    const SCand c32[4] = {ext(st.L3, 2), ext(st.T3, 4), ext(st.TR2, 6),
                          ext(st.TL3, 5)};
    const Decision r32 =
        decide_cu<FORCED, 0>(a, c32, in, pre, T, 0, o32, i32);
    // hypothesis B: four CU16 quadrants in z-order
    const SCand cq0[4] = {ext(st.L1, 1), ext(st.T2, 3), ext(st.T3, 4),
                          ext(st.TL3, 5)};
    const Decision d0 =
        decide_cu<FORCED, 1>(a, cq0, in, pre, T, 7, o16, q16[0]);
    const SCand cq1[4] = {local(d0), ext(st.T3, 4), ext(st.TR2, 6),
                          ext(st.T2, 3)};
    const Decision d1 =
        decide_cu<FORCED, 2>(a, cq1, in, pre, T, 8, o16, q16[1]);
    const SCand cq2[4] = {ext(st.L3, 2), local(d0), local(d1),
                          ext(st.L1, 1)};
    const Decision d2 =
        decide_cu<FORCED, 3>(a, cq2, in, pre, T, 9, o16, q16[2]);
    const SCand cq3[4] = {local(d2), local(d1), ext(none, 0), local(d0)};
    const Decision d3 =
        decide_cu<FORCED, 4>(a, cq3, in, pre, T, 0, o16, q16[3]);
    bool split;
    if (FORCED) {
      split = in[7 * T] != 0;
    } else {
      const float js = __fadd_rn(__fadd_rn(__fadd_rn(d0.j, d1.j), d2.j),
                                 d3.j);
      split = js < r32.j;
      if (a.jsplit != nullptr) {
        a.jsplit[i32] = js;
        a.j32[i32] = r32.j;
      }
    }
    a.split[i32] = split;
    const Cell k32 = cell_of(r32);
    const Cell f[4] = {split ? cell_of(d0) : k32, split ? cell_of(d1) : k32,
                       split ? cell_of(d2) : k32,
                       split ? cell_of(d3) : k32};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      a.dir[q16[k]] = f[k].dir;
      reinterpret_cast<int2*>(a.mv0)[q16[k]] = make_int2(f[k].m0x, f[k].m0y);
      reinterpret_cast<int2*>(a.mv1)[q16[k]] = make_int2(f[k].m1x, f[k].m1y);
    }
    o1 = f[1];
    o2 = f[2];
    o3 = f[3];
  }
  // publish this step's bottom cells; take the upper row's
  const int p = t & 1;
  if (row) {
    sm.sa[p * T + r] = make_int4(o2.dir, o2.m0x, o2.m0y, o2.m1x);
    sm.sb[p * T + r] = make_int4(o2.m1y, o3.dir, o3.m0x, o3.m0y);
    sm.sc[p * T + r] = make_int2(o3.m1x, o3.m1y);
  }
  __syncthreads();
  st.TL3 = st.T3;
  st.T2 = st.TR2;
  st.T3 = st.TR3;
  if (row && r > 0) {
    const int4 u = sm.sa[p * T + r - 1];
    const int4 v = sm.sb[p * T + r - 1];
    const int2 w = sm.sc[p * T + r - 1];
    st.TR2 = Cell{u.x, u.y, u.z, u.w, v.x};
    st.TR3 = Cell{v.y, v.z, v.w, w.x, w.y};
  }
  st.L1 = o1;
  st.L3 = o3;
}

// Thread r walks CTU32 row r (see the file's head).  Step -1 only stages
// the first CTU of row 0.
template <bool FORCED>
__global__ void decide_rows_b(const DecideBArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem sm = smem_of(smem, blockDim.x);
  const int r = threadIdx.x;
  const int steps = a.wc + 2 * (a.hc - 1);
  const Cell none{0, 0, 0, 0, 0};
  RowState st{none, none, none, none, none, none, none};
  for (int t = -1; t < steps; ++t) row_step<FORCED>(a, t, r, st, sm);
}

template <bool FORCED>
int launch(const DecideBArgs& a, cudaStream_t stream) {
  const int threads = ((a.hc + 31) / 32) * 32;
  const size_t bytes = smem_bytes(FORCED, threads);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        decide_rows_b<FORCED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  decide_rows_b<FORCED><<<1, threads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int decide_b(const DecideBArgs* args, cudaStream_t stream) {
  const DecideBArgs& a = *args;
  if (a.sr < 1 || a.wc < 1 || a.hc < 1 || a.hc > kMaxRows ||
      a.w16 != 2 * a.wc || a.h16 != 2 * a.hc)
    return (int)cudaErrorInvalidValue;
  return a.f_ch16 != nullptr ? launch<true>(a, stream)
                             : launch<false>(a, stream);
}
