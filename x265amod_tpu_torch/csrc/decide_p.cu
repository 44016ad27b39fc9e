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
// reference) and an unfilled merge slot is the zero MV on reference 0; AMVP
// scales a neighbour's MV to the CU's reference through dsf (spec
// 8.5.3.2.8, JAX `scale_to` :355); the inter cost carries the ref_idx bins;
// a skip candidate is priced from the SSD grid of its own reference (its
// half-pel grid when it is sub-pel): row base + (sub R + r) n + idx of the
// stacked grids.
//
// Three costs take an FMA where XLA's CPU code contracts a product with one
// use into the add that follows it (read from the decide body's optimized
// HLO and LLVM IR; the plain version uses an exact f32 fma):
//   j_inter = fma(lam, ((rb + min(b0, b1)) + refbits[ref]) + 6, d)
//   j_skip  = fma(lam, 2 or 3, grid value or 1e18 outside the window)
//   j_intra = fma(lam, intra header bits, intra trial cost)
// The file is built with --fmad=false so that nothing else contracts.
//
// What bounds it on an H100: neither bytes nor operations (it reads a few
// dozen SSD-grid entries a CTU, a few hundred KB of the grids); its time is
// the latency of one thread's chain of five CU decisions a step times the
// number of wavefront steps (84 at 1280x736, 126 at 1920x1088).
//
// Design (`decide_rows_p`, K19's row walk with the P derivation): one
// thread block, a thread a CTU32 row.  Thread r decides CTU (t - 2 r, r) at
// step t, the wavefront of the diagonals, so the same decisions.  What a
// CTU reads of its neighbours is, by cell (spec 6.4.2; the table in
// decide_common.cuh): the left CTU's q1 and q3, the top-left
// CTU's q3, the top CTU's q2 and q3 and the top-right CTU's q2.  So
//   - the left CTU's cells are the thread's own commit of step t - 1;
//   - the row above's are a register window of its commits of steps t - 1
//     (top-right), t - 2 (top) and t - 3 (top-left): each step a row
//     publishes its CTU's bottom cells q2 and q3 into a shared-memory slot
//     by the step's parity, and one barrier a step hands them down.  A
//     cell is three words: the inter flag and the reference in one (inter
//     | ref << 1: 0 for an intra cell, whose MV and reference are zero) and
//     the MV;
//   - a row before its first CTU or after its last publishes zeros, so an
//     unavailable neighbour reads as zeros, as the committed motion of an
//     intra cell does.  Every position the JAX `nb` clamps is inside the
//     frame whenever its availability flag is set (the wrapper gives w16 =
//     2 wc and h16 = 2 hc), so the window holds every cell the JAX `nb`
//     reads;
//   - the inputs that do not depend on the neighbours (free, per CU: the
//     trial distortion and rate, lambda, the intra cost, the ME MV and its
//     reference, 34 words; forced: the given choices, MVDs, MVP indices and
//     references and the split, 26 words) are copied a step ahead into the
//     thread's column of shared memory by `cp.async`, the next CTU of a row
//     being the next raster index;
//   - every SSD-grid entry any of the CTU's five decisions can price is
//     read as the step starts, so one memory round trip is on the step's
//     chain.  A candidate's (MV, reference) is one of ten sources: the zero
//     MV on reference 0, one of the six neighbour cells above, or the ME
//     motion of quadrant q0, q1 or q2 (a quadrant ends on its merge
//     candidate 0 or 1, which carries an earlier source, on its own ME
//     motion, or as intra, which no one reads).  An entry's row depends
//     only on its source's sub-pel flag and reference.  Each decision
//     carries its source; the entries of each CU's row at each source it
//     can meet (CU32 5, q0 5, q1 7, q2 9, q3 10: 36) are copied into the
//     thread's column of shared memory by `cp.async`, and a merge
//     candidate's skip price is the entry of its source;
//   - the rows of a warp walk different CTUs, so a branch on a CTU's data
//     splits the warp: the merge list, the AMVP pair with its dsf scaling,
//     the tie rule b1 < b0, the first minimum and an outside MV's 1e18 are
//     selects (`pick` where nvcc would branch);
//   - dsf [R, R] and the ref_idx bins [R] are copied into shared memory
//     once, so a scaling reads them without a trip to device memory.
// A forced mode replays the given split, choices, MVDs, MVP indices and
// references through the same derivation, without grid reads.  Every input
// and output is raster; the kernel needs no scratch in device memory.
//
// Entry point (plain C, caller's stream, returns cudaGetLastError()):
//   decide_p(const DecideArgs* args, cudaStream_t stream)

#include <cstdint>
#include <cuda_runtime.h>

#include "decide_common.cuh"

extern "C" {
struct DecideArgs {
  // geometry (w16 = 2 wc, h16 = 2 hc)
  int wc, hc, w16, h16, sr, R;
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
  // forced mode (all null when free): choice, MVD, MVP index and reference
  // per CU16 cell and per CTU (the CU32 hypothesis), split per CTU
  const int32_t *f_ch16, *f_mvd16, *f_mvp16, *f_ref16;
  const int32_t *f_ch32, *f_mvd32, *f_mvp32, *f_ref32, *f_split;
  // outputs (raster)
  int32_t *split, *ch32, *mvd32, *mvp32, *ref32_out;
  int32_t *chq, *mvdq, *mvpq, *refq, *mv_cell, *ref_cell;
  // optional cost rows (null unless wanted)
  float *jsq, *js32, *jsplit, *j32;
};
}

namespace {

using decide::cp_async4;
using decide::cp_async_wait_all;
using decide::kSources;
using decide::mvd_bits;
using decide::need;
using decide::pick;
using decide::scale_mv;

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

// the most CTU32 rows a launch takes (8192 luma rows: 256 threads)
constexpr int kMaxRows = 256;

// A committed 16-cell: ir = inter | ref << 1 (0: intra or nothing; its MV
// and reference are zero) and its MV.
struct Cell {
  int ir, mx, my;
};

// a merge / AMVP candidate with the source of its motion
struct Cand {
  bool av;
  int mx, my, rf, s;
};

__device__ __forceinline__ Cand ext(const Cell& e, int s) {
  return Cand{(e.ir & 1) != 0, e.mx, e.my, e.ir >> 1, s};
}

// what a CU decision hands on: its choice, final MV, reference and their
// source, and its cost
struct Decision {
  int choice, mx, my, rf, s;
  float j;
};

__device__ __forceinline__ Cand local(const Decision& d) {
  return Cand{d.choice <= 2, d.mx, d.my, d.rf, d.s};
}

// merge pruning: MV and reference (every compare made)
__device__ __forceinline__ bool same(const Cand& a, const Cand& b) {
  return (a.mx == b.mx) & (a.my == b.my) & (a.rf == b.rf);
}

// ---- a CTU's inputs, staged a step ahead in shared memory ----------------

// Words a CU's inputs take: free, d rb lam di mex mey ref (the CU32 without
// di); forced, ch mvdx mvdy mvp ref, and the CU32's word 5 the split.
constexpr int kInWords = 7;
constexpr int kStepWords = 5 * kInWords;

// Copy the inputs of CTU i32 (top-left 16-cell c0) into `in`, the thread's
// column of one input buffer (word w of CU k at ((k kInWords + w) T)).
template <bool FORCED>
__device__ __forceinline__ void stage_in(const DecideArgs& a, int i32,
                                         int c0, uint32_t* in, int T) {
  const int q16[4] = {c0, c0 + 1, c0 + a.w16, c0 + a.w16 + 1};
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const bool is32 = k == 0;
    const int i = is32 ? i32 : q16[k - 1];
    uint32_t* w = in + k * kInWords * T;
    if (FORCED) {
      const int32_t* mvd = (is32 ? a.f_mvd32 : a.f_mvd16) + 2 * i;
      cp_async4(w, (is32 ? a.f_ch32 : a.f_ch16) + i);
      cp_async4(w + T, mvd);
      cp_async4(w + 2 * T, mvd + 1);
      cp_async4(w + 3 * T, (is32 ? a.f_mvp32 : a.f_mvp16) + i);
      cp_async4(w + 4 * T, (is32 ? a.f_ref32 : a.f_ref16) + i);
      if (is32) cp_async4(w + 5 * T, a.f_split + i32);
    } else {
      const int32_t* mv = (is32 ? a.mv32 : a.mv16) + 2 * i;
      cp_async4(w, (is32 ? a.d32 : a.d16) + i);
      cp_async4(w + T, (is32 ? a.rb32 : a.rb16) + i);
      cp_async4(w + 2 * T, (is32 ? a.lam32 : a.lam16) + i);
      if (!is32) cp_async4(w + 3 * T, a.di16 + i);
      cp_async4(w + 4 * T, mv);
      cp_async4(w + 5 * T, mv + 1);
      cp_async4(w + 6 * T, (is32 ? a.ref32 : a.ref16) + i);
    }
  }
}

// A CU's inputs: free, the trial distortion and rate, lambda, intra cost
// (CU32: none), the ME MV and its reference; forced, the choice, the MVD
// (in the ME MV's place), the MVP index and the reference.
struct CuIn {
  float d, rb, lam, di;
  int mx, my, ref, ch, mvp;
};

template <bool FORCED>
__device__ __forceinline__ CuIn read_in(const uint32_t* in, int k, int T) {
  const uint32_t* w = in + k * kInWords * T;
  CuIn v{};
  if (FORCED) {
    v.ch = (int)w[0];
    v.mx = (int)w[T];
    v.my = (int)w[2 * T];
    v.mvp = (int)w[3 * T];
    v.ref = (int)w[4 * T];
  } else {
    v.d = __uint_as_float(w[0]);
    v.rb = __uint_as_float(w[T]);
    v.lam = __uint_as_float(w[2 * T]);
    v.di = k == 0 ? 0.0f : __uint_as_float(w[3 * T]);
    v.mx = (int)w[4 * T];
    v.my = (int)w[5 * T];
    v.ref = (int)w[6 * T];
  }
  return v;
}

__device__ __forceinline__ bool inside(int mx, int my, int sr) {
  return abs(mx >> 2) <= sr && abs(my >> 2) <= sr;
}

// The entry of CU k at source s lives at pre[(k 10 + s) T] of the thread's
// column (T threads).
__device__ __forceinline__ int pre_at(int k, int s, int T) {
  return (k * kSources + s) * T;
}

// ---- one CU decision -----------------------------------------------------

// Output rows of one CU size.
struct CuOut {
  int32_t *ch, *mvd, *mvp, *ref;
  float* js;
};

// One P CU decision (JAX decide_cu :363-476) from its candidates c in the
// order A1, B1, B0, B2; K is the CU (0 the CU32, 1..4 q0..q3) whose inputs
// lie in `inputs` and grid entries in `pre` (the thread's columns, T
// threads); me_src the source id of its ME motion; i its output row; dsf
// and refbits the tables in shared memory.
template <bool FORCED, int K>
__device__ __forceinline__ Decision decide_cu(
    const DecideArgs& a, const Cand c[4], const uint32_t* inputs,
    const float* pre, int T, int me_src, const CuOut& out, int i,
    const int* dsf, const float* refbits) {
  const CuIn in = read_in<FORCED>(inputs, K, T);
  // merge list: B1 pruned against A1, B0 against B1, B2 against A1 and B1;
  // the first two kept, an unfilled slot the zero MV on reference 0
  // (chosen field by field with selects: no row of a warp branches)
  bool m_av[4];
  m_av[0] = c[0].av;
  m_av[1] = c[1].av & !(c[0].av & same(c[1], c[0]));
  m_av[2] = c[2].av & !(c[1].av & same(c[2], c[1]));
  m_av[3] = c[3].av & !(c[0].av & same(c[3], c[0])) &
            !(c[1].av & same(c[3], c[1]));
  Cand mrg[2];
  mrg[0] = mrg[1] = Cand{true, 0, 0, 0, 0};
  int k2 = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const bool take = m_av[j] & (k2 == m);
      Cand& o = mrg[m];
      o.mx = pick(take, c[j].mx, o.mx);
      o.my = pick(take, c[j].my, o.my);
      o.rf = pick(take, c[j].rf, o.rf);
      o.s = pick(take, c[j].s, o.s);
    }
    k2 += m_av[j];
  }
  // AMVP: A = A1, B = the first of (B0, B1, B2), each scaled to the CU's
  // reference when it lies on another; B pruned against A
  const int cur = in.ref, R = a.R;
  const bool avb = c[1].av | c[2].av | c[3].av;
  const int cbx = pick(c[2].av, c[2].mx, pick(c[1].av, c[1].mx, c[3].mx));
  const int cby = pick(c[2].av, c[2].my, pick(c[1].av, c[1].my, c[3].my));
  const int cbr = pick(c[2].av, c[2].rf, pick(c[1].av, c[1].rf, c[3].rf));
  const int fa = dsf[c[0].rf * R + cur], fb = dsf[cbr * R + cur];
  const bool xa = c[0].rf != cur, xb = cbr != cur;
  const int sax = pick(xa, scale_mv(c[0].mx, fa), c[0].mx);
  const int say = pick(xa, scale_mv(c[0].my, fa), c[0].my);
  const int sbx = pick(xb, scale_mv(cbx, fb), cbx);
  const int sby = pick(xb, scale_mv(cby, fb), cby);
  const bool dup = (sbx == sax) & (sby == say);
  const int a0x = pick(c[0].av, sax, pick(avb, sbx, 0));
  const int a0y = pick(c[0].av, say, pick(avb, sby, 0));
  const bool a1ok = c[0].av & avb & !dup;
  const int a1x = pick(a1ok, sbx, 0), a1y = pick(a1ok, sby, 0);
  int ch, mvdx, mvdy, mvp, mex, mey;
  float j = 0.0f;
  if (FORCED) {
    ch = in.ch;
    mvdx = in.mx;
    mvdy = in.my;
    mvp = in.mvp == 1;
    mex = pick(mvp, a1x, a0x) + mvdx;
    mey = pick(mvp, a1y, a0y) + mvdy;
  } else {
    mex = in.mx;
    mey = in.my;
    const int d0x = mex - a0x, d0y = mey - a0y;
    const int d1x = mex - a1x, d1y = mey - a1y;
    const float b0 = mvd_bits(d0x, d0y), b1 = mvd_bits(d1x, d1y);
    mvp = b1 < b0;
    mvdx = pick(mvp, d1x, d0x);
    mvdy = pick(mvp, d1y, d0y);
    const float m = mvp ? b1 : b0;
    const float x = __fadd_rn(
        __fadd_rn(__fadd_rn(in.rb, m), refbits[cur]), 6.0f);
    const float lam = in.lam;
    if (K == 0) cp_async_wait_all();
    float js[4];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float e = pre[pre_at(K, mrg[q].s, T)];
      const float v = inside(mrg[q].mx, mrg[q].my, a.sr) ? e : 1e18f;
      js[q] = __fmaf_rn(lam, q == 0 ? 2.0f : 3.0f, v);
    }
    js[2] = __fmaf_rn(lam, x, in.d);
    js[3] = K == 0 ? inf() : __fmaf_rn(lam, a.intra_hdr_bits, in.di);
    ch = 0;
    j = js[0];
#pragma unroll
    for (int q = 1; q < 4; ++q) {
      const bool lt = js[q] < j;
      j = lt ? js[q] : j;
      ch = lt ? q : ch;
    }
    if (out.js != nullptr)
      reinterpret_cast<float4*>(out.js)[i] =
          make_float4(js[0], js[1], js[2], js[3]);
  }
  // the final motion and its source: a merge choice takes its candidate's,
  // an AMVP choice the ME (or replayed) MV on the CU's reference, intra
  // none (selected field by field: a candidate chosen at run time would put
  // the merge list in local memory)
  const bool mg = ch <= 1, m1 = ch == 1, am = ch == 2;
  Decision o;
  o.choice = ch;
  o.j = j;
  o.mx = mg ? pick(m1, mrg[1].mx, mrg[0].mx) : pick(am, mex, 0);
  o.my = mg ? pick(m1, mrg[1].my, mrg[0].my) : pick(am, mey, 0);
  o.rf = mg ? pick(m1, mrg[1].rf, mrg[0].rf) : pick(am, cur, 0);
  o.s = mg ? pick(m1, mrg[1].s, mrg[0].s) : pick(am, me_src, 0);
  out.ch[i] = ch;
  reinterpret_cast<int2*>(out.mvd)[i] = make_int2(mvdx, mvdy);
  out.mvp[i] = mvp;
  out.ref[i] = o.rf;
  return o;
}

// ---- the row walk ----------------------------------------------------------

// A row's state between steps: the left CTU's q1 and q3 (its own commit)
// and the window of the row above: the top-right CTU's q2 and q3 (step t -
// 1), the top CTU's (t - 2), the top-left CTU's q3 (t - 3).
struct RowState {
  Cell L1, L3, TR2, TR3, T2, T3, TL3;
};

// Dynamic shared memory: dsf and the ref_idx bins (16 + 4 words), then
// each thread's data in its column (word j of thread r at j T + r): the
// commit slots by parity (a row's q2 and q3: six words in an int4 and an
// int2), the two input buffers (the current CTU's and the next's, by the
// step's parity), then (free) the grid entries.
struct Smem {
  int* dsf;
  float* refbits;
  int4* sa;
  int2* sb;
  uint32_t* in;
  float* pre;
};

constexpr int kTableWords = 32;  // dsf 16, refbits 4, padded to 16 bytes

__device__ __forceinline__ Smem smem_of(unsigned char* base, int T) {
  Smem s;
  s.dsf = reinterpret_cast<int*>(base);
  s.refbits = reinterpret_cast<float*>(s.dsf + 16);
  s.sa = reinterpret_cast<int4*>(s.dsf + kTableWords);
  s.sb = reinterpret_cast<int2*>(s.sa + 2 * T);
  s.in = reinterpret_cast<uint32_t*>(s.sb + 2 * T);
  s.pre = reinterpret_cast<float*>(s.in + 2 * kStepWords * T);
  return s;
}

// bytes of shared memory a launch of T threads takes
constexpr size_t smem_bytes(bool forced, int T) {
  return kTableWords * 4 +
         (size_t)T * (2 * (sizeof(int4) + sizeof(int2)) +
                      2 * kStepWords * sizeof(uint32_t) +
                      (forced ? 0 : 5 * kSources * sizeof(float)));
}

// Step t of row r: decide CTU (t - 2 r, r) from the window and its
// inputs (staged a step ahead in input buffer t & 1), stage the next CTU's
// inputs into the other buffer, exchange commits with the rows around.
template <bool FORCED>
__device__ __forceinline__ void row_step(const DecideArgs& a, int t, int r,
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
  const Cell none{0, 0, 0};
  Cell o1 = none, o2 = none, o3 = none;
  if (act) {
    const int q16[4] = {c0, c0 + 1, c0 + w16, c0 + w16 + 1};
    const float* pre = sm.pre + r;
    if (!FORCED) {
      // every entry the five decisions can price, by source (the wait
      // for them is in the CU32's decision, after its derivation)
      const Cell nbr[7] = {none, st.L1, st.L3, st.T2, st.T3, st.TL3,
                           st.TR2};
      int sx[kSources], sy[kSources], sf[kSources];
#pragma unroll
      for (int s = 0; s <= 6; ++s) {
        sx[s] = nbr[s].mx;
        sy[s] = nbr[s].my;
        sf[s] = nbr[s].ir >> 1;
      }
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const uint32_t* w = in + (q + 1) * kInWords * T;
        sx[7 + q] = (int)w[4 * T];
        sy[7 + q] = (int)w[5 * T];
        sf[7 + q] = (int)w[6 * T];
      }
      // each source's entry within a CU's [S, S] grid (its integer part
      // clamped into the window: an outside MV's entry is read and
      // ignored) and its block of grid rows (sub-pel R + reference); then
      // one multiply-add a copy
      const int sr = a.sr, S = 2 * sr + 1, SS = S * S, R = a.R;
      const int n16 = w16 * a.h16, n32 = wc * a.hc;
      int off[kSources], blk[kSources];
#pragma unroll
      for (int s = 0; s < kSources; ++s) {
        const int ix = min(max(sx[s] >> 2, -sr), sr);
        const int iy = min(max(sy[s] >> 2, -sr), sr);
        off[s] = (iy + sr) * S + (ix + sr);
        blk[s] = (decide::sub_pel(sx[s], sy[s]) ? R : 0) + sf[s];
      }
      float* dst = sm.pre + r;
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        const int rowk = k == 0 ? 2 * R * n16 + i32 : q16[k - 1];
        const int nk = k == 0 ? n32 : n16;
#pragma unroll
        for (int s = 0; s < kSources; ++s) {
          if ((need(k) >> s) & 1u)
            cp_async4(dst + pre_at(k, s, T),
                      a.grid + (int64_t)(rowk + blk[s] * nk) * SS + off[s]);
        }
      }
    }
    const CuOut o32{a.ch32, a.mvd32, a.mvp32, a.ref32_out, a.js32};
    const CuOut o16{a.chq, a.mvdq, a.mvpq, a.refq, a.jsq};
    const int* dsf = sm.dsf;
    const float* rbits = sm.refbits;
    // hypothesis A: one CU32 (A1 left q3, B1 top q3, B0 top-right q2, B2
    // top-left q3)
    const Cand c32[4] = {ext(st.L3, 2), ext(st.T3, 4), ext(st.TR2, 6),
                         ext(st.TL3, 5)};
    const Decision r32 = decide_cu<FORCED, 0>(a, c32, in, pre, T, 0, o32,
                                              i32, dsf, rbits);
    // hypothesis B: four CU16 quadrants in z-order
    const Cand cq0[4] = {ext(st.L1, 1), ext(st.T2, 3), ext(st.T3, 4),
                         ext(st.TL3, 5)};
    const Decision d0 = decide_cu<FORCED, 1>(a, cq0, in, pre, T, 7, o16,
                                             q16[0], dsf, rbits);
    const Cand cq1[4] = {local(d0), ext(st.T3, 4), ext(st.TR2, 6),
                         ext(st.T2, 3)};
    const Decision d1 = decide_cu<FORCED, 2>(a, cq1, in, pre, T, 8, o16,
                                             q16[1], dsf, rbits);
    const Cand cq2[4] = {ext(st.L3, 2), local(d0), local(d1),
                         ext(st.L1, 1)};
    const Decision d2 = decide_cu<FORCED, 3>(a, cq2, in, pre, T, 9, o16,
                                             q16[2], dsf, rbits);
    const Cand cq3[4] = {local(d2), local(d1), ext(none, 0), local(d0)};
    const Decision d3 = decide_cu<FORCED, 4>(a, cq3, in, pre, T, 0, o16,
                                             q16[3], dsf, rbits);
    bool split;
    if (FORCED) {
      split = in[5 * T] != 0;
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
    // the committed cells: the quadrants' where split, else the CU32's
    // (inter whatever its choice, as the JAX commit sets it)
    const Decision dq[4] = {d0, d1, d2, d3};
    Cell f[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const Decision& e = dq[k];
      const int inter = split ? (e.choice <= 2) : 1;
      f[k].mx = pick(split, e.mx, r32.mx);
      f[k].my = pick(split, e.my, r32.my);
      const int rf = pick(split, e.rf, r32.rf);
      f[k].ir = inter | (rf << 1);
      reinterpret_cast<int2*>(a.mv_cell)[q16[k]] = make_int2(f[k].mx,
                                                             f[k].my);
      a.ref_cell[q16[k]] = rf;
    }
    o1 = f[1];
    o2 = f[2];
    o3 = f[3];
  }
  // publish this step's bottom cells; take the upper row's
  const int p = t & 1;
  if (row) {
    sm.sa[p * T + r] = make_int4(o2.ir, o2.mx, o2.my, o3.ir);
    sm.sb[p * T + r] = make_int2(o3.mx, o3.my);
  }
  __syncthreads();
  st.TL3 = st.T3;
  st.T2 = st.TR2;
  st.T3 = st.TR3;
  if (row && r > 0) {
    const int4 u = sm.sa[p * T + r - 1];
    const int2 v = sm.sb[p * T + r - 1];
    st.TR2 = Cell{u.x, u.y, u.z};
    st.TR3 = Cell{u.w, v.x, v.y};
  }
  st.L1 = o1;
  st.L3 = o3;
}

// Thread r walks CTU32 row r (see the file's head).  Step -1 only stages
// the first CTU of row 0 (and copies the tables).
template <bool FORCED>
__global__ void decide_rows_p(const DecideArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem sm = smem_of(smem, blockDim.x);
  const int r = threadIdx.x;
  if (r < a.R * a.R) sm.dsf[r] = a.dsf[r];
  if (r < a.R) sm.refbits[r] = a.refbits[r];
  const int steps = a.wc + 2 * (a.hc - 1);
  const Cell none{0, 0, 0};
  RowState st{none, none, none, none, none, none, none};
  // (the tables are seen after step -1's barrier)
  for (int t = -1; t < steps; ++t) row_step<FORCED>(a, t, r, st, sm);
}

template <bool FORCED>
int launch(const DecideArgs& a, cudaStream_t stream) {
  const int threads = ((a.hc + 31) / 32) * 32;
  const size_t bytes = smem_bytes(FORCED, threads);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        decide_rows_p<FORCED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  decide_rows_p<FORCED><<<1, threads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int decide_p(const DecideArgs* args, cudaStream_t stream) {
  const DecideArgs& a = *args;
  if (a.R < 1 || a.R > 4 || a.sr < 1 || a.wc < 1 || a.hc < 1 ||
      a.hc > kMaxRows || a.w16 != 2 * a.wc || a.h16 != 2 * a.hc)
    return (int)cudaErrorInvalidValue;
  return a.f_ch16 != nullptr ? launch<true>(a, stream)
                             : launch<false>(a, stream);
}
