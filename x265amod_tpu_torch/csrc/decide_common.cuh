// Device helpers shared by the decide-scan kernels K17 (`decide_p.cu`, the P
// decide scan), K19 (`decide_b.cu`, the B decide scan) and K24 / K25
// (`decide_flat.cu`, the flat P and B decide scans): the MVD bin count, the
// spec 8.5.3.2.8 MV scaling, the SSD-grid lookup of a merge candidate, the
// table of the neighbours a CTU32's decisions read, the row walks' motion
// sources, their read set and cp.async copies (K17, K19), and the
// one copy of the B candidate derivation K19, K24 and K25 share (the
// candidate, its pruning test, the AMVP pair with cross-list scaling and
// the predictor pick; K17 keeps its own).  Header only; each kernel is its
// own library.

#pragma once

#include <cstdint>

namespace decide {

__device__ __forceinline__ int bitlen(int a) {
  return a == 0 ? 0 : 32 - __clz(a);
}

// bins of an MVD (x, y) in quarter-pel: 2 (bitlen|x| + bitlen|y|) + 2
__device__ __forceinline__ float mvd_bits(int x, int y) {
  return (float)(2 * (bitlen(abs(x)) + bitlen(abs(y))) + 2);
}

// spec 8.5.3.2.8: sign(x) ((|x| + 127) >> 8) of x = dsf mv, clipped to 16
// bits (the port's inter_tree._scale_mv_vec)
__device__ __forceinline__ int scale_mv(int v, int dsf) {
  const int x = v * dsf;
  const int mag = (abs(x) + 127) >> 8;
  int r = x > 0 ? mag : (x < 0 ? -mag : 0);
  return r < -32768 ? -32768 : (r > 32767 ? 32767 : r);
}

// a merge candidate's MV (mx, my) in quarter-pel prices at the half-pel
// grid when it has a fractional part
__device__ __forceinline__ bool sub_pel(int mx, int my) {
  return (mx & 3) != 0 || (my & 3) != 0;
}

// The SSD-grid entry of the integer part of (mx, my) in row r of the
// stacked grids [rows, S, S] (S = 2 sr + 1, dy-major), or 1e18 outside the
// +-sr window (JAX `lookup`).
__device__ __forceinline__ float grid_at(const float* grid, int64_t r, int sr,
                                         int mx, int my) {
  const int S = 2 * sr + 1;
  const int ix = mx >> 2, iy = my >> 2;
  if (abs(ix) > sr || abs(iy) > sr) return 1e18f;
  return grid[(r * S + (iy + sr)) * S + (ix + sr)];
}

// What an entry outside the +-sr window reads (JAX: 1e18).
__device__ const float kFar = 1e18f;

// The address of the entry grid_at reads: the entry, or kFar outside the
// window, picked in PTX.  A kernel that loads through it issues one
// unconditional load, where a select on the value, or on the address in
// C++, lets the compiler put each load behind a branch of its own.
__device__ __forceinline__ const float* grid_ptr(const float* grid,
                                                 int64_t r, int sr, int mx,
                                                 int my) {
  const int S = 2 * sr + 1;
  const int ix = mx >> 2, iy = my >> 2;
  const bool out = abs(ix) > sr || abs(iy) > sr;
  const float* at = grid + (r * S + (iy + sr)) * S + (ix + sr);
  const float* r_;
  asm("{\n\t.reg .pred p;\n\tsetp.ne.u32 p, %3, 0;\n\t"
      "selp.b64 %0, %1, %2, p;\n\t}"
      : "=l"(r_)
      : "l"(&kFar), "l"(at), "r"((unsigned)out));
  return r_;
}

// The neighbour 16-cells a CTU32's decisions read (spec 6.4.2, z-scan
// availability; JAX models/inter_tree.py decide_body :436-470 and
// :1482-1520), for the CTU at 16-cell origin (bx, by), in the candidate
// order A1, B1, B0, B2 (L, T, TL, TR: the left, top, top-left and
// top-right CTUs; qk: quadrant k, q0 top-left, q1 top-right, q2
// bottom-left, q3 bottom-right):
//   CU32  L q3 (bx-1, by+1), T q3 (bx+1, by-1), TR q2 (bx+2, by-1),
//         TL q3 (bx-1, by-1)
//   q0    L q1 (bx-1, by), T q2 (bx, by-1), T q3, TL q3
//   q1    q0, T q3, TR q2, T q2
//   q2    L q3, q0, q1, L q1
//   q3    q2, q1, none, q0
// So a CTU reads of the CTUs around it only the left CTU's q1 and q3, the
// top-left CTU's q3, the top CTU's q2 and q3 and the top-right CTU's q2:
// the register window of the row walks (K17, K19).
//
// The sources of a candidate's motion in the row walks: 0 the zero MV (on
// reference 0 in P); the neighbour cells 1 left q1, 2 left q3, 3 top q2, 4
// top q3, 5 top-left q3, 6 top-right q2; 7-9 the ME motion of quadrant q0,
// q1, q2.
constexpr int kSources = 10;
// the sources CU k (0 the CU32, 1..4 q0..q3) can meet, bit s: its
// neighbours above, the zero MV, and the earlier quadrants' sources
__host__ __device__ constexpr unsigned need(int k) {
  return k == 0 ? 0x75u : (k == 1 ? 0x3Bu : (k == 2 ? 0xFBu
                                                   : (k == 3 ? 0x1FFu
                                                             : 0x3FFu)));
}

// ---- cp.async: a word from global to shared memory (K17, K19) ----------

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// ---- the B candidate derivation (K19, K24, K25) -------------------------

// A merge / AMVP candidate: availability, direction (bit 0 L0, bit 1 L1)
// and both MVs (a P candidate: direction 1, MV1 zero).
struct Cand {
  bool av;
  int dir, m0x, m0y, m1x, m1y;
};

// The rows of a warp decide different CTUs, so a branch on a CTU's data
// splits the warp and runs both sides one after the other.  The compiler
// turns a select whose one side costs more into such a branch; `pick`
// selects in inline PTX, which it cannot, so both sides are formed.
__device__ __forceinline__ int pick(bool c, int a, int b) {
  int r;
  asm("{\n\t.reg .pred p;\n\tsetp.ne.u32 p, %3, 0;\n\t"
      "selp.b32 %0, %1, %2, p;\n\t}"
      : "=r"(r)
      : "r"(a), "r"(b), "r"((unsigned)c));
  return r;
}

// merge pruning of B candidates: direction and both MVs (every compare
// made: `&` where `&&` would branch past the later ones)
__device__ __forceinline__ bool same_b(const Cand& a, const Cand& b) {
  return (a.dir == b.dir) & (a.m0x == b.m0x) & (a.m0y == b.m0y) &
         (a.m1x == b.m1x) & (a.m1y == b.m1y);
}

// the MV of list li of candidate x
__device__ __forceinline__ void own_mv(const Cand& x, int li, int& vx,
                                       int& vy) {
  vx = li == 0 ? x.m0x : x.m1x;
  vy = li == 0 ? x.m0y : x.m1y;
}

// candidate x's predictor for list li: its own MV when it holds list li,
// else its other-list MV scaled by dsf (JAX `mvp_of`); both are formed and
// one picked
__device__ __forceinline__ void mvp_of(const Cand& x, int li, int dsf,
                                       int& vx, int& vy) {
  int ox, oy, tx, ty;
  own_mv(x, li, ox, oy);
  own_mv(x, 1 - li, tx, ty);
  const bool has = (x.dir >> li) & 1;
  vx = pick(has, ox, scale_mv(tx, dsf));
  vy = pick(has, oy, scale_mv(ty, dsf));
}

// The B AMVP pair of list li (JAX models/b_frame.py `amvp` :293-325 and
// the B tree's models/inter_tree.py `amvp` :1370-1403) from c in the order
// A1, B1, B0, B2: A from A1; B the first of B0, B1, B2 holding list li
// unscaled, else the first available scaled; pruned and zero-filled.
// p = (c0x, c0y, c1x, c1y).  The B candidates are taken in a fixed,
// unrolled order and every choice is a select, so no candidate is indexed
// at run time and no row of a warp branches.
__device__ __forceinline__ void amvp_b(const Cand c[4], int li, int dsf,
                                       int p[4]) {
  int cax, cay;
  mvp_of(c[0], li, dsf, cax, cay);
  const bool ca_v = c[0].av;
  const int order[3] = {2, 1, 3};     // B0, B1, B2
  bool bp1_v = false, bs_v = false;
  int bp1x = 0, bp1y = 0, bsx = 0, bsy = 0;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const Cand& x = c[order[k]];
    int ox, oy, mx, my;
    own_mv(x, li, ox, oy);
    mvp_of(x, li, dsf, mx, my);
    const bool take_p = !bp1_v & x.av & ((x.dir >> li) & 1);
    const bool take_s = !bs_v & x.av;
    bp1x = take_p ? ox : bp1x;
    bp1y = take_p ? oy : bp1y;
    bsx = take_s ? mx : bsx;
    bsy = take_s ? my : bsy;
    bp1_v = bp1_v || take_p;
    bs_v = bs_v || take_s;
  }
  const int c0x = ca_v ? cax : (bp1_v ? bp1x : (bs_v ? bsx : 0));
  const int c0y = ca_v ? cay : (bp1_v ? bp1y : (bs_v ? bsy : 0));
  const bool c1_v = ca_v ? bp1_v : (bp1_v && bs_v);
  const int c1x = ca_v ? bp1x : bsx;
  const int c1y = ca_v ? bp1y : bsy;
  const bool keep = c1_v && !(c1x == c0x && c1y == c0y);
  p[0] = c0x;
  p[1] = c0y;
  p[2] = keep ? c1x : 0;
  p[3] = keep ? c1y : 0;
}

// The MVD of (mx, my) against the predictor with fewer bins (A on a tie:
// index 1 only when its bins are strictly fewer): mvd, index, and the bins
// of the one taken.
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

}  // namespace decide
