// Device helpers shared by the decide-scan kernels K17 (`decide_p.cu`, the P
// decide scan) and K19 (`decide_b.cu`, the B decide scan): the MVD bin
// count, the spec 8.5.3.2.8 MV scaling, the SSD-grid lookup of a merge
// candidate, and the z-scan positions of the neighbours a CTU32's decide
// reads (spec 6.4.2; JAX models/inter_tree.py decide_body :436-470 and
// :1482-1520).  Header only; each kernel is its own library.

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

// A neighbour 16-cell of the CTU at 16-cell origin (bx, by): its position,
// clamped into the frame as the JAX `nb` clamps it, and whether the z-scan
// makes it available (before the inter test).
struct NbPos {
  int cell;
  bool ok;
};

__device__ __forceinline__ NbPos nb_pos(int px, int py, bool ok, int w16,
                                        int h16) {
  px = px < 0 ? 0 : (px > w16 - 1 ? w16 - 1 : px);
  py = py < 0 ? 0 : (py > h16 - 1 ? h16 - 1 : py);
  return NbPos{py * w16 + px, ok};
}

// The external neighbours of the CTU32's CU32 hypothesis (k = 0..3: A1, B1,
// B0, B2) and of its quadrants (q0: A1 B1 B0 B2; q1: B1 B0 B2 as k = 1..3;
// q2: A1 and B2 as k = 0, 3); the other candidates of q1..q3 are earlier
// quadrants of the same CTU.  left / top / tr: the CTU has a left, top and
// top-right CTU.
__device__ __forceinline__ NbPos nb_cu32(int k, int bx, int by, bool left,
                                         bool top, bool tr, int w16,
                                         int h16) {
  switch (k) {
    case 0: return nb_pos(bx - 1, by + 1, left, w16, h16);
    case 1: return nb_pos(bx + 1, by - 1, top, w16, h16);
    case 2: return nb_pos(bx + 2, by - 1, tr, w16, h16);
    default: return nb_pos(bx - 1, by - 1, left && top, w16, h16);
  }
}

__device__ __forceinline__ NbPos nb_quad(int q, int k, int bx, int by,
                                         bool left, bool top, bool tr,
                                         int w16, int h16) {
  if (q == 0) {
    switch (k) {
      case 0: return nb_pos(bx - 1, by, left, w16, h16);
      case 1: return nb_pos(bx, by - 1, top, w16, h16);
      case 2: return nb_pos(bx + 1, by - 1, top, w16, h16);
      default: return nb_pos(bx - 1, by - 1, left && top, w16, h16);
    }
  }
  if (q == 1) {
    switch (k) {
      case 1: return nb_pos(bx + 1, by - 1, top, w16, h16);
      case 2: return nb_pos(bx + 2, by - 1, tr, w16, h16);
      default: return nb_pos(bx, by - 1, top, w16, h16);
    }
  }
  // q == 2
  return k == 0 ? nb_pos(bx - 1, by + 1, left, w16, h16)
                : nb_pos(bx - 1, by, left, w16, h16);
}

}  // namespace decide
