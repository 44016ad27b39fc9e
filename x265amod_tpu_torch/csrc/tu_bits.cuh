// Device functions of K3 `tu_bits`, shared by K3 (`tu_bits.cu`) and K23
// (`intra16_scan.cu`): the context-anchored fractional CABAC bits of a TU
// (cbf, last position, coded-sub-block flags, significance map,
// greater1/greater2 flags, Golomb-Rice remainders, signs), priced from one
// row of the [52, 13] QP-indexed table of the slice type (JAX
// ops/estbits.py tu_bits).
//
// A TU's 4x4 coefficient groups are counted one per call of `group_count`
// (from the group's 16 levels in registers) or `group_local` (from a
// pointer), then met by `combine` inside a lane and by warp reductions
// (`reduce_lanes`, `group_counts_lanes`), exact and order-independent;
// `total_bits` then prices them.
// Every fractional family is summed in integer units of 2^-15 bit,
// converted once (round to nearest), and the nine families are added in the
// JAX expression's order with __fadd_rn / __fmul_rn, so the files that
// include this build with --fmad=false.  Inside the flat CTB16 scan's
// argmin fusion XLA contracts the first step, cbf1 + (last-position bins) *
// last_bin, into an FMA; that product is exact in f32 for every QP row and
// position pair (tests/test_torch_flat.py), so the rounded form here is the
// same value.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace tu_bits_dev {

struct TuCounts {
  int n_cod, n1, n0, dc_nz, cg0_cod, g1_1, g1_0, g2, rem_i, over8, nnz, lx,
      ly;
};

__device__ __forceinline__ void clear(TuCounts* c) {
  c->n_cod = c->n1 = c->n0 = c->dc_nz = c->cg0_cod = c->g1_1 = c->g1_0 =
      c->g2 = c->rem_i = c->over8 = c->nnz = c->lx = c->ly = 0;
}

__device__ __forceinline__ int bitlen(int x) {
  return x > 0 ? 32 - __clz(x) : 0;
}

// last_sig_coeff prefix + suffix bin count of position v (spec 9.3.3.1)
__device__ __forceinline__ float last_pos_bins(int v) {
  int gi;
  if (v < 4) {
    gi = v;
  } else {
    const int k = 31 - __clz(v);
    gi = 2 * k + ((v >> (k - 1)) & 1);
  }
  const int prefix = gi + 1 < 18 ? gi + 1 : 18;
  return (float)(prefix + (gi > 3 ? (gi >> 1) - 1 : 0));
}

__device__ __forceinline__ long long units(float v) {
  return (long long)__float2ll_rn(__fmul_rn(v, 32768.0f));
}

// Bins of a Golomb-Rice remainder rem > 0 at Rice parameter k: the prefix
// and suffix, escaping to Exp-Golomb beyond a prefix of 3.
__device__ __forceinline__ int golomb_len(int rem, int k) {
  const int pref = rem >> k;
  int m = rem - (2 << k);
  m = m < 1 ? 1 : m;
  return pref < 3 ? pref + 1 + k : 3 + 2 * (bitlen(m) - k) + k;
}

// Counts of coefficient group g of a TU of size n from its 16 levels v
// (raster order inside the group) alone (all zero when the group codes
// nothing).  One pass takes the magnitudes, their sum and two bit masks
// (nonzero, beyond 1); the flags follow from the masks by popcounts: the
// first 8 nonzero levels in scan order (the lowest 8 set bits) carry a
// greater1 flag, the others 1 + k bypass bins each; a second pass prices
// the remainders, only where a level is beyond 1 (taken beyond 3: a - 3;
// the others: a - 1).
__device__ __forceinline__ TuCounts group_count(const int v[16], int n,
                                                int g) {
  const int g4 = n / 4;
  const int gy = g / g4, gx = g % g4;
  TuCounts c;
  clear(&c);
  int a[16];
  int cg_sum = 0;
  unsigned nz = 0, gt1 = 0;
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    a[q] = v[q] < 0 ? -v[q] : v[q];
    cg_sum += a[q];
    nz |= (unsigned)(a[q] != 0) << q;
    gt1 |= (unsigned)(a[q] > 1) << q;
  }
  if (!nz) return c;
  int k = bitlen(cg_sum) - 5;
  k = k < 0 ? 0 : (k > 4 ? 4 : k);
  unsigned rest = nz;
#pragma unroll
  for (int i = 0; i < 8; ++i) rest &= rest - 1;
  const unsigned take = nz ^ rest;
  c.g1_1 = __popc(take & gt1);
  c.g1_0 = __popc(take) - c.g1_1;
  c.g2 = c.g1_1 > 0;
  c.over8 = __popc(rest) * (1 + k);
  // group 0's DC is priced apart from the other positions
  c.n1 = __popc(g == 0 ? nz & ~1u : nz);
  c.n0 = (g == 0 ? 15 : 16) - c.n1;
  if (gt1) {
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int rem = a[q] - ((take >> q) & 1 ? 3 : 1);
      if (((gt1 >> q) & 1) && rem > 0) c.rem_i += golomb_len(rem, k);
    }
  }
  const unsigned cols = (nz | nz >> 4 | nz >> 8 | nz >> 12) & 0xfu;
  const unsigned rows = (unsigned)((nz & 0xfu) != 0) |
                        (unsigned)((nz & 0xf0u) != 0) << 1 |
                        (unsigned)((nz & 0xf00u) != 0) << 2 |
                        (unsigned)((nz & 0xf000u) != 0) << 3;
  c.n_cod = 1;
  c.nnz = __popc(nz);
  c.lx = gx * 4 + 31 - __clz(cols);
  c.ly = gy * 4 + 31 - __clz(rows);
  if (g == 0) {
    c.cg0_cod = 1;
    c.dc_nz = nz & 1u;
  }
  return c;
}

// Counts of coefficient group g of the n x n levels lv (row stride n)
// alone.
template <class T>
__device__ __forceinline__ TuCounts group_local(const T* lv, int n, int g) {
  const int g4 = n / 4;
  const int gy = g / g4, gx = g % g4;
  int v[16];
#pragma unroll
  for (int q = 0; q < 16; ++q)
    v[q] = lv[(gy * 4 + q / 4) * n + gx * 4 + q % 4];
  return group_count(v, n, g);
}

// The counts of two sets of groups of one TU taken together.
__device__ __forceinline__ TuCounts combine(const TuCounts& a,
                                           const TuCounts& b) {
  TuCounts c;
  c.n_cod = a.n_cod + b.n_cod;
  c.n1 = a.n1 + b.n1;
  c.n0 = a.n0 + b.n0;
  c.g1_1 = a.g1_1 + b.g1_1;
  c.g1_0 = a.g1_0 + b.g1_0;
  c.g2 = a.g2 + b.g2;
  c.rem_i = a.rem_i + b.rem_i;
  c.over8 = a.over8 + b.over8;
  c.nnz = a.nnz + b.nnz;
  c.lx = a.lx > b.lx ? a.lx : b.lx;
  c.ly = a.ly > b.ly ? a.ly : b.ly;
  c.cg0_cod = a.cg0_cod | b.cg0_cod;
  c.dc_nz = a.dc_nz | b.dc_nz;
  return c;
}

// The counts of a TU whose groups the lanes of `mask` hold, each lane's
// counts in l (every lane of the mask calls it, with every group of the TU
// among them): warp reductions instead of atomics, the sums in every lane.
__device__ __forceinline__ TuCounts reduce_lanes(const TuCounts& l,
                                                 unsigned mask) {
  TuCounts c;
  c.n_cod = __reduce_add_sync(mask, l.n_cod);
  c.n1 = __reduce_add_sync(mask, l.n1);
  c.n0 = __reduce_add_sync(mask, l.n0);
  c.g1_1 = __reduce_add_sync(mask, l.g1_1);
  c.g1_0 = __reduce_add_sync(mask, l.g1_0);
  c.g2 = __reduce_add_sync(mask, l.g2);
  c.rem_i = __reduce_add_sync(mask, l.rem_i);
  c.over8 = __reduce_add_sync(mask, l.over8);
  c.nnz = __reduce_add_sync(mask, l.nnz);
  c.lx = __reduce_max_sync(mask, l.lx);
  c.ly = __reduce_max_sync(mask, l.ly);
  c.cg0_cod = __reduce_max_sync(mask, l.cg0_cod);
  c.dc_nz = __reduce_max_sync(mask, l.dc_nz);
  return c;
}

// The counts of a TU whose groups the lanes of `mask` hold, group g each.
template <class T>
__device__ __forceinline__ TuCounts group_counts_lanes(const T* lv, int n,
                                                       int g, unsigned mask) {
  return reduce_lanes(group_local(lv, n, g), mask);
}

// The bits of a TU of size n from its counts and its table row.
__device__ inline float total_bits(const TuCounts& c, int n,
                                  const float* row) {
  if (c.nnz == 0) return row[0];
  const int g4 = n / 4;
  const int ncg = g4 * g4;
  const float sc = 1.0f / 32768.0f;
  const long long csb_u = units(row[3]) * c.n_cod +
                          units(row[2]) * (ncg - c.n_cod) - units(row[3]);
  const long long sig_u =
      c.n1 * units(row[7]) + c.n0 * units(row[6]) +
      (c.cg0_cod ? (c.dc_nz ? units(row[5]) : units(row[4])) : 0);
  const long long g1_u = c.g1_1 * units(row[9]) + c.g1_0 * units(row[8]);
  const long long g2_u = c.g2 * units(row[10]);
  float csb = __fadd_rn(__fmul_rn(__ll2float_rn(csb_u), sc), 0.0f);
  csb = csb > 0.0f ? csb : 0.0f;
  const float lp = __fadd_rn(last_pos_bins(c.lx), last_pos_bins(c.ly));
  float total = __fadd_rn(row[1], __fmul_rn(lp, row[11]));
  total = __fadd_rn(total, csb);
  total = __fadd_rn(total, __fmul_rn(__ll2float_rn(sig_u), sc));
  total = __fadd_rn(total, __fmul_rn(__ll2float_rn(g1_u), sc));
  total = __fadd_rn(total, __fmul_rn(__ll2float_rn(g2_u), sc));
  total = __fadd_rn(total, (float)c.rem_i);
  total = __fadd_rn(total, (float)c.over8);
  total = __fadd_rn(total, (float)c.nnz);
  return total;
}

}  // namespace tu_bits_dev
