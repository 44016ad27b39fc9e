// Device functions of K3 `tu_bits`, shared by K3 (`tu_bits.cu`) and K23
// (`intra16_scan.cu`): the context-anchored fractional CABAC bits of a TU
// (cbf, last position, coded-sub-block flags, significance map,
// greater1/greater2 flags, Golomb-Rice remainders, signs), priced from one
// row of the [52, 13] QP-indexed table of the slice type (JAX
// ops/estbits.py tu_bits).
//
// A TU's 4x4 coefficient groups are counted one per call of `group_counts`
// (any thread), the counts meeting in a `TuCounts` through integer atomics,
// which is exact and order-independent; `total_bits` then prices them.
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

// Counts of coefficient group g of the n x n levels lv (row stride n) into
// c (shared; integer atomics).
template <class T>
__device__ void group_counts(const T* lv, int n, int g, TuCounts* c) {
  const int g4 = n / 4;
  const int gy = g / g4, gx = g % g4;
  int a[16];
  int cg_sum = 0, cnt = 0, mx = 0, my = 0;
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    const int y = gy * 4 + q / 4, x = gx * 4 + q % 4;
    const int v = lv[y * n + x];
    a[q] = v < 0 ? -v : v;
    cg_sum += a[q];
    if (a[q]) {
      ++cnt;
      mx = x > mx ? x : mx;
      my = y > my ? y : my;
    }
  }
  if (!cnt) return;
  int k = bitlen(cg_sum) - 5;
  k = k < 0 ? 0 : (k > 4 ? 4 : k);
  int l_n1 = 0, l_n0 = 0, l_g11 = 0, l_g10 = 0, l_g2 = 0, l_rem = 0,
      l_over = 0, rank = 0;
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    const bool dc = g == 0 && q == 0;
    if (!dc) {
      if (a[q]) ++l_n1; else ++l_n0;
    }
    if (!a[q]) continue;
    ++rank;
    const bool take = rank <= 8;
    if (take) {
      if (a[q] > 1) { ++l_g11; l_g2 = 1; } else { ++l_g10; }
    } else {
      l_over += 1 + k;
    }
    const int base = take ? (a[q] < 3 ? a[q] : 3) : 1;
    const int rem = a[q] - base;
    if (rem > 0) {
      const int pref = rem >> k;
      int m = rem - (2 << k);
      m = m < 1 ? 1 : m;
      const int esc = bitlen(m) - k;
      l_rem += pref < 3 ? pref + 1 + k : 3 + 2 * esc + k;
    }
  }
  atomicAdd(&c->n_cod, 1);
  atomicAdd(&c->n1, l_n1);
  atomicAdd(&c->n0, l_n0);
  atomicAdd(&c->g1_1, l_g11);
  atomicAdd(&c->g1_0, l_g10);
  atomicAdd(&c->g2, l_g2);
  atomicAdd(&c->rem_i, l_rem);
  atomicAdd(&c->over8, l_over);
  atomicAdd(&c->nnz, cnt);
  atomicMax(&c->lx, mx);
  atomicMax(&c->ly, my);
  if (g == 0) {
    c->cg0_cod = 1;
    c->dc_nz = a[0] > 0;
  }
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
