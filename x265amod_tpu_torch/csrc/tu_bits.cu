// Kernel K3 `tu_bits`: context-anchored fractional CABAC bits of a TU
// (cbf, last position, coded-sub-block flags, significance map,
// greater1/greater2 flags, Golomb-Rice remainders, signs), priced at the
// slice type's init states from a [52, 13] QP-indexed table.
//
// Replaces, from the JAX package: ops/estbits.py tu_bits (the per-block QP
// path used by models/intra_tree.py _rbits_proxy).
//
// Entry point (plain C, caller's stream, returns cudaGetLastError()):
//   tu_bits(levels [T,n,n] i16, qp [T] i32, table [52*13] f32,
//           out [T] f32, T, n)
//
// What bounds it on an H100: bytes.  It reads each level once (2 bytes)
// and does a few integer operations per coefficient.  One thread block
// prices one TU; each thread walks one 4x4 coefficient group, and the
// per-TU counts meet in shared memory through integer atomics, which is
// exact and order-independent.  The f32 result must equal the plain
// PyTorch version bit for bit, because these costs decide argmins: every
// fractional family is summed in integer units of 2^-15 bit, converted
// once (round to nearest), and the nine families are added in the JAX
// expression's order with __fadd_rn / __fmul_rn.  The file is also built
// with --fmad=false, so no multiply-add is ever contracted.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

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

__global__ void tu_bits_kernel(const int16_t* __restrict__ levels,
                               const int32_t* __restrict__ qp_arr,
                               const float* __restrict__ table,
                               float* __restrict__ out, int n) {
  // per-TU integer sums (shared, exact)
  __shared__ int n_cod, n1, n0, dc_nz, cg0_cod, g1_1, g1_0, g2, rem_i,
      over8, nnz, lx, ly;
  const int t = blockIdx.x;
  if (threadIdx.x == 0) {
    n_cod = n1 = n0 = dc_nz = cg0_cod = g1_1 = g1_0 = g2 = rem_i = over8 =
        nnz = lx = ly = 0;
  }
  __syncthreads();
  const int g4 = n / 4;
  const int ncg = g4 * g4;
  const int g = threadIdx.x;
  if (g < ncg) {
    const int gy = g / g4, gx = g % g4;
    const int16_t* lv = levels + (size_t)t * n * n;
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
    if (cnt) {
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
      atomicAdd(&n_cod, 1);
      atomicAdd(&n1, l_n1);
      atomicAdd(&n0, l_n0);
      atomicAdd(&g1_1, l_g11);
      atomicAdd(&g1_0, l_g10);
      atomicAdd(&g2, l_g2);
      atomicAdd(&rem_i, l_rem);
      atomicAdd(&over8, l_over);
      atomicAdd(&nnz, cnt);
      atomicMax(&lx, mx);
      atomicMax(&ly, my);
      if (g == 0) {
        cg0_cod = 1;
        dc_nz = a[0] > 0;
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int q = qp_arr[t];
    q = q < 0 ? 0 : (q > 51 ? 51 : q);
    const float* row = table + q * 13;
    if (nnz == 0) {
      out[t] = row[0];
      return;
    }
    const float sc = 1.0f / 32768.0f;
    const long long csb_u = units(row[3]) * n_cod +
                            units(row[2]) * (ncg - n_cod) - units(row[3]);
    const long long sig_u =
        n1 * units(row[7]) + n0 * units(row[6]) +
        (cg0_cod ? (dc_nz ? units(row[5]) : units(row[4])) : 0);
    const long long g1_u = g1_1 * units(row[9]) + g1_0 * units(row[8]);
    const long long g2_u = g2 * units(row[10]);
    float csb = __fadd_rn(__fmul_rn(__ll2float_rn(csb_u), sc), 0.0f);
    csb = csb > 0.0f ? csb : 0.0f;
    const float last_bits =
        __fmul_rn(__fadd_rn(last_pos_bins(lx), last_pos_bins(ly)), row[11]);
    float total = __fadd_rn(row[1], last_bits);
    total = __fadd_rn(total, csb);
    total = __fadd_rn(total, __fmul_rn(__ll2float_rn(sig_u), sc));
    total = __fadd_rn(total, __fmul_rn(__ll2float_rn(g1_u), sc));
    total = __fadd_rn(total, __fmul_rn(__ll2float_rn(g2_u), sc));
    total = __fadd_rn(total, (float)rem_i);
    total = __fadd_rn(total, (float)over8);
    total = __fadd_rn(total, (float)nnz);
    out[t] = total;
  }
}

}  // namespace

extern "C" int tu_bits(const int16_t* levels, const int32_t* qp,
                       const float* table, float* out, int T, int n,
                       cudaStream_t stream) {
  if (n != 8 && n != 16 && n != 32) return (int)cudaErrorInvalidValue;
  tu_bits_kernel<<<T, 64, 0, stream>>>(levels, qp, table, out, n);
  return (int)cudaGetLastError();
}
