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
// and does a few integer operations per coefficient; the flat P frame's
// intra trial prices 285,600 TUs of 16x16, 146 MB.
//
// Design: lane groups.  A TU of n = 8 takes 4 lanes, a 4x4 coefficient
// group each (8 TUs a warp); n = 16 takes 8 lanes (4 TUs a warp) and n =
// 32 takes 32, two groups a lane (group rows gy and gy + 2, or gy + 4).
// At n = 16 two groups a lane beat one (16 lanes a TU): the TU's
// reductions and its pricing are shared by four TUs a warp instead of two
// (PERF.md, PR 13).  A lane reads each group as four 8-byte row pieces:
// the lanes of one group row read one contiguous run (32 bytes at n = 16,
// 64 at n = 32, one 16-byte TU row at n = 8), so every sector fetched is
// used whole, and no lane needs another's data.  Its counts (tu_bits.cuh `group_count`, `combine`)
// meet in warp reductions over the TU's lanes (`reduce_lanes`), and the
// TU's first lane prices them with the table row of its QP (`total_bits`;
// the table staged in shared memory).  Persistent blocks walk the TUs in a
// grid-stride loop, as many as the occupancy lets run at once, each warp
// loading its next TUs' pieces before it counts the current ones.
//
// The f32 result must equal the plain PyTorch version bit for bit, because
// these costs decide argmins: every fractional family is summed in integer
// units of 2^-15 bit, converted once (round to nearest), and the nine
// families are added in the JAX expression's order with __fadd_rn /
// __fmul_rn.  The file is also built with --fmad=false, so no multiply-add
// is ever contracted.

#include <cstdint>
#include <cuda_runtime.h>

#include "tu_bits.cuh"

namespace {

using namespace tu_bits_dev;

constexpr int kThreads = 256;

// lanes a TU of size N: n = 8 a lane a 4x4 group (4 lanes), n = 16 and
// 32 two groups a lane (8 and 32 lanes)
template <int N>
__host__ __device__ constexpr int lanes_per_tu() {
  return N == 8 ? 4 : (N / 4) * (N / 4) / 2;
}

// the 4 levels of an 8-byte row piece
__device__ __forceinline__ void unpack4(uint2 w, int* v) {
  v[0] = (int)(int16_t)(w.x & 0xffffu);
  v[1] = (int)w.x >> 16;
  v[2] = (int)(int16_t)(w.y & 0xffffu);
  v[3] = (int)w.y >> 16;
}

// A lane's 4x4 groups (GPL of them) of a TU as 8-byte row pieces, and
// (the TU's first lane) its QP.
template <int GPL>
struct Pieces {
  uint2 w[GPL][4];
  int qp;
};

template <int N>
__global__ void __launch_bounds__(kThreads)
    tu_bits_lanes(const int16_t* __restrict__ levels,
                  const int32_t* __restrict__ qp_arr,
                  const float* __restrict__ table, float* __restrict__ out,
                  long long T) {
  constexpr int G4 = N / 4, NG = G4 * G4;   // groups a TU
  constexpr int L = lanes_per_tu<N>();
  constexpr int GPL = NG / L;               // groups a lane
  constexpr int TPW = 32 / L;               // TUs a warp
  const int lane = threadIdx.x & 31;
  const int sub = lane / L, l = lane % L;
  const unsigned mask =
      L == 32 ? 0xffffffffu : (((1u << L) - 1u) << (sub * L));
  const long long stride = (long long)gridDim.x * (kThreads / 32) * TPW;
  __shared__ float tab[52 * 13];
  for (int i = threadIdx.x; i < 52 * 13; i += kThreads) tab[i] = table[i];
  __syncthreads();
  // the row pieces of this lane's groups of the TUs from `base` on (zeros
  // past the end)
  auto load = [&](long long base) {
    Pieces<GPL> p;
    const long long t = base + sub;
    const int16_t* tu = levels + (t < T ? t : 0) * (N * N);
    p.qp = l == 0 && t < T ? qp_arr[t] : 0;
#pragma unroll
    for (int j = 0; j < GPL; ++j) {
      const int g = l + j * L;
      const int gy = g / G4, gx = g % G4;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p.w[j][i] = t < T ? __ldcs(reinterpret_cast<const uint2*>(
                               tu + (4 * gy + i) * N + 4 * gx))
                          : make_uint2(0u, 0u);
    }
    return p;
  };
  // the loop bound is the same for every lane of a warp, so the reductions
  // see all of them; the next TUs' pieces are loaded before this one is
  // counted
  long long base =
      ((long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32) * TPW;
  Pieces<GPL> cur = load(base);
  for (; base < T; base += stride) {
    const Pieces<GPL> nxt = load(base + stride);
    auto count = [&](int j) {
      int v[16];
#pragma unroll
      for (int i = 0; i < 4; ++i) unpack4(cur.w[j][i], v + 4 * i);
      return group_count(v, N, l + j * L);
    };
    TuCounts c = count(0);
#pragma unroll
    for (int j = 1; j < GPL; ++j) c = combine(c, count(j));
    c = reduce_lanes(c, mask);
    const long long t = base + sub;
    if (l == 0 && t < T) {
      const int q = cur.qp < 0 ? 0 : (cur.qp > 51 ? 51 : cur.qp);
      out[t] = total_bits(c, N, tab + q * 13);
    }
    cur = nxt;
  }
}

// blocks of tu_bits_lanes<N> that fit on the card at once (asked once per
// device and size)
template <int N>
int resident_blocks() {
  static int cached[16] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 16) dev = 0;
  if (!cached[dev]) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tu_bits_lanes<N>,
                                                  kThreads, 0);
    cached[dev] = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  }
  return cached[dev];
}

template <int N>
void launch(const int16_t* levels, const int32_t* qp, const float* table,
            float* out, long long T, cudaStream_t stream) {
  constexpr int TPB = (kThreads / 32) * (32 / lanes_per_tu<N>());
  long long blocks = (T + TPB - 1) / TPB;
  const long long most = resident_blocks<N>();
  if (blocks > most) blocks = most;
  tu_bits_lanes<N><<<(unsigned)blocks, kThreads, 0, stream>>>(levels, qp,
                                                              table, out, T);
}

}  // namespace

extern "C" int tu_bits(const int16_t* levels, const int32_t* qp,
                       const float* table, float* out, int T, int n,
                       cudaStream_t stream) {
  if (T < 1) return (int)cudaSuccess;
  if (n == 8)
    launch<8>(levels, qp, table, out, T, stream);
  else if (n == 16)
    launch<16>(levels, qp, table, out, T, stream);
  else if (n == 32)
    launch<32>(levels, qp, table, out, T, stream);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
