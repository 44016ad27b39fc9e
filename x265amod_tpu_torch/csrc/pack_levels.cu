// Kernel K15 `pack_levels`: the sparse pack of B frames' quantized levels
// for the device-to-host copy.  Each frame's levels are three int16 segments
// (luma, cb, cr; [B, n_k] each) read in order as one flat array of
// T = n0 + n1 + n2 levels, zero-padded to T8, a multiple of 8.  Per frame:
//   bitmap uint8 [T8/8]  bit j of byte i is (level 8i + j != 0);
//   vals   int16 [cap]   the nonzero levels in flat order, those at a rank
//                        of cap or more dropped, entries nnz..cap-1 zero;
//   nnz    int32         the count of nonzero levels (past cap too);
//   fits   bool          nnz <= cap.
//
// Replaces, from the JAX package: ops/pack.py pack_levels (the jnp
// bitmap sum, cumsum and scatter with mode="drop").
//
// Entry point (plain C, caller's stream, returns cudaGetLastError()):
//   pack_levels(a0, n0, a1, n1, a2, n2, B, cap, bitmap, vals, nnz, fits,
//               tiles [B, ceil(T8/1024)] i32 scratch)
//
// What bounds it on an H100: bytes (2 T read, T/8 + 2 min(nnz, cap)
// written per frame).  Three passes, deterministic by construction:
//   1. one thread per level, 1024 levels per block: a warp ballot gives four
//      bitmap bytes and the warp's count, a shared sum the tile's count;
//   2. one block per frame scans its tile counts (exclusive), writes nnz and
//      fits, and zeroes vals[min(nnz, cap)..cap);
//   3. as pass 1, each nonzero level goes to its rank: the tile's offset,
//      the warps before it in the tile and __popc of the lanes before it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 1024;

struct Segs {
  const int16_t* a[3];
  int64_t n[3];
};

__device__ __forceinline__ int load_level(const Segs& s, int b, int64_t e) {
  if (e < s.n[0]) return s.a[0][(int64_t)b * s.n[0] + e];
  e -= s.n[0];
  if (e < s.n[1]) return s.a[1][(int64_t)b * s.n[1] + e];
  e -= s.n[1];
  if (e < s.n[2]) return s.a[2][(int64_t)b * s.n[2] + e];
  return 0;  // the zero padding to a multiple of 8
}

__global__ void count_kernel(Segs s, int64_t T8, uint8_t* __restrict__ bitmap,
                             int32_t* __restrict__ tiles, int ntiles) {
  __shared__ int warp_count[kTile / 32];
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t e = (int64_t)blockIdx.x * kTile + threadIdx.x;
  const int v = e < T8 ? load_level(s, b, e) : 0;
  const unsigned mask = __ballot_sync(0xffffffffu, v != 0);
  const int64_t byte0 = ((int64_t)blockIdx.x * kTile + warp * 32) >> 3;
  if (lane < 4 && (byte0 + lane) * 8 < T8)
    bitmap[(int64_t)b * (T8 >> 3) + byte0 + lane] =
        (uint8_t)((mask >> (8 * lane)) & 0xffu);
  if (lane == 0) warp_count[warp] = __popc(mask);
  __syncthreads();
  if (threadIdx.x < 32) {
    int c = warp_count[threadIdx.x];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) c += __shfl_down_sync(0xffffffffu, c, o);
    if (threadIdx.x == 0) tiles[(int64_t)b * ntiles + blockIdx.x] = c;
  }
}

__global__ void scan_kernel(int32_t* __restrict__ tiles, int ntiles, int cap,
                            int16_t* __restrict__ vals,
                            int32_t* __restrict__ nnz,
                            bool* __restrict__ fits) {
  __shared__ int warp_sum[32];
  __shared__ int carry;
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int32_t* t = tiles + (int64_t)b * ntiles;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < ntiles; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int c = i < ntiles ? t[i] : 0;
    int incl = c;  // inclusive scan within the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int ws = lane < nwarps ? warp_sum[lane] : 0;
      int wi = ws;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, wi, o);
        if (lane >= o) wi += y;
      }
      if (lane < nwarps) warp_sum[lane] = wi - ws;  // exclusive
    }
    __syncthreads();
    const int excl = carry + warp_sum[warp] + incl - c;
    if (i < ntiles) t[i] = excl;
    __syncthreads();
    if (threadIdx.x == blockDim.x - 1) carry = excl + c;
    __syncthreads();
  }
  const int total = carry;
  if (threadIdx.x == 0) {
    nnz[b] = total;
    fits[b] = total <= cap;
  }
  for (int i = (total < cap ? total : cap) + threadIdx.x; i < cap;
       i += blockDim.x)
    vals[(int64_t)b * cap + i] = 0;
}

__global__ void scatter_kernel(Segs s, int64_t T8,
                               const int32_t* __restrict__ tiles, int ntiles,
                               int cap, int16_t* __restrict__ vals) {
  __shared__ int warp_off[kTile / 32];
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t e = (int64_t)blockIdx.x * kTile + threadIdx.x;
  const int v = e < T8 ? load_level(s, b, e) : 0;
  const unsigned mask = __ballot_sync(0xffffffffu, v != 0);
  if (lane == 0) warp_off[warp] = __popc(mask);
  __syncthreads();
  if (threadIdx.x < 32) {  // exclusive scan of the 32 warp counts
    const int c = warp_off[threadIdx.x];
    int incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (threadIdx.x >= o) incl += y;
    }
    warp_off[threadIdx.x] = incl - c;
  }
  __syncthreads();
  if (v != 0) {
    const int rank = tiles[(int64_t)b * ntiles + blockIdx.x] + warp_off[warp] +
                     __popc(mask & ((1u << lane) - 1u));
    if (rank < cap) vals[(int64_t)b * cap + rank] = (int16_t)v;
  }
}

}  // namespace

extern "C" int pack_levels(const int16_t* a0, int64_t n0, const int16_t* a1,
                           int64_t n1, const int16_t* a2, int64_t n2, int B,
                           int cap, uint8_t* bitmap, int16_t* vals,
                           int32_t* nnz, bool* fits, int32_t* tiles,
                           cudaStream_t stream) {
  Segs s;
  s.a[0] = a0; s.a[1] = a1; s.a[2] = a2;
  s.n[0] = n0; s.n[1] = n1; s.n[2] = n2;
  const int64_t T8 = (n0 + n1 + n2 + 7) / 8 * 8;
  const int ntiles = (int)((T8 + kTile - 1) / kTile);
  const dim3 grid(ntiles, B);
  count_kernel<<<grid, kTile, 0, stream>>>(s, T8, bitmap, tiles, ntiles);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  scan_kernel<<<B, 1024, 0, stream>>>(tiles, ntiles, cap, vals, nnz, fits);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  scatter_kernel<<<grid, kTile, 0, stream>>>(s, T8, tiles, ntiles, cap, vals);
  return (int)cudaGetLastError();
}
