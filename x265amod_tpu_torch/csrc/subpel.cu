// Kernel K6 `subpel_refine`: exhaustive +-2 quarter-pel refinement around
// each block's integer MV.  25 candidates (dy outer, dx inner, -2..2): 8-tap
// horizontal then vertical interpolation (spec 8.5.3.3.3, 8-bit), uni
// rounding, SSD against the block, cost ssd + lam * mvd_bits(mv), first
// minimum.
//
// Replaces, from the JAX package: ops/me.py subpel_refine (+ _mvd_bits_f,
// and the one-hot window fetch _block_windows it uses).
//
// Entry point (plain C, caller's stream, returns cudaGetLastError()):
//   subpel_refine(ref [H,W] i32, H, W, cur [nb,n,n] i32, mv_int [nb,2] i32,
//                 lam [nb] f32, n, mv_out [nb,2] i32, ssd_out [nb] f32)
//
// What bounds it on an H100: operations (the two filter passes and 25 SSDs
// per pixel; a few bytes a pixel read).  Design: a warp a block, four
// blocks a CTA, nothing shared between warps, so no CTA barrier.
//   - The warp copies the block's (n+8)^2 reference window, read at
//     clamped coordinates (edge padding), into its own shared memory as
//     f32 (a lane a window column), and syncs itself.
//   - A delta d in -2..2 is (integer offset, phase) (-1, 2), (-1, 3), (0,
//     0), (0, 1), (0, 2).  So each lane filters its column horizontally
//     into five columns of a window row: phase 0 (a copy), 1, 2 and 3, and
//     phase 2 at offset -1; the taps are compile-time constants (an FFMA
//     with an immediate, an FADD for a tap of +-1, nothing for a 0).
//     Phase 2 at offset -1 in column j is phase 2 in column j - 1, but a
//     shuffle would leave the first lane of each row segment to filter its
//     own, alone, while the warp waits: as long as every lane filtering.
//   - A lane takes one column (n 16: lanes 0-15 the top eight rows, 16-31
//     the bottom eight; n 32: one column over all 32 rows in chunks of
//     eight) and slides a window of nine filtered rows down it in
//     registers (the loops unrolled so that the ring is named registers).
//     At each output row it filters the five columns vertically at phases
//     1, 2 (offset 0) and 3 (offset -1); phase 2 at offset -1 is the row
//     above's phase 2, kept; phase 0 is the filtered row itself.  That
//     makes the 25 predictions, each subtracted from the block's pixel and
//     squared into one of 25 partial sums.
//   - The arithmetic is f32 on exact integers, at the FMA rate (twice the
//     int32 rate): every value stays below 2^24 for samples within
//     +-1337, and the 8-bit planes the encoder passes lie in 0..255.  The
//     +32 of the first rounding is the horizontal sums' start value; as the
//     taps sum to 64 it becomes the +2048 of the vertical sums, so a
//     prediction is ((v >> 6) + 32) >> 6 = floor((v + 2048) / 4096), one
//     FMA rounded down onto 1.5 2^23 (whose ulp is 1), clamped there, then
//     subtracted from the pixel plus the same offset.  A lane's partial SSD
//     stays below 32 * 255^2.
//   - The 25 partials, turned into int32, are summed over the warp by a
//     transposing butterfly (each step halves the values a lane holds and
//     swaps the other half with its partner), so lane k ends with
//     candidate k's exact SSD.  Lane k < 25 forms its cost as XLA's CPU
//     code forms JAX's `cost + lam * rate`, one FMA (__fmaf_rn; built with
//     --fmad=false so that nothing else contracts), and a shuffle minimum
//     on (cost, k) keeps the first minimum of the JAX candidate order.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // blocks (warps) a CTA

// the luma 8-tap filter of phase p (spec Table 8-11)
__host__ __device__ constexpr int tap(int p, int k) {
  return p == 1   ? (k == 0   ? -1
                     : k == 1 ? 4
                     : k == 2 ? -10
                     : k == 3 ? 58
                     : k == 4 ? 17
                     : k == 5 ? -5
                     : k == 6 ? 1
                              : 0)
         : p == 2 ? (k == 0 || k == 7   ? -1
                     : k == 1 || k == 6 ? 4
                     : k == 2 || k == 5 ? -11
                                        : 40)
         : p == 3 ? (k == 0   ? 0
                     : k == 1 ? 1
                     : k == 2 ? -5
                     : k == 3 ? 17
                     : k == 4 ? 58
                     : k == 5 ? -10
                     : k == 6 ? 4
                              : -1)
                  : (k == 3 ? 64 : 0);
}

// acc + sum_k tap(P, k) x[k * S] with the taps as immediates
template <int P, int S = 1>
__device__ __forceinline__ float filt(const float* x, float acc) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int t = tap(P, k);
    if (t == 1)
      acc = __fadd_rn(acc, x[k * S]);
    else if (t == -1)
      acc = __fsub_rn(acc, x[k * S]);
    else if (t != 0)
      acc = __fmaf_rn((float)t, x[k * S], acc);
  }
  return acc;
}

// 1.5 2^23: the floor of x in [-2^22, 2^22) is fma_rd(x, 1, kOff) - kOff
constexpr float kOff = 12582912.0f;

// the prediction of a vertical sum v + 2048, plus kOff, clamped to 0..255
__device__ __forceinline__ float pred12(float v) {
  const float p = __fmaf_rd(v, 1.0f / 4096.0f, kOff);
  return fminf(fmaxf(p, kOff), kOff + 255.0f);
}

// the prediction of an unfiltered row of a horizontal sum h + 32 (its
// vertical sum is 64 h + 2048), plus kOff, clamped
__device__ __forceinline__ float pred6(float h) {
  const float p = __fmaf_rd(h, 1.0f / 64.0f, kOff);
  return fminf(fmaxf(p, kOff), kOff + 255.0f);
}

__device__ __forceinline__ int bitlen(int x) {
  return x > 0 ? 32 - __clz(x) : 0;
}

__device__ __forceinline__ float mv_bins(int v) {
  return (float)(1 + 2 * bitlen(v < 0 ? -v : v));
}

// the five horizontal columns of one window row at the lane's column j
// (x: window columns j..j+8): dx = 0 (a copy, 64 w), 1, 2, -1, -2
constexpr int kCols = 5;
__device__ __forceinline__ void hrow(const float* x, float h[kCols]) {
  h[0] = __fmaf_rn(64.0f, x[4], 32.0f);
  h[1] = filt<1>(x + 1, 32.0f);
  h[2] = filt<2>(x + 1, 32.0f);
  h[3] = filt<3>(x, 32.0f);
  h[4] = filt<2>(x, 32.0f);
}
// dx + 2 of column c
__host__ __device__ constexpr int dx_of(int c) {
  return c == 0 ? 2 : (c == 1 ? 3 : (c == 2 ? 4 : (c == 3 ? 1 : 0)));
}

// One step of the transposing butterfly: a lane keeps the half of its M
// pairs (v[k], v[k + M]) that its bit M selects and adds its partner's
// copy of that half, sent in exchange for the other.
template <int M>
__device__ __forceinline__ void halve(int (&v)[32], int lane) {
  const bool hi = (lane & M) != 0;
#pragma unroll
  for (int k = 0; k < M; ++k) {
    const int keep = hi ? v[k + M] : v[k];
    const int send = hi ? v[k] : v[k + M];
    v[k] = keep + __shfl_xor_sync(0xffffffffu, send, M);
  }
}

template <int N>
__global__ void __launch_bounds__(kWarps * 32)
    subpel_warp(const int32_t* __restrict__ ref, int H, int W,
                const int32_t* __restrict__ cur,
                const int32_t* __restrict__ mv_int,
                const float* __restrict__ lam, int nb,
                int32_t* __restrict__ mv_out, float* __restrict__ ssd_out) {
  constexpr int WN = N + 8;
  constexpr int SEGS = 32 / N;      // row segments a warp
  constexpr int ROWS = N / SEGS;    // output rows a lane
  constexpr int CHUNKS = ROWS / 8;
  __shared__ float win_all[kWarps][WN * WN];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= nb) return;
  float* win = win_all[warp];
  const int wb = W / N;
  const int bx = (b % wb) * N, by = (b / wb) * N;
  const int mx = mv_int[2 * b], my = mv_int[2 * b + 1];
  // a lane a window column (its x clamped once), down the rows
  for (int c = lane; c < WN; c += 32) {
    int x = bx + mx - 4 + c;
    x = x < 0 ? 0 : (x > W - 1 ? W - 1 : x);
    const int32_t* rc = ref + x;
#pragma unroll 8
    for (int r = 0; r < WN; ++r) {
      int y = by + my - 4 + r;
      y = y < 0 ? 0 : (y > H - 1 ? H - 1 : y);
      win[r * WN + c] = (float)rc[(size_t)y * W];
    }
  }
  __syncwarp();
  const int j = lane % N, r0 = (lane / N) * ROWS;
  const float* wcol = win + r0 * WN + j;
  const int32_t* ccol = cur + (size_t)b * N * N + r0 * N + j;
  // the ring: window rows (relative to r0) 8 c .. 8 c + 15 of a chunk
  float h[16][kCols];
  float acc[25];
#pragma unroll
  for (int k = 0; k < 25; ++k) acc[k] = 0.0f;
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    float x[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) x[k] = wcol[s * WN + k];
    hrow(x, h[s]);
  }
  // dy = -2 (phase 2 at offset -1) of an output row: the row above's
  // phase 2 at offset 0, kept as its clamped prediction
  float up2[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c)
    up2[c] = pred12(filt<2, kCols>(&h[0][c], 0.0f));
#pragma unroll 1
  for (int ch = 0; ch < CHUNKS; ++ch) {
    float curo[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      curo[i] = (float)ccol[(8 * ch + i) * N] + kOff;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      {
        float x[9];
        const float* p = wcol + (8 * ch + 8 + i) * WN;
#pragma unroll
        for (int k = 0; k < 9; ++k) x[k] = p[k];
        hrow(x, h[8 + i]);
      }
      // output row 8 ch + i: window rows 8 ch + i .. + 8 (slots i .. i+8)
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float* col = &h[i][c];
        float p[5];
        p[0] = up2[c];                                         // dy -2
        p[1] = pred12(filt<3, kCols>(col, 0.0f));              // dy -1
        p[2] = pred6(h[i + 4][c]);                             // dy 0
        p[3] = pred12(filt<1, kCols>(col + kCols, 0.0f));      // dy 1
        p[4] = pred12(filt<2, kCols>(col + kCols, 0.0f));      // dy 2
        up2[c] = p[4];
#pragma unroll
        for (int dy = 0; dy < 5; ++dy) {
          const float d = __fsub_rn(p[dy], curo[i]);
          float& a = acc[dy * 5 + dx_of(c)];
          a = __fmaf_rn(d, d, a);
        }
      }
    }
#pragma unroll
    for (int s = 0; s < 8; ++s)
#pragma unroll
      for (int c = 0; c < kCols; ++c) h[s][c] = h[8 + s][c];
  }
  // transposing butterfly: 32 values (25 SSDs, 7 zeros) -> lane k holds
  // candidate k's sum over the warp
  int v[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) v[k] = k < 25 ? __float2int_rn(acc[k]) : 0;
  halve<16>(v, lane);
  halve<8>(v, lane);
  halve<4>(v, lane);
  halve<2>(v, lane);
  halve<1>(v, lane);
  const int ssd = v[0];
  // lane k < 25: candidate k's cost; first minimum on (cost, k)
  float cost = __int_as_float(0x7f800000);
  if (lane < 25) {
    const int vx = 4 * mx + lane % 5 - 2, vy = 4 * my + lane / 5 - 2;
    const float rate = __fadd_rn(mv_bins(vx), mv_bins(vy));
    cost = __fmaf_rn(lam[b], rate, __int2float_rn(ssd));
  }
  int best = lane;
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) {
    const float oc = __shfl_xor_sync(0xffffffffu, cost, m);
    const int ok = __shfl_xor_sync(0xffffffffu, best, m);
    const bool take = oc < cost || (oc == cost && ok < best);
    cost = take ? oc : cost;
    best = take ? ok : best;
  }
  const int bssd = __shfl_sync(0xffffffffu, ssd, best);
  if (lane == 0) {
    mv_out[2 * b] = 4 * mx + best % 5 - 2;
    mv_out[2 * b + 1] = 4 * my + best / 5 - 2;
    ssd_out[b] = __int2float_rn(bssd);
  }
}

}  // namespace

extern "C" int subpel_refine(const int32_t* ref, int H, int W,
                             const int32_t* cur, const int32_t* mv_int,
                             const float* lam, int n, int32_t* mv_out,
                             float* ssd_out, cudaStream_t stream) {
  if (n != 16 && n != 32) return (int)cudaErrorInvalidValue;
  const int nb = (H / n) * (W / n);
  const int grid = (nb + kWarps - 1) / kWarps;
  if (n == 16)
    subpel_warp<16><<<grid, kWarps * 32, 0, stream>>>(
        ref, H, W, cur, mv_int, lam, nb, mv_out, ssd_out);
  else
    subpel_warp<32><<<grid, kWarps * 32, 0, stream>>>(
        ref, H, W, cur, mv_int, lam, nb, mv_out, ssd_out);
  return (int)cudaGetLastError();
}
