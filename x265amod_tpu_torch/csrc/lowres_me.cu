// Kernel K13 `lowres_me`: the lookahead's lowres motion search, a full
// search of every 8x8 block of the lowres plane over [-rng, rng]^2 of the
// previous lowres plane read at clamped coordinates (the JAX edge padding).
//
// Replaces, from the JAX package: models/lookahead.py lowres_inter_cost (an
// im2col of the padded reference, two grouped f32 convolutions and
// w2 - 2 corr + c2, then the first argmin and sqrt(max(c, 0) * 64)).
//
// Entry point (plain C, caller's stream, returns cudaGetLastError()):
//   lowres_me(cur [h,w] u8, ref [h,w] u8, cost [h/8,w/8] f32 out,
//             mv [h/8,w/8,2] i32 out (x, y), h, w, rng, stream)
//
// What bounds it on an H100: integer operations (S^2 = 289 candidates of 64
// differences, squares and adds per block at rng 8, against 64 bytes of
// the block and its window).  The design:
//   - a CTA holds NB = 256 / S neighbouring blocks of one block row (15 at
//     rng 8) and stages their common window, (8 + 2 rng) rows of
//     8 NB + 2 rng bytes, in shared memory once, as bytes: 16 bytes a load
//     from the 16-byte aligned column at or before the window's first
//     where the window lies inside the plane's columns (the window then
//     starts s = x0 & 15 bytes into each row), else a byte a load at
//     clamped columns; rows always at clamped rows;
//   - thread t is lane (block t / S, dx t % S): S lanes a block, NB S of
//     the CTA's 256 threads busy (255 at rng 8, at least 231 at any rng);
//   - a lane keeps its block's 8 rows in registers (16 words) and walks
//     the window's rows once: each row's 8 bytes at its dx come from three
//     aligned words through two funnel shifts, and the row adds into every
//     dy it reaches (dy = r - y for block rows y = 0..7): a ring of 8 SSD
//     accumulators, slot dy & 7, started by block row 0 and complete after
//     window row dy + 7, when it is compared with the lane's best (strict
//     less: the lowest dy of a tie stays);
//   - a word pair's SSD is __vabsdiffu4 then __dp4a(d, d, acc): four
//     squared differences a pair of instructions, exact (a block's SSD is
//     at most 64 255^2 < 2^31);
//   - the first minimum is the least 64-bit key (ssd << 16) | (dy S + dx)
//     (ties go to the lower flat index, jnp.argmin's order): a segmented
//     shuffle tree within each warp (a block's lanes lie in at most two
//     warps), each segment's head storing its warp's part of the block,
//     then a thread a block taking the least of the two parts.
// cost = sqrt(ssd * 64) is rounded to nearest (__fsqrt_rn), as XLA's sqrt
// is; ssd * 64 is exact in f32.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxRng = 16;
constexpr int kThreads = 256;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// acc + the sum of the squared differences of the four bytes of a and b
__device__ __forceinline__ unsigned ssd4(unsigned a, unsigned b,
                                         unsigned acc) {
  const unsigned d = __vabsdiffu4(a, b);
  return __dp4a(d, d, acc);
}

__host__ __device__ constexpr int blocks_per_cta(int S) {
  return kThreads / S;
}

// bytes of a staged window row: its 8 NB + 2 rng bytes, up to 15 bytes of
// alignment before them and the 12 bytes a lane's three words can reach
__host__ __device__ constexpr int window_pitch(int nbc, int rng) {
  return (8 * nbc + 2 * rng + 15 + 12 + 15) & ~15;
}

__global__ void __launch_bounds__(kThreads)
    lowres_me_kernel(const uint8_t* __restrict__ cur,
                     const uint8_t* __restrict__ ref, int h, int w, int rng,
                     float* __restrict__ cost, int32_t* __restrict__ mv) {
  extern __shared__ __align__(16) unsigned char sh[];
  const int S = 2 * rng + 1;
  const int ws = 8 + 2 * rng;
  const int nbc = blocks_per_cta(S);
  const int pitch = window_pitch(nbc, rng);
  unsigned char* win = sh;                                   // [ws][pitch]
  unsigned long long* part =
      reinterpret_cast<unsigned long long*>(sh + ws * pitch);  // [nbc][2]
  const int tid = threadIdx.x, lane = tid & 31;
  const int wb = w >> 3;
  const int per_row = (wb + nbc - 1) / nbc;
  const int brow = blockIdx.x / per_row;
  const int b0 = (blockIdx.x % per_row) * nbc;
  const int nbv = min(nbc, wb - b0);              // blocks of this CTA
  const int x0 = 8 * b0 - rng, y0 = 8 * brow - rng;
  const int wv = 8 * nbv + 2 * rng;               // window bytes a row

  // the window, rows at clamped coordinates
  int s = 0;
  if ((w & 15) == 0 && (reinterpret_cast<uintptr_t>(ref) & 15) == 0 &&
      x0 >= 0 && x0 + wv <= w) {
    s = x0 & 15;
    const int np = ((s + wv - 1) >> 4) + 1;
    const uint4* src = reinterpret_cast<const uint4*>(ref) + (x0 >> 4);
    for (int i = tid; i < ws * np; i += blockDim.x) {
      const int r = i / np, p = i % np;
      const int y = clampi(y0 + r, 0, h - 1);
      *reinterpret_cast<uint4*>(win + r * pitch + 16 * p) =
          __ldg(src + (size_t)y * (w >> 4) + p);
    }
  } else {
    const int nw = blockDim.x >> 5;
    for (int r = tid >> 5; r < ws; r += nw) {
      const uint8_t* row = ref + (size_t)clampi(y0 + r, 0, h - 1) * w;
      for (int c = lane; c < wv; c += 32)
        win[r * pitch + c] = row[clampi(x0 + c, 0, w - 1)];
    }
  }
  if (tid < nbc) part[2 * tid + 1] = ~0ULL;

  // this lane's block (clamped into the CTA: lanes beyond compute and are
  // discarded) and its 8 rows
  const bool valid = tid < nbv * S;
  const int b = min(tid / S, nbv - 1), dx = tid - (tid / S) * S;
  unsigned c[8][2];
  {
    const uint8_t* cb = cur + (size_t)(8 * brow) * w + 8 * (b0 + b);
#pragma unroll
    for (int y = 0; y < 8; ++y) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(cb + y * w));
      c[y][0] = v.x;
      c[y][1] = v.y;
    }
  }
  __syncthreads();

  const int o = s + 8 * b + dx;
  const unsigned char* wrow = win + (o & ~3);
  const int shift = 8 * (o & 3);
  unsigned acc[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) acc[k] = 0u;
  unsigned best = ~0u;
  int bdy = 0;
  for (int r0 = 0; r0 < ws; r0 += 8) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int r = r0 + k;
      if (r >= ws) break;
      const unsigned* wp =
          reinterpret_cast<const unsigned*>(wrow + r * pitch);
      const unsigned w0 = wp[0], w1 = wp[1], w2 = wp[2];
      const unsigned a0 = __funnelshift_r(w0, w1, shift);
      const unsigned a1 = __funnelshift_r(w1, w2, shift);
      // window row r against block row y adds into dy = r - y
#pragma unroll
      for (int y = 0; y < 8; ++y) {
        const int m = (k - y) & 7;
        acc[m] = ssd4(a1, c[y][1], ssd4(a0, c[y][0], y == 0 ? 0u : acc[m]));
      }
      // dy = r - 7 is complete
      const unsigned v = acc[(k + 1) & 7];
      if (r >= 7 && v < best) {
        best = v;
        bdy = r - 7;
      }
    }
  }

  // the first minimum of each block: a segmented shuffle tree on the key
  unsigned long long key =
      valid ? ((unsigned long long)best << 16) | (unsigned)(bdy * S + dx)
            : ~0ULL;
  const int seg = valid ? b : -1 - lane;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned long long k2 = __shfl_down_sync(0xffffffffu, key, off);
    const int s2 = __shfl_down_sync(0xffffffffu, seg, off);
    if (lane + off < 32 && s2 == seg && k2 < key) key = k2;
  }
  const int up = __shfl_up_sync(0xffffffffu, seg, 1);
  if (valid && (lane == 0 || up != seg)) part[2 * b + (dx ? 1 : 0)] = key;
  __syncthreads();
  if (tid < nbv) {
    const unsigned long long p0 = part[2 * tid], p1 = part[2 * tid + 1];
    const unsigned long long k = p1 < p0 ? p1 : p0;
    const int ssd = (int)(k >> 16), idx = (int)(k & 0xffff);
    const int i = brow * wb + b0 + tid;
    cost[i] = __fsqrt_rn(__int2float_rn(ssd) * 64.0f);
    mv[2 * i] = idx % S - rng;
    mv[2 * i + 1] = idx / S - rng;
  }
}

}  // namespace

extern "C" int lowres_me(const uint8_t* cur, const uint8_t* ref, float* cost,
                         int32_t* mv, int h, int w, int rng,
                         cudaStream_t stream) {
  if (h <= 0 || w <= 0 || h % 8 || w % 8 || rng < 1 || rng > kMaxRng ||
      (reinterpret_cast<uintptr_t>(cur) & 7))
    return (int)cudaErrorInvalidValue;
  const int S = 2 * rng + 1;
  const int nbc = blocks_per_cta(S);
  const int wb = w / 8;
  const int ctas = (h / 8) * ((wb + nbc - 1) / nbc);
  const int threads = (nbc * S + 31) & ~31;
  const size_t shmem =
      (size_t)(8 + 2 * rng) * window_pitch(nbc, rng) + 16 * nbc;
  lowres_me_kernel<<<ctas, threads, shmem, stream>>>(cur, ref, h, w, rng,
                                                      cost, mv);
  return (int)cudaGetLastError();
}
