// Motion compensation device code shared by K7 (`csrc/mc_qpel.cu`: uni
// prediction, with a reference index, and a B frame's select entry) and
// K9 (`csrc/mc_bi.cu`: bi-prediction): one kernel template, a group of
// threads an n x n block, several blocks a CTA.
//
// A block is predicted from one source (a plane and an MV) or from two,
// list 0's and list 1's:
//   - the group copies each source's (n + T - 1)^2 reference window into
//     shared memory once, each row at its clamped row (edge padding, what
//     the JAX window fetch gives for every MV the encoder produces): 16
//     bytes a load where the window lies inside the plane's columns, the
//     rows 16-byte aligned and the window starting s = x0 & 3 samples in;
//     a sample a load, at clamped columns, where it does not; with two
//     sources both windows are in flight together;
//   - it filters each window's rows horizontally once, n columns each
//     (only the n rows the vertical pass reads when its phase is 0), a
//     thread adjacent columns from one run of shared loads; a phase of 0
//     is the sample times 64, no taps;
//   - each thread filters its P adjacent pixels vertically from those rows
//     (8- or 16-byte shared loads; phase 0: the row times 64) into 14-bit
//     values, >> 6; one source rounds (p + 32) >> 6, two combine in
//     registers as (p0 + p1 + 64) >> 7 (spec 8.5.3.3.4.3, 8-bit); the
//     pixels are clipped to 0..255 and stored as one 8- or 16-byte store.
// All shifts are on signed int32 (arithmetic, as in JAX): the 8-tap lobes
// make 14-bit values negative near dark edges.  Where the caller asks, the
// group's first thread measures how far the block's two MVs' integer parts
// lie beyond +-max_mv (the window contract) and keeps the largest excess
// with one atomicMax.
//
// Exact: int32 arithmetic on int32 samples.  A horizontal sum is at most
// 112 (the luma taps' absolute sum) times the largest sample and a
// vertical sum 112^2 times, so for samples within +-171,000 (any 8- or
// 10-bit plane) no sum leaves int32, and the sum of two 14-bit values
// (each at most 112^2 / 64 x 171,000) neither; every value equals the
// plain version's int64 sums; phase 0 (a single 64 tap) gives 64 x the
// sample in both.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMcThreads = 256;

__constant__ int kLuma[4][8] = {{0, 0, 0, 64, 0, 0, 0, 0},
                                {-1, 4, -10, 58, 17, -5, 1, 0},
                                {-1, 4, -11, 40, 40, -11, 4, -1},
                                {0, 1, -5, 17, 58, -10, 4, -1}};
__constant__ int kChroma[8][4] = {{0, 64, 0, 0},     {-2, 58, 10, -2},
                                  {-4, 54, 16, -2},  {-6, 46, 28, -4},
                                  {-4, 36, 36, -4},  {-4, 28, 46, -6},
                                  {-2, 16, 54, -4},  {-2, 10, 58, -2}};

struct McArgs {
  const int32_t* planes;  // [R, H, W] (the select entry and K9: list 0's)
  int R, H, W;
  const int32_t* mv;      // [K, 2] (list 0's)
  const int32_t* ref;     // [K] or null
  int K;
  // list 1's plane and MVs (the select entry and K9)
  const int32_t* plane1;
  const int32_t* mv1;
  // the select entry: the directions, and the rows copied where both
  // lists are used (null: those blocks are predicted from both lists)
  const int32_t* dir;
  const int32_t* bi;
  int32_t* out;           // [K, n, n]
  int32_t* excess;        // null, or where the window excess is kept
  int max_mv;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// tap t of the T-tap filter (8 luma, 4 chroma) of phase p
template <int T>
__device__ __forceinline__ int tap(int p, int t) {
  if constexpr (T == 8)
    return kLuma[p][t];
  else
    return kChroma[p][t];
}

// adjacent pixels a thread at n 8, 16 and 32 (more at n 16, or 4 at n 8,
// ran slower on the card), so threads a block and blocks a CTA
template <int N>
constexpr int kPix = N == 8 ? 2 : 4;
template <int N>
constexpr int kGroup = N * N / kPix<N>;
template <int N>
constexpr int kPerCta = kMcThreads / kGroup<N>;

// P ints (2 or 4) as one 8- or 16-byte access of aligned shared or global
// memory
template <int P>
__device__ __forceinline__ void ld(const int32_t* src, int* v) {
  if constexpr (P == 2) {
    const int2 x = *reinterpret_cast<const int2*>(src);
    v[0] = x.x, v[1] = x.y;
  } else {
    const int4 x = *reinterpret_cast<const int4*>(src);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  }
}
template <int P>
__device__ __forceinline__ void st(int32_t* dst, const int* v) {
  if constexpr (P == 2)
    *reinterpret_cast<int2*>(dst) = make_int2(v[0], v[1]);
  else
    *reinterpret_cast<int4*>(dst) = make_int4(v[0], v[1], v[2], v[3]);
}

// ID the kernel's number (7 or 9: it only names the instantiation in a
// profile), T taps (8 luma, 4 chroma), N x N blocks, NS window slots a
// block (1: one source; 2: K9 without directions, every block from both
// lists, or the select entry without bi rows, its both-list blocks from
// both)
template <int ID, int T, int N, int NS>
__global__ void __launch_bounds__(kMcThreads) mc_kernel(const McArgs a) {
  constexpr int WW = N + T - 1;           // window side
  constexpr int M = T / 2 - 1;            // window margin (3 luma, 1 chroma)
  constexpr int SH = T == 8 ? 2 : 3;      // fraction bits of the MV
  constexpr int G = kGroup<N>;
  constexpr int BPC = kPerCta<N>;
  constexpr int P = kPix<N>;              // adjacent pixels a thread
  constexpr int CH = (WW + 6) / 4;        // 16-byte pieces a window row spans
  // window rows 16-byte aligned, starting s = x0 & 3 samples in
  __shared__ __align__(16) int32_t win[NS][BPC][WW][4 * CH];
  __shared__ __align__(16) int32_t hor[NS][BPC][WW][N];

  const int b = threadIdx.x / G, lt = threadIdx.x % G;
  const int k = blockIdx.x * BPC + b;
  const bool valid = k < a.K;
  // the block's sources: ns of them (0 where it copies bi rows)
  const int32_t* plane[NS];
  const int32_t* mvp[NS];
  int ns = 0;
  bool copy = false;
  plane[0] = a.planes;
  mvp[0] = a.mv;
  if constexpr (NS == 2) {
    plane[1] = a.plane1;
    mvp[1] = a.mv1;
  }
  if (valid && a.dir != nullptr) {
    const int d = a.dir[k];
    if ((d & 3) == 3) {
      copy = NS == 1 || a.bi != nullptr;
      ns = copy ? 0 : 2;
    } else {
      ns = 1;
      if ((d & 1) == 0) plane[0] = a.plane1, mvp[0] = a.mv1;
    }
  } else if (valid) {
    ns = NS;
    if (a.ref != nullptr)
      plane[0] += (size_t)clampi(a.ref[k], 0, a.R - 1) * a.H * a.W;
  }
  if (valid && a.excess != nullptr && lt == 0) {  // the contract, both MVs
    int e = 0;
#pragma unroll
    for (int c = 0; c < 2; ++c)
      e = max(e, max(abs(a.mv[2 * k + c] >> SH),
                     abs(a.mv1[2 * k + c] >> SH)));
    if (e > a.max_mv) atomicMax(a.excess, e - a.max_mv);
  }
  const int wb = a.W / N;
  const int blk = k % (wb * (a.H / N));
  int fx[NS], fy[NS], so[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    fx[s] = fy[s] = so[s] = 0;
    if (s >= ns) continue;
    const int vx = mvp[s][2 * k], vy = mvp[s][2 * k + 1];
    fx[s] = vx & ((1 << SH) - 1);
    fy[s] = vy & ((1 << SH) - 1);
    const int x0 = (blk % wb) * N + (vx >> SH) - M;
    const int y0 = (blk / wb) * N + (vy >> SH) - M;
    // the window, rows at clamped coordinates; a window inside the plane's
    // columns is read 16 bytes a load
    int32_t(*w)[4 * CH] = win[s][b];
    if ((a.W & 3) == 0 && x0 >= 0 && x0 + WW <= a.W &&
        (reinterpret_cast<uintptr_t>(plane[s]) & 15) == 0) {
      so[s] = x0 & 3;
      const int last = (so[s] + WW - 1) >> 2;
      const int4* src = reinterpret_cast<const int4*>(plane[s]) + (x0 >> 2);
      for (int i = lt; i < WW * CH; i += G) {
        const int r = i / CH, c = i % CH;
        if (c > last) continue;
        const int y = clampi(y0 + r, 0, a.H - 1);
        *reinterpret_cast<int4*>(&w[r][4 * c]) =
            __ldg(src + (size_t)y * (a.W >> 2) + c);
      }
    } else {
      for (int i = lt; i < WW * WW; i += G) {
        const int r = i / WW, c = i % WW;
        const int y = clampi(y0 + r, 0, a.H - 1);
        const int x = clampi(x0 + c, 0, a.W - 1);
        w[r][c] = __ldg(plane[s] + (size_t)y * a.W + x);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    if (s >= ns) continue;
    // horizontal pass over the rows the vertical one reads, P adjacent
    // columns a thread
    const int r0 = fy[s] ? 0 : M, nr = fy[s] ? WW : N;
    int tx[T];
#pragma unroll
    for (int t = 0; t < T; ++t) tx[t] = tap<T>(fx[s], t);
    for (int i = lt; i < nr * (N / P); i += G) {
      const int r = r0 + i / (N / P), j = (i % (N / P)) * P;
      const int32_t* x = &win[s][b][r][so[s] + j];
      int h[P];
      if (fx[s]) {
        int w[T + P - 1];
#pragma unroll
        for (int q = 0; q < T + P - 1; ++q) w[q] = x[q];
#pragma unroll
        for (int p = 0; p < P; ++p) {
          h[p] = 0;
#pragma unroll
          for (int t = 0; t < T; ++t) h[p] += tx[t] * w[p + t];
        }
      } else {
#pragma unroll
        for (int p = 0; p < P; ++p) h[p] = 64 * x[M + p];
      }
      st<P>(&hor[s][b][r][j], h);
    }
  }
  __syncthreads();
  if (!valid) return;
  // P adjacent pixels a thread: G P = N^2, one item each
  const int p0 = lt * P, i = p0 / N, j = p0 % N;
  int32_t* out = a.out + (size_t)k * N * N + p0;
  int v[NS][P];
  if (copy) {
    ld<P>(a.bi + (size_t)k * N * N + p0, v[0]);
    st<P>(out, v[0]);
    return;
  }
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    if (s >= ns) continue;
    if (fy[s]) {
      int ty[T];
#pragma unroll
      for (int t = 0; t < T; ++t) ty[t] = tap<T>(fy[s], t);
#pragma unroll
      for (int p = 0; p < P; ++p) v[s][p] = 0;
#pragma unroll
      for (int t = 0; t < T; ++t) {
        int e[P];
        ld<P>(&hor[s][b][i + t][j], e);
#pragma unroll
        for (int p = 0; p < P; ++p) v[s][p] += ty[t] * e[p];
      }
    } else {
      int e[P];
      ld<P>(&hor[s][b][i + M][j], e);
#pragma unroll
      for (int p = 0; p < P; ++p) v[s][p] = 64 * e[p];
    }
  }
  int o[P];
  if (NS == 2 && ns == 2) {
#pragma unroll
    for (int p = 0; p < P; ++p)
      o[p] = clampi(((v[0][p] >> 6) + (v[NS - 1][p] >> 6) + 64) >> 7, 0,
                    255);
  } else {
#pragma unroll
    for (int p = 0; p < P; ++p)
      o[p] = clampi(((v[0][p] >> 6) + 32) >> 6, 0, 255);
  }
  st<P>(out, o);
}

template <int ID, int T, int N, int NS>
int mc_launch_n(const McArgs& a, cudaStream_t stream) {
  const unsigned ctas = (unsigned)((a.K + kPerCta<N> - 1) / kPerCta<N>);
  mc_kernel<ID, T, N, NS><<<ctas, kMcThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int ID, int NS>
int mc_launch(const McArgs& a, int n, int chroma, cudaStream_t stream) {
  if (n != 8 && n != 16 && n != 32) return (int)cudaErrorInvalidValue;
  if (a.K <= 0) return (int)cudaSuccess;
  if (chroma)
    return n == 8 ? mc_launch_n<ID, 4, 8, NS>(a, stream)
                  : (n == 16 ? mc_launch_n<ID, 4, 16, NS>(a, stream)
                             : mc_launch_n<ID, 4, 32, NS>(a, stream));
  return n == 8 ? mc_launch_n<ID, 8, 8, NS>(a, stream)
                : (n == 16 ? mc_launch_n<ID, 8, 16, NS>(a, stream)
                           : mc_launch_n<ID, 8, 32, NS>(a, stream));
}

}  // namespace
