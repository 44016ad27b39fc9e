// Kernel K7 `mc_qpel`: uni-directional motion compensation of every n x n
// raster block of a plane at its own MV: quarter-pel luma (8-tap) or
// eighth-pel chroma (4-tap), 14-bit intermediate, (p + 32) >> 6, clip.
//
// Replaces, from the JAX package: ops/me.py mc_luma_qpel / mc_luma_qpel14
// and mc_chroma_qpel / mc_chroma_qpel14 (uni path), with the one-hot window
// fetch _block_windows they use.
//
// With a per-block reference index it also replaces the final MC of a
// multi-reference P frame (JAX models/inter_tree.py mc_sel :598-615, which
// runs the MC on every reference and sums them under a one-hot mask, a TPU
// stand-in for a gather): prediction k reads plane ref[k] of the stacked
// planes.  The same entry serves the multi-reference trials (K = R x nb
// predictions in one launch).  With per-block directions it replaces the
// uni half of a B frame's final MC (JAX mc_select, models/b_frame.py
// :407-415 and models/inter_tree.py:1610-1624, which runs the MC on both
// lists for every block and keeps one): each block is predicted once,
// from the list its direction names.
//
// Entry points (plain C, caller's stream, return cudaGetLastError()):
//   mc_qpel(plane [H,W] i32, H, W, mv [nb,2] i32, nb, n, chroma,
//           out [nb,n,n] i32)
//   mc_qpel_ref(planes [R,H,W] i32, R, H, W, mv [K,2] i32, ref [K] i32, K,
//               n, chroma, out [K,n,n] i32): prediction k is raster block
//               k mod (H/n)(W/n) of plane ref[k] (clamped to 0..R-1)
//   mc_qpel_sel(plane0, plane1 [H,W] i32, H, W, mv0, mv1 [nb,2] i32,
//               dir [nb] i32, bi [nb,n,n] i32, nb, n, chroma,
//               out [nb,n,n] i32): a block whose dir[k] & 3 is 3 (both
//               lists) copies bi's rows; another is predicted from plane0
//               at mv0 where dir[k] & 1, else from plane1 at mv1
// mv is in luma quarter-pel units; for chroma the same value is the
// eighth-pel chroma MV (4:2:0).
//
// What bounds it on an H100: bytes (the plane read once, one int32 written
// a pixel); at 1080p luma n 16 it runs at 2.6x that bound, and fewer
// instructions a pixel made it faster where more bytes in flight did not.
// Design: a CTA of 256 threads holds
// several blocks, a group of threads a block (n 8: a warp, two adjacent
// pixels a lane; n 16: two warps, four a thread; n 32: eight warps, four a
// thread), so a block's MV, and with it its phases, taps and copies, is
// uniform across its group:
//   - the group copies the block's (n + T - 1)^2 reference window into
//     shared memory once, each row at its clamped row (edge padding, what
//     the JAX window fetch gives for every MV the encoder produces): 16
//     bytes a load where the window lies inside the plane's columns, the
//     rows 16-byte aligned and the window starting s = x0 & 3 samples in;
//     a sample a load, at clamped columns, where it does not;
//   - it filters the window's rows horizontally once, n columns each (only
//     the n rows the vertical pass reads when its phase is 0), a thread
//     adjacent columns from one run of shared loads; a phase of 0 is the
//     sample times 64, no taps;
//   - each thread filters its adjacent pixels vertically from those rows
//     (8- or 16-byte shared loads; phase 0: the row times 64), rounds,
//     clips and stores them as one 8- or 16-byte store; a block of the
//     select entry that uses both lists copies its bi rows the same way.
// So a luma pixel costs about (n + 7) / n x 8 + 8 multiply-adds instead of
// 64 loads and 72 multiply-adds.  Copies by `cp.async`, a persistent CTA
// with the next windows in flight, and eight pixels a thread at n 16 ran
// slower on the card (PERF.md).  dp4a was not tried: it would cut
// only the horizontal multiply-adds, at the price of packing bytes, funnel
// shifts and a range guard for planes outside 0..255.
//
// Exact: int32 arithmetic on int32 samples.  A horizontal sum is at most
// 112 (the luma taps' absolute sum) times the largest sample and a
// vertical sum 112^2 times, so for samples within +-171,000 (any 8- or
// 10-bit plane) no sum leaves int32 and every value equals the plain
// version's int64 sums; phase 0 (a single 64 tap) gives 64 x the sample in
// both.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__constant__ int kLuma[4][8] = {{0, 0, 0, 64, 0, 0, 0, 0},
                                {-1, 4, -10, 58, 17, -5, 1, 0},
                                {-1, 4, -11, 40, 40, -11, 4, -1},
                                {0, 1, -5, 17, 58, -10, 4, -1}};
__constant__ int kChroma[8][4] = {{0, 64, 0, 0},     {-2, 58, 10, -2},
                                  {-4, 54, 16, -2},  {-6, 46, 28, -4},
                                  {-4, 36, 36, -4},  {-4, 28, 46, -6},
                                  {-2, 16, 54, -4},  {-2, 10, 58, -2}};

struct Args {
  const int32_t* planes;  // [R, H, W] (the select entry: list 0's plane)
  int R, H, W;
  const int32_t* mv;      // [K, 2] (list 0's)
  const int32_t* ref;     // [K] or null
  int K;
  // the select entry (dir non-null): list 1's plane and MVs, the
  // directions and the bi-predicted rows
  const int32_t* plane1;
  const int32_t* mv1;
  const int32_t* dir;
  const int32_t* bi;
  int32_t* out;           // [K, n, n]
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
constexpr int kPerCta = kThreads / kGroup<N>;

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

// T taps (8 luma, 4 chroma), N x N blocks
template <int T, int N>
__global__ void __launch_bounds__(kThreads) mc_kernel(const Args a) {
  constexpr int WW = N + T - 1;           // window side
  constexpr int M = T / 2 - 1;            // window margin (3 luma, 1 chroma)
  constexpr int SH = T == 8 ? 2 : 3;      // fraction bits of the MV
  constexpr int G = kGroup<N>;
  constexpr int BPC = kPerCta<N>;
  constexpr int P = kPix<N>;              // adjacent pixels a thread
  constexpr int CH = (WW + 6) / 4;        // 16-byte pieces a window row spans
  // window rows 16-byte aligned, starting s = x0 & 3 samples in
  __shared__ __align__(16) int32_t win[BPC][WW][4 * CH];
  __shared__ __align__(16) int32_t hor[BPC][WW][N];

  const int b = threadIdx.x / G, lt = threadIdx.x % G;
  const int k = blockIdx.x * BPC + b;
  const bool valid = k < a.K;
  const int32_t* plane = a.planes;
  const int32_t* mvp = a.mv;
  bool copy = false;
  if (valid && a.dir != nullptr) {
    const int d = a.dir[k];
    copy = (d & 3) == 3;
    if ((d & 1) == 0) plane = a.plane1, mvp = a.mv1;
  } else if (valid && a.ref != nullptr) {
    plane += (size_t)clampi(a.ref[k], 0, a.R - 1) * a.H * a.W;
  }
  const bool pred = valid && !copy;
  int fx = 0, fy = 0, s = 0;
  if (pred) {
    const int vx = mvp[2 * k], vy = mvp[2 * k + 1];
    const int wb = a.W / N;
    const int blk = k % (wb * (a.H / N));
    fx = vx & ((1 << SH) - 1);
    fy = vy & ((1 << SH) - 1);
    const int x0 = (blk % wb) * N + (vx >> SH) - M;
    const int y0 = (blk / wb) * N + (vy >> SH) - M;
    // the window, rows at clamped coordinates; a window inside the plane's
    // columns is read 16 bytes a load
    if ((a.W & 3) == 0 && x0 >= 0 && x0 + WW <= a.W &&
        (reinterpret_cast<uintptr_t>(plane) & 15) == 0) {
      s = x0 & 3;
      const int last = (s + WW - 1) >> 2;
      const int4* src = reinterpret_cast<const int4*>(plane) + (x0 >> 2);
      for (int i = lt; i < WW * CH; i += G) {
        const int r = i / CH, c = i % CH;
        if (c > last) continue;
        const int y = clampi(y0 + r, 0, a.H - 1);
        *reinterpret_cast<int4*>(&win[b][r][4 * c]) =
            __ldg(src + (size_t)y * (a.W >> 2) + c);
      }
    } else {
      for (int i = lt; i < WW * WW; i += G) {
        const int r = i / WW, c = i % WW;
        const int y = clampi(y0 + r, 0, a.H - 1);
        const int x = clampi(x0 + c, 0, a.W - 1);
        win[b][r][c] = __ldg(plane + (size_t)y * a.W + x);
      }
    }
  }
  __syncthreads();
  if (pred) {
    // horizontal pass over the rows the vertical one reads, P adjacent
    // columns a thread
    const int r0 = fy ? 0 : M, nr = fy ? WW : N;
    int tx[T];
#pragma unroll
    for (int t = 0; t < T; ++t) tx[t] = tap<T>(fx, t);
    for (int i = lt; i < nr * (N / P); i += G) {
      const int r = r0 + i / (N / P), j = (i % (N / P)) * P;
      const int32_t* x = &win[b][r][s + j];
      int h[P];
      if (fx) {
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
      st<P>(&hor[b][r][j], h);
    }
  }
  __syncthreads();
  if (!valid) return;
  // P adjacent pixels a thread: G P = N^2, one item each
  const int p0 = lt * P, i = p0 / N, j = p0 % N;
  int32_t* out = a.out + (size_t)k * N * N + p0;
  int v[P];
  if (copy) {
    ld<P>(a.bi + (size_t)k * N * N + p0, v);
    st<P>(out, v);
    return;
  }
  if (fy) {
    int ty[T];
#pragma unroll
    for (int t = 0; t < T; ++t) ty[t] = tap<T>(fy, t);
#pragma unroll
    for (int p = 0; p < P; ++p) v[p] = 0;
#pragma unroll
    for (int t = 0; t < T; ++t) {
      int e[P];
      ld<P>(&hor[b][i + t][j], e);
#pragma unroll
      for (int p = 0; p < P; ++p) v[p] += ty[t] * e[p];
    }
  } else {
    int e[P];
    ld<P>(&hor[b][i + M][j], e);
#pragma unroll
    for (int p = 0; p < P; ++p) v[p] = 64 * e[p];
  }
#pragma unroll
  for (int p = 0; p < P; ++p) v[p] = clampi(((v[p] >> 6) + 32) >> 6, 0, 255);
  st<P>(out, v);
}

template <int T, int N>
int launch_n(const Args& a, cudaStream_t stream) {
  const unsigned ctas = (unsigned)((a.K + kPerCta<N> - 1) / kPerCta<N>);
  mc_kernel<T, N><<<ctas, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int T>
int launch_t(const Args& a, int n, cudaStream_t stream) {
  return n == 8 ? launch_n<T, 8>(a, stream)
                : (n == 16 ? launch_n<T, 16>(a, stream)
                           : launch_n<T, 32>(a, stream));
}

int launch(const Args& a, int n, int chroma, cudaStream_t stream) {
  if (n != 8 && n != 16 && n != 32) return (int)cudaErrorInvalidValue;
  if (a.K <= 0) return (int)cudaSuccess;
  return chroma ? launch_t<4>(a, n, stream) : launch_t<8>(a, n, stream);
}

}  // namespace

extern "C" int mc_qpel(const int32_t* plane, int H, int W, const int32_t* mv,
                       int nb, int n, int chroma, int32_t* out,
                       cudaStream_t stream) {
  const Args a{plane, 1, H, W, mv, nullptr, nb,
               nullptr, nullptr, nullptr, nullptr, out};
  return launch(a, n, chroma, stream);
}

extern "C" int mc_qpel_ref(const int32_t* planes, int R, int H, int W,
                           const int32_t* mv, const int32_t* ref, int K,
                           int n, int chroma, int32_t* out,
                           cudaStream_t stream) {
  const Args a{planes, R, H, W, mv, ref, K,
               nullptr, nullptr, nullptr, nullptr, out};
  return launch(a, n, chroma, stream);
}

extern "C" int mc_qpel_sel(const int32_t* plane0, const int32_t* plane1,
                           int H, int W, const int32_t* mv0,
                           const int32_t* mv1, const int32_t* dir,
                           const int32_t* bi, int nb, int n, int chroma,
                           int32_t* out, cudaStream_t stream) {
  if (dir == nullptr || bi == nullptr) return (int)cudaErrorInvalidValue;
  const Args a{plane0, 1, H, W, mv0, nullptr, nb, plane1, mv1, dir, bi, out};
  return launch(a, n, chroma, stream);
}
