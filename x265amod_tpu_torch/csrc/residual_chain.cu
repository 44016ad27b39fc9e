// Kernel K2 `residual_chain`: forward DCT -> quant -> RDOQ (optional) ->
// sign-bit hiding -> dequant -> inverse DCT -> add prediction -> clip, plus
// the SSD of the reconstruction, for K candidate predictions of each block,
// at bit depth 8 or 10.
//
// Replaces, from the JAX package: ops/transforms.py fwd_transform and
// inv_transform (DCT 8/16/32), ops/quant.py quant and dequant,
// ops/rdoq.py rdoq_adjust and ops/sbh.py sbh_adjust, as chained in
// models/intra_tree.py eval_intra_luma / eval_intra_chroma and the P and B
// trees' final coding (models/inter_tree.py:619,1626).
//
// Entry point (plain C, caller's stream, returns cudaGetLastError()):
//   residual_chain(orig [B,n,n] i32, pred [B,K,n,n] i32, qp [B] i32, B, K,
//                  n, sbh, intra, bd, rdoq_tab f32 [262] or NULL,
//                  lam [B] f32 or NULL, levels [B,K,n,n] i16,
//                  recon [B,K,n,n] i32 or NULL, ssd [B,K] i32)
// intra selects the quant rounding offset: 171 << (qbits - 9) for intra
// blocks, 85 << (qbits - 9) for inter blocks (ops/quant.py:100).
// rdoq_tab (step[52], rates[4][52], csb0, csb1; ops/rdoq.py kernel_table)
// switches the RDOQ stage on with the per-block lambdas lam.
//
// What bounds it on an H100: integer operations.  Per n x n block it reads
// 2 n^2 ints and writes n^2 int16 (+ n^2 int32 recon); its four n-point
// passes are partial butterflies of 22, 86 or 342 multiplies a line for n
// 8, 16 and 32 (chain_lanes.cuh), exact int32 sums (every partial sum stays
// below 2^31, also at bit depth 10), with 64-bit products only in
// quant/dequant.  The JAX package splits 16-bit operands into bytes to keep
// exact f32 MXU products; no TF32 here.
//
// Design: a thread block codes several candidate blocks, a group of n
// lanes each (lane l owns line l: a warp per 32x32 block, half a warp per
// 16x16, a quarter per 8x8); the K candidates of one block share a thread
// block, which stages the block's source once in shared memory (padded
// rows) and hands its candidates to its groups, about 256 threads a thread
// block (several blocks a thread block when K is small, several rounds of
// groups when K is large: the flat intra trial's 35 modes run as 3 rounds
// of 12 groups).  Each group keeps its lines in registers and crosses rows
// and columns through its own padded n x (n + 1) tile: shared memory sized
// to n (and, with RDOQ, a second tile of unrounded levels).  Quant and
// RDOQ's per-coefficient choice run in the column pass's registers, the
// RDOQ group decision and sign hiding one 4x4 group per lane, dequant in
// the inverse column pass, clip and SSD in the inverse row pass.
//
// The RDOQ stage repeats XLA's CPU f32 code operation for operation (see
// ops/rdoq.py): every product and sum is an explicit _rn intrinsic, the
// fused multiply-adds XLA forms are __fmaf_rn, and the file is built with
// --fmad=false so that the compiler fuses nothing else.  Like the
// reference, the stage takes qbits and step at bit depth 8.  K20 and K23
// code their blocks with the same group chain (chain_lanes.cuh).

#include <cstdint>
#include <cuda_runtime.h>

#include "chain_lanes.cuh"

namespace {

using namespace chain_lanes;

constexpr int kGroupThreads = 256;   // lanes of groups a thread block aims at

template <int N, int BD, bool RDOQ>
__global__ void __launch_bounds__(kGroupThreads)
    chain_kernel(const int32_t* __restrict__ orig,
                 const int32_t* __restrict__ pred,
                 const int32_t* __restrict__ qp_arr, int B, int K, int Bc,
                 int sbh, int intra, const float* __restrict__ rdoq_tab,
                 const float* __restrict__ lam_arr,
                 int16_t* __restrict__ levels, int32_t* __restrict__ recon,
                 int32_t* __restrict__ ssd) {
  constexpr int P = N + 1, NP = N * P, NN = N * N;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = blockDim.x / N;
  int* so = reinterpret_cast<int*>(smem_raw);     // [Bc][N][P] sources
  int* tiles = so + Bc * NP;                       // [G][N][P]
  float* qtiles = reinterpret_cast<float*>(tiles + G * NP);
  const int b0 = blockIdx.x * Bc;
  const int nb = B - b0 < Bc ? B - b0 : Bc;
  // each source block once, for all its candidates
  for (int i = threadIdx.x; i < nb * NN; i += blockDim.x) {
    const int r = i % NN;
    so[(i / NN) * NP + (r / N) * P + r % N] = orig[(size_t)b0 * NN + i];
  }
  __syncthreads();
  const int grp = threadIdx.x / N, l = threadIdx.x % N;
  const unsigned mask = group_mask<N>();
  int* S = tiles + grp * NP;
  float* Q = RDOQ ? qtiles + grp * NP : nullptr;
  for (int w = grp; w < nb * K; w += G) {
    const int bl = w / K, b = b0 + bl;
    const size_t bk = (size_t)b * K + w % K;
    const int* o = so + bl * NP;
    const int32_t* p = pred + bk * NN;
    const int qp = qp_arr[b];
    RdoqRow t{};
    if (RDOQ) {
      t.step = rdoq_tab[qp];
      t.r0 = rdoq_tab[52 + qp];
      t.r1 = rdoq_tab[104 + qp];
      t.r2 = rdoq_tab[156 + qp];
      t.r3 = rdoq_tab[208 + qp];
      t.csb0 = rdoq_tab[260];
      t.csb1 = rdoq_tab[261];
      t.lam = lam_arr[b];
    }
    // the prediction into the tile, a row at a time across the lanes
    for (int i = l; i < NN; i += N) S[(i / N) * P + i % N] = p[i];
    __syncwarp(mask);
    int16_t* lv = levels + bk * NN;
    const int s = group_chain<N, BD, RDOQ>(
        l, mask, S, Q, qp, sbh, intra, t,
        [&](int y, int* v) {
#pragma unroll
          for (int x = 0; x < N; ++x) v[x] = o[y * P + x] - S[y * P + x];
        },
        [&](int y, int* v) {
#pragma unroll
          for (int x = 0; x < N; ++x) v[x] = __ldg(p + y * N + x);
        },
        [&](int y, int* v) {
#pragma unroll
          for (int x = 0; x < N; ++x) v[x] = o[y * P + x];
        },
        [&](int u, int x, int v) { lv[u * N + x] = (int16_t)v; },
        [&](int y, const int* r) {
#pragma unroll
          for (int x = 0; x < N; ++x) S[y * P + x] = r[x];
        });
    if (recon != nullptr)
      for (int i = l; i < NN; i += N)
        recon[bk * NN + i] = S[(i / N) * P + i % N];
    if (l == 0) ssd[bk] = s;
    __syncwarp(mask);
  }
}

template <int N, int BD, bool RDOQ>
int launch(const int32_t* orig, const int32_t* pred, const int32_t* qp,
           int B, int K, int sbh, int intra, const float* tab,
           const float* lam, int16_t* levels, int32_t* recon, int32_t* ssd,
           cudaStream_t stream) {
  constexpr int NP = N * (N + 1);
  constexpr int gmax = kGroupThreads / N;
  int bc = gmax / K;
  bc = bc < 1 ? 1 : (bc > B ? B : bc);
  const int work = bc * K;
  const int rounds = (work + gmax - 1) / gmax;
  const int groups = (work + rounds - 1) / rounds;
  const size_t smem = (size_t)bc * NP * 4 +
                      (size_t)groups * NP * 4 * (RDOQ ? 2 : 1);
  const cudaError_t e = cudaFuncSetAttribute(
      chain_kernel<N, BD, RDOQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  chain_kernel<N, BD, RDOQ><<<(B + bc - 1) / bc, groups * N, smem, stream>>>(
      orig, pred, qp, B, K, bc, sbh, intra, tab, lam, levels, recon, ssd);
  return (int)cudaGetLastError();
}

template <int N>
int launch_n(const int32_t* orig, const int32_t* pred, const int32_t* qp,
             int B, int K, int sbh, int intra, int bd, const float* tab,
             const float* lam, int16_t* levels, int32_t* recon,
             int32_t* ssd, cudaStream_t stream) {
  const bool rdoq = tab != nullptr;
  if (bd == 8 && !rdoq)
    return launch<N, 8, false>(orig, pred, qp, B, K, sbh, intra, tab, lam,
                               levels, recon, ssd, stream);
  if (bd == 8)
    return launch<N, 8, true>(orig, pred, qp, B, K, sbh, intra, tab, lam,
                              levels, recon, ssd, stream);
  if (!rdoq)
    return launch<N, 10, false>(orig, pred, qp, B, K, sbh, intra, tab, lam,
                                levels, recon, ssd, stream);
  return launch<N, 10, true>(orig, pred, qp, B, K, sbh, intra, tab, lam,
                             levels, recon, ssd, stream);
}

}  // namespace

extern "C" int residual_chain(const int32_t* orig, const int32_t* pred,
                              const int32_t* qp, int B, int K, int n,
                              int sbh, int intra, int bd,
                              const float* rdoq_tab, const float* lam,
                              int16_t* levels, int32_t* recon, int32_t* ssd,
                              cudaStream_t stream) {
  if (n != 8 && n != 16 && n != 32) return (int)cudaErrorInvalidValue;
  if (bd != 8 && bd != 10) return (int)cudaErrorInvalidValue;
  if ((rdoq_tab == nullptr) != (lam == nullptr))
    return (int)cudaErrorInvalidValue;
  if (B < 1 || K < 1) return (int)cudaErrorInvalidValue;
  if (n == 8)
    return launch_n<8>(orig, pred, qp, B, K, sbh, intra, bd, rdoq_tab, lam,
                       levels, recon, ssd, stream);
  if (n == 16)
    return launch_n<16>(orig, pred, qp, B, K, sbh, intra, bd, rdoq_tab, lam,
                        levels, recon, ssd, stream);
  return launch_n<32>(orig, pred, qp, B, K, sbh, intra, bd, rdoq_tab, lam,
                      levels, recon, ssd, stream);
}
