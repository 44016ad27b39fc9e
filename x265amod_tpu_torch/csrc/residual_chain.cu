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
// 2 n^2 ints and writes n^2 int16 (+ n^2 int32 recon) but does four n-point
// matrix products (4 n^3 multiply-adds).  The JAX package splits 16-bit
// operands into bytes to keep exact f32 MXU products; here one thread block
// owns one candidate block, keeps every stage in shared memory and runs
// exact int32 dot products (every partial sum stays below 2^31, also at bit
// depth 10), with 64-bit products only in quant/dequant.  No TF32.
//
// The RDOQ stage works on the levels and the unrounded f32 levels q in
// shared memory: one thread per coefficient picks |l| or |l| - 1, then one
// thread per 4x4 group decides whether to zero the group.  Its f32
// arithmetic repeats XLA's CPU code operation for operation (see
// ops/rdoq.py): every product and sum is an explicit _rn intrinsic, the
// fused multiply-adds XLA forms are __fmaf_rn, and the file is built with
// --fmad=false so that the compiler fuses nothing else.  Like the
// reference, the stage takes qbits and step at bit depth 8.  The chain
// itself is intra_chain.cuh's `chain`, which K20 shares.

#include <cstdint>
#include <cuda_runtime.h>

#include "intra_chain.cuh"

namespace {

using namespace intra_chain;

template <int BD, bool RDOQ>
__global__ void chain_kernel(const int32_t* __restrict__ orig,
                             const int32_t* __restrict__ pred,
                             const int32_t* __restrict__ qp_arr, int K,
                             int n, int sbh, int intra,
                             const float* __restrict__ rdoq_tab,
                             const float* __restrict__ lam_arr,
                             int16_t* __restrict__ levels,
                             int32_t* __restrict__ recon,
                             int32_t* __restrict__ ssd) {
  __shared__ ChainSmem<RDOQ> sm;
  const int bk = blockIdx.x;
  const int b = bk / K;
  const size_t nn = (size_t)n * n;
  int16_t* lv = levels + bk * nn;
  int32_t* rc = recon == nullptr ? nullptr : recon + bk * nn;
  chain<BD, RDOQ>(
      sm, orig + b * nn, n, pred + bk * nn, n, n, qp_arr[b], sbh, intra,
      rdoq_tab, RDOQ ? lam_arr[b] : 0.0f,
      [&](int i, int v) { lv[i] = (int16_t)v; },
      [&](int i, int v) {
        if (rc != nullptr) rc[i] = v;
      });
  if (threadIdx.x == 0) ssd[bk] = sm.ssd;
}

template <int BD, bool RDOQ>
void launch(const int32_t* orig, const int32_t* pred, const int32_t* qp,
            int B, int K, int n, int sbh, int intra, const float* tab,
            const float* lam, int16_t* levels, int32_t* recon, int32_t* ssd,
            cudaStream_t stream) {
  const int threads = n == 8 ? 64 : 256;
  chain_kernel<BD, RDOQ><<<B * K, threads, 0, stream>>>(
      orig, pred, qp, K, n, sbh, intra, tab, lam, levels, recon, ssd);
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
  const bool rdoq = rdoq_tab != nullptr;
  if (bd == 8 && !rdoq)
    launch<8, false>(orig, pred, qp, B, K, n, sbh, intra, rdoq_tab, lam,
                     levels, recon, ssd, stream);
  else if (bd == 8)
    launch<8, true>(orig, pred, qp, B, K, n, sbh, intra, rdoq_tab, lam,
                    levels, recon, ssd, stream);
  else if (!rdoq)
    launch<10, false>(orig, pred, qp, B, K, n, sbh, intra, rdoq_tab, lam,
                      levels, recon, ssd, stream);
  else
    launch<10, true>(orig, pred, qp, B, K, n, sbh, intra, rdoq_tab, lam,
                     levels, recon, ssd, stream);
  return (int)cudaGetLastError();
}
