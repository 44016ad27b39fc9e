// Kernel K9 `mc_bi`: bi-prediction of every n x n raster block of a plane:
// two 14-bit predictions (quarter-pel luma 8-tap, or eighth-pel chroma
// 4-tap), one from each reference at its own MV, combined as
// Clip((p0 + p1 + 64) >> 7) (spec 8.5.3.3.4.3, 8-bit).
//
// Replaces, from the JAX package: ops/me.py bi_combine (:323) over
// mc_luma_qpel14 (:262) / mc_chroma_qpel14 (:331) of the two lists, as the
// B tree calls them in its trials (models/inter_tree.py:1274-1279) and in
// mc_select (:1610-1624), with the one-hot window fetch _block_windows
// (:180) those use.  The port's mc_select runs this device code inside
// K7's select entry (`csrc/mc_qpel.cu:mc_qpel_sel_bi`); this entry serves
// the trials.
//
// Entry point (plain C, caller's stream, returns cudaGetLastError()):
//   mc_bi(ref0 [H,W] i32, ref1 [H,W] i32, H, W, mv0 [nb,2] i32,
//         mv1 [nb,2] i32, nb, n, chroma, max_mv, out [nb,n,n] i32,
//         excess [] i32, zeroed by the caller)
// MVs are in luma quarter-pel units; for chroma the same value is the
// eighth-pel chroma MV (4:2:0).  `excess` receives how far the largest
// integer MV part lies beyond +-max_mv (the window contract), 0 inside it.
//
// What bounds it on an H100: bytes (the samples each block needs from the
// two planes read once, one int32 out per sample).  Design: K7's
// (`csrc/mc_common.cuh`, shared): a group of threads a block, several
// blocks a CTA; both windows staged in shared memory once, together (16
// bytes a load where a window lies inside the plane's columns, rows at
// clamped coordinates: the edge padding the JAX fetch gives inside its
// window contract, which the kernel measures for the wrapper to check);
// each window's rows filtered horizontally once; 2-4 adjacent pixels a
// thread filtered vertically from both, the two 14-bit values combined in
// registers, clipped and stored as one 8- or 16-byte store.  Before, a
// thread an output sample filtered its whole T x T neighbourhood in both
// references on its own (128 loads and 144 multiply-adds a luma pixel).
//
// Exact: int32 throughout, arithmetic shifts; the range argument is
// `csrc/mc_common.cuh`'s.

#include "mc_common.cuh"

extern "C" int mc_bi(const int32_t* ref0, const int32_t* ref1, int H, int W,
                     const int32_t* mv0, const int32_t* mv1, int nb, int n,
                     int chroma, int max_mv, int32_t* out, int32_t* excess,
                     cudaStream_t stream) {
  if (excess == nullptr) return (int)cudaErrorInvalidValue;
  const McArgs a{ref0, 1, H, W, mv0, nullptr, nb, ref1, mv1, nullptr,
                 nullptr, out, excess, max_mv};
  return mc_launch<9, 2>(a, n, chroma, stream);
}
