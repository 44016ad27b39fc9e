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
// from the list its direction names, or, where it names both, from both
// lists by K9's device code (`mc_qpel_sel_bi`; `mc_qpel_sel` copies K9's
// rows instead).
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
//   mc_qpel_sel_bi(plane0, plane1, H, W, mv0, mv1, dir, nb, n, chroma,
//                  max_mv, out, excess [] i32, zeroed by the caller): the
//               same, a block that uses both lists bi-predicted here by
//               K9's device code (no bi rows); `excess` receives how far
//               the largest integer part of any block's two MVs lies
//               beyond +-max_mv (K9's window contract, which covers every
//               block: JAX's mc_select bi-predicts them all)
// mv is in luma quarter-pel units; for chroma the same value is the
// eighth-pel chroma MV (4:2:0).
//
// What bounds it on an H100: bytes (the plane read once, one int32 written
// a pixel); at 1080p luma n 16 it runs at 2.6x that bound, and fewer
// instructions a pixel made it faster where more bytes in flight did not.
// Design (the kernel is `csrc/mc_common.cuh`'s, shared with K9): a CTA of
// 256 threads holds several blocks, a group of threads a block (n 8: a
// warp, two adjacent pixels a lane; n 16: two warps, four a thread; n 32:
// eight warps, four a thread), so a block's MV, and with it its phases,
// taps and copies, is uniform across its group:
//   - the group copies the block's window into shared memory once (16
//     bytes a load where it lies inside the plane's columns), filters its
//     rows horizontally once, then each thread its adjacent pixels
//     vertically; a block of the select entry that uses both lists stages
//     both lists' windows, or copies its bi rows.
// So a luma pixel costs about (n + 7) / n x 8 + 8 multiply-adds instead of
// 64 loads and 72 multiply-adds.  Copies by `cp.async`, a persistent CTA
// with the next windows in flight, and eight pixels a thread at n 16 ran
// slower on the card (PERF.md).  dp4a was not tried: it would cut
// only the horizontal multiply-adds, at the price of packing bytes, funnel
// shifts and a range guard for planes outside 0..255.
//
// Exact: see `csrc/mc_common.cuh`.

#include "mc_common.cuh"

extern "C" int mc_qpel(const int32_t* plane, int H, int W, const int32_t* mv,
                       int nb, int n, int chroma, int32_t* out,
                       cudaStream_t stream) {
  const McArgs a{plane, 1, H, W, mv, nullptr, nb, nullptr, nullptr,
                 nullptr, nullptr, out, nullptr, 0};
  return mc_launch<7, 1>(a, n, chroma, stream);
}

extern "C" int mc_qpel_ref(const int32_t* planes, int R, int H, int W,
                           const int32_t* mv, const int32_t* ref, int K,
                           int n, int chroma, int32_t* out,
                           cudaStream_t stream) {
  const McArgs a{planes, R, H, W, mv, ref, K, nullptr, nullptr,
                 nullptr, nullptr, out, nullptr, 0};
  return mc_launch<7, 1>(a, n, chroma, stream);
}

extern "C" int mc_qpel_sel(const int32_t* plane0, const int32_t* plane1,
                           int H, int W, const int32_t* mv0,
                           const int32_t* mv1, const int32_t* dir,
                           const int32_t* bi, int nb, int n, int chroma,
                           int32_t* out, cudaStream_t stream) {
  if (dir == nullptr || bi == nullptr) return (int)cudaErrorInvalidValue;
  const McArgs a{plane0, 1, H, W, mv0, nullptr, nb, plane1, mv1, dir, bi,
                 out, nullptr, 0};
  return mc_launch<7, 1>(a, n, chroma, stream);
}

extern "C" int mc_qpel_sel_bi(const int32_t* plane0, const int32_t* plane1,
                              int H, int W, const int32_t* mv0,
                              const int32_t* mv1, const int32_t* dir,
                              int nb, int n, int chroma, int max_mv,
                              int32_t* out, int32_t* excess,
                              cudaStream_t stream) {
  if (dir == nullptr || excess == nullptr) return (int)cudaErrorInvalidValue;
  const McArgs a{plane0, 1, H, W, mv0, nullptr, nb, plane1, mv1, dir,
                 nullptr, out, excess, max_mv};
  return mc_launch<7, 2>(a, n, chroma, stream);
}
