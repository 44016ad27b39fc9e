// Kernel K21 `deblock_maps`: everything the loop filter (K4) reads besides
// the planes, for a batch of F frames in one launch: the vertical and
// horizontal bS maps on the 16-cell edge grid, the decoded per-cell QP
// chain, the per-edge luma QPs and their chroma mapping.
//
// Replaces, from the JAX package (ops/deblock.py): _bs_pair (:296),
// bs_maps (:310), intra_tree_bs_maps (:330), inter_tree_bs_maps (:356),
// effective_qp_map (:384), effective_qp16_tree (:415), edge_qp_maps
// (:454), and the all-bS-2 maps of the flat CTB16 intra frame
// (models/intra_frame.py :252-277) and of the flat CTB16 P and B frames
// (models/inter_frame.py :472-501, models/b_frame.py :562-588), with
// quant.py's chroma QP table.
//
// Four shapes (`mode`):
//   0  the intra CTU32 tree: bS 2 on every TU edge, 0 on the internal
//      16-edges of an unsplit CTU; QP chain per CTB32 (z-order in a CTB);
//   1  the P/B CTU32 trees: spec 8.7.2.4 bS from the per-cell kinds
//      (2 = intra), directions, MVs and L0 reference indices, with the TU
//      luma cbf (a TU32's over its four cells), internal 16-edges of an
//      unsplit CTU zeroed; the same QP chain;
//   2  the flat CTB16 intra frame: bS 2 on every edge; QP chain per CTB16;
//   3  the flat CTB16 P/B frame: spec 8.7.2.4 bS from the per-cell kinds,
//      directions and MVs (reference index 0) with the cell's own luma cbf,
//      every 16-edge a CU and TU edge; mode 2's QP chain.
// The QP chain (spec 8.6.1, QG == CTB): a CTB's QpY is its signalled QP
// where it codes coefficients, else the previous CTB's in raster order,
// from SliceQpY; in a CTB32 the cells before the first coded cell in
// z-order keep the carry-in.  The carry-forward is a block-wide prefix max
// of the coded CTBs' raster indices.
//
// Design: one thread block a frame, 1024 threads.  A warp reads a cell's
// levels (256 + 2 x 64 int16, as 32-bit words) and marks it coded / luma
// coded in a global scratch; then the prefix max; then a thread an edge.
// Exact: int32 in, int32 out.
//
// What bounds it on an H100: bytes (the frame's levels, read once); the
// launch is one block a frame, so at small F the per-block read rate bounds
// it instead.
//
// Entry point (plain C, caller's stream, returns cudaGetLastError()):
//   deblock_maps(const MapsArgs* args, cudaStream_t)

#include <cstdint>
#include <cuda_runtime.h>

extern "C" {
struct MapsArgs {
  int F, h16, w16, mode, slice_qp;
  // levels [F, h16, w16, 256] and [F, h16, w16, 64] (int16)
  const int16_t *ly, *lcb, *lcr;
  // modes 0, 1: split per CTB32 [F, h16/2, w16/2]; null in modes 2, 3
  const int32_t* split;
  // signalled QP per CTB: [h16/2, w16/2] (modes 0, 1) or [h16, w16] (2)
  const int32_t* qp_sig;
  // modes 1, 3: kinds [F, h16, w16] (2 = intra); dir (null: 1, L0 only), mv0,
  // mv1 (null: 0) [F, h16, w16, 2] qpel, ref0 (null: 0) [F, h16, w16]
  const int32_t *kinds, *dir, *mv0, *mv1, *ref0;
  // outputs [F, h16, w16 - 1] and [F, h16 - 1, w16]
  int32_t *bs_v, *bs_h, *qp_v, *qp_h, *qpc_v, *qpc_h;
  // scratch [F, 2, h16 w16]: flags (1 coded, 2 luma coded), decoded QP
  int32_t* scratch;
};
}

namespace {

constexpr int kThreads = 1024;

__constant__ int kChromaQp[14] = {29, 30, 31, 32, 33, 33, 34, 34, 35, 35,
                                  36, 36, 37, 37};

__device__ __forceinline__ int chroma_qp(int q) {
  q = q < 0 ? 0 : (q > 57 ? 57 : q);
  return q < 30 ? q : (q > 43 ? q - 6 : kChromaQp[q - 30]);
}

__device__ __forceinline__ bool any_nz(const int16_t* p, int n, int lane) {
  const int32_t* w = reinterpret_cast<const int32_t*>(p);
  bool nz = false;
  for (int i = lane; i < n / 2; i += 32) nz |= w[i] != 0;
  return __any_sync(0xffffffffu, nz);
}

// one frame of the launch: its index and cell count
struct Frame {
  const MapsArgs& a;
  int fi, n16;
  __device__ int flags(int c) const {
    return a.scratch[(size_t)fi * 2 * n16 + c];
  }
};

// spec 8.7.2.4 bS between cells p and q of a P/B frame (JAX _bs_pair)
__device__ int bs_pair(const MapsArgs& a, const Frame& fr, int p, int q,
                       int cbf_p, int cbf_q) {
  const size_t base = (size_t)fr.fi * fr.n16;
  if (a.kinds[base + p] == 2 || a.kinds[base + q] == 2) return 2;
  const int dp = a.dir ? a.dir[base + p] : 1;
  const int dq = a.dir ? a.dir[base + q] : 1;
  const int rp = a.ref0 ? a.ref0[base + p] : 0;
  const int rq = a.ref0 ? a.ref0[base + q] : 0;
  bool big0 = false, big1 = false;
  for (int k = 0; k < 2; ++k) {
    big0 |= abs(a.mv0[(base + p) * 2 + k] - a.mv0[(base + q) * 2 + k]) >= 4;
    if (a.mv1)
      big1 |= abs(a.mv1[(base + p) * 2 + k] - a.mv1[(base + q) * 2 + k]) >= 4;
  }
  const bool mm = dp != dq || ((dp & 1) && big0) || ((dp & 2) && big1) ||
                  rp != rq;
  return (cbf_p || cbf_q || mm) ? 1 : 0;
}

// the TU's luma cbf of cell (r, c): its own in a split CTB32, else any of
// the CTB's four cells'
__device__ int tu_cbf(const MapsArgs& a, const Frame& fr, int r, int c) {
  const int wc = a.w16 / 2;
  if (a.split[(size_t)fr.fi * (a.h16 / 2) * wc + (r / 2) * wc + c / 2])
    return (fr.flags(r * a.w16 + c) >> 1) & 1;
  const int r0 = r & ~1, c0 = c & ~1;
  int any = 0;
  for (int k = 0; k < 4; ++k)
    any |= fr.flags((r0 + (k >> 1)) * a.w16 + c0 + (k & 1)) >> 1;
  return any & 1;
}

// bS of the edge between cells p = (r, c) and q (the right or lower
// neighbour); `internal`: the edge lies inside a CTB32
__device__ int edge_bs(const MapsArgs& a, const Frame& fr, int r, int c,
                       int rq, int cq, bool internal) {
  if (a.mode == 2) return 2;
  if (a.mode == 3)
    return bs_pair(a, fr, r * a.w16 + c, rq * a.w16 + cq,
                   (fr.flags(r * a.w16 + c) >> 1) & 1,
                   (fr.flags(rq * a.w16 + cq) >> 1) & 1);
  const int wc = a.w16 / 2;
  const int sp = a.split[(size_t)fr.fi * (a.h16 / 2) * wc + (rq / 2) * wc +
                         cq / 2];
  if (a.mode == 0) return internal ? 2 * sp : 2;
  if (internal && sp == 0) return 0;
  return bs_pair(a, fr, r * a.w16 + c, rq * a.w16 + cq, tu_cbf(a, fr, r, c),
                 tu_cbf(a, fr, rq, cq));
}

// block-wide inclusive prefix max of one value per thread
__device__ int block_prefix_max(int v, int* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v = max(v, u);
  }
  if (lane == 31) sh[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = sh[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w = max(w, u);
    }
    sh[lane] = w;
  }
  __syncthreads();
  const int before = warp ? sh[warp - 1] : -1;
  __syncthreads();
  return max(v, before);
}

__global__ void __launch_bounds__(kThreads)
    maps_kernel(const MapsArgs a) {
  __shared__ int sh[32];
  __shared__ int incl[kThreads];
  const int fi = blockIdx.x;
  const int n16 = a.h16 * a.w16;
  const Frame fr{a, fi, n16};
  int32_t* flags = a.scratch + (size_t)fi * 2 * n16;
  int32_t* eff = flags + n16;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // 1. coded / luma-coded flags, a warp a cell
  for (int c = warp; c < n16; c += kThreads / 32) {
    const size_t cell = (size_t)fi * n16 + c;
    const bool y = any_nz(a.ly + cell * 256, 256, lane);
    const bool u = any_nz(a.lcb + cell * 64, 64, lane);
    const bool v = any_nz(a.lcr + cell * 64, 64, lane);
    if (lane == 0) flags[c] = (y || u || v ? 1 : 0) | (y ? 2 : 0);
  }
  __syncthreads();
  // 2. the QP chain over the CTBs in raster order
  const bool flat = a.mode >= 2;
  const int wc = flat ? a.w16 : a.w16 / 2;
  const int nctb = flat ? n16 : n16 / 4;
  auto ctb_coded = [&](int k) -> int {
    if (flat) return flags[k] & 1;
    const int r = 2 * (k / wc), c = 2 * (k % wc);
    return (flags[r * a.w16 + c] | flags[r * a.w16 + c + 1] |
            flags[(r + 1) * a.w16 + c] | flags[(r + 1) * a.w16 + c + 1]) & 1;
  };
  const int per = (nctb + kThreads - 1) / kThreads;
  const int lo = threadIdx.x * per;
  const int hi = min(lo + per, nctb);
  int local = -1;
  for (int k = lo; k < hi; ++k)
    if (ctb_coded(k)) local = k;
  incl[threadIdx.x] = block_prefix_max(local, sh);
  __syncthreads();
  // the last coded CTB before this thread's chunk
  int run = threadIdx.x ? incl[threadIdx.x - 1] : -1;
  for (int k = lo; k < hi; ++k) {
    const int prev_last = run;               // last coded CTB before k
    if (ctb_coded(k)) run = k;
    const int q_k = run >= 0 ? a.qp_sig[run] : a.slice_qp;
    if (flat) {
      eff[k] = q_k;
      continue;
    }
    const int carry = prev_last >= 0 ? a.qp_sig[prev_last] : a.slice_qp;
    const int r = 2 * (k / wc), c = 2 * (k % wc);
    int cz[4];
    for (int z = 0; z < 4; ++z)
      cz[z] = flags[(r + (z >> 1)) * a.w16 + c + (z & 1)] & 1;
    const bool anyc = cz[0] | cz[1] | cz[2] | cz[3];
    int firstz = 0;
    if (a.split[(size_t)fi * nctb + k])
      while (firstz < 4 && !cz[firstz]) ++firstz;
    if (!anyc) firstz = 4;
    for (int z = 0; z < 4; ++z)
      eff[(r + (z >> 1)) * a.w16 + c + (z & 1)] =
          z < firstz ? carry : a.qp_sig[k];
  }
  __syncthreads();
  // 3. a thread an edge: bS, edge QP, chroma edge QP
  const int nv = a.h16 * (a.w16 - 1);
  const int nh = (a.h16 - 1) * a.w16;
  for (int e = threadIdx.x; e < nv + nh; e += kThreads) {
    int r, c, rq, cq, bs;
    size_t o;
    if (e < nv) {
      r = e / (a.w16 - 1), c = e % (a.w16 - 1), rq = r, cq = c + 1;
      bs = edge_bs(a, fr, r, c, rq, cq, (c & 1) == 0);
      o = (size_t)fi * nv + e;
    } else {
      const int e2 = e - nv;
      r = e2 / a.w16, c = e2 % a.w16, rq = r + 1, cq = c;
      bs = edge_bs(a, fr, r, c, rq, cq, (r & 1) == 0);
      o = (size_t)fi * nh + e2;
    }
    const int q = (eff[r * a.w16 + c] + eff[rq * a.w16 + cq] + 1) >> 1;
    if (e < nv) {
      a.bs_v[o] = bs;
      a.qp_v[o] = q;
      a.qpc_v[o] = chroma_qp(q);
    } else {
      a.bs_h[o] = bs;
      a.qp_h[o] = q;
      a.qpc_h[o] = chroma_qp(q);
    }
  }
}

}  // namespace

extern "C" int deblock_maps(const MapsArgs* args, cudaStream_t stream) {
  const MapsArgs& a = *args;
  if (a.F < 1 || a.h16 < 1 || a.w16 < 1 || a.mode < 0 || a.mode > 3)
    return (int)cudaErrorInvalidValue;
  if (a.mode < 2 && (a.split == nullptr || a.h16 % 2 || a.w16 % 2))
    return (int)cudaErrorInvalidValue;
  if ((a.mode == 1 || a.mode == 3) &&
      (a.kinds == nullptr || a.mv0 == nullptr))
    return (int)cudaErrorInvalidValue;
  maps_kernel<<<a.F, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}
