// Kernel K21 `deblock_maps`: everything the loop filter (K4) reads besides
// the planes, for a batch of F frames in one call: the vertical and
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
// z-order keep the carry-in.  So a CTB's carry-in is the signalled QP of
// the last coded CTB before it: a prefix max of the coded CTBs' raster
// indices.
//
// What bounds it on an H100: bytes (the levels, 768 bytes a cell, read
// once).  Design: two launches a call, each spread over the card.
//   1. `flags_kernel`: a warp takes four cells (flat: four in raster order;
//      CTB32: a CTB's four), a lane reading 16 bytes of each cell's luma
//      and lanes 0-15 16 bytes of its chroma, all loads in flight at
//      once; two ballots a cell give its flags (bit 0 coded, bit 1 luma
//      coded), one byte a cell, and in the CTB32 modes one byte a CTB
//      (bit 0 coded).  8160 cells of a 1080p frame are 255 CTAs of 8
//      warps.
//   2. `edges_kernel`: a CTA a CTB row of a frame.  The prefix max is a
//      max idempotent and associative, so each CTA derives its own
//      carry-in instead of waiting on other CTAs: a block-wide max over
//      the coded bytes of every CTB before its row (16 a thread a load:
//      8 KB at most at 1080p, from L2), then a block-wide scan over its
//      row and the next (the horizontal edges below its row need the
//      next row's decoded QPs).  It decodes the QP of its cell rows and
//      of the cell row below, then a thread an edge writes bS, edge QP
//      and chroma edge QP of its rows' vertical edges and the horizontal
//      edges below them, with the per-cell inputs read coalesced.
// Exact: int32 in, int32 out.
//
// Entry point (plain C, caller's stream, returns cudaGetLastError()):
//   deblock_maps(const MapsArgs* args, cudaStream_t)

#include <cstdint>
#include <cuda_runtime.h>

extern "C" {
struct MapsArgs {
  int F, h16, w16, mode, slice_qp;
  // levels [F, h16, w16, 256] and [F, h16, w16, 64] (int16, 16-byte
  // aligned)
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
  // scratch bytes (16-byte aligned): the cell flags [F, pad16(h16 w16)],
  // then (modes 0, 1) the CTB flags [F, pad16(h16 w16 / 4)]; pad16(n) is n
  // rounded up to a multiple of 16
  uint8_t* scratch;
};
}

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__constant__ int kChromaQp[14] = {29, 30, 31, 32, 33, 33, 34, 34, 35, 35,
                                  36, 36, 37, 37};

__host__ __device__ inline int pad16(int n) { return (n + 15) & ~15; }

__device__ __forceinline__ int chroma_qp(int q) {
  q = q < 0 ? 0 : (q > 57 ? 57 : q);
  return q < 30 ? q : (q > 43 ? q - 6 : kChromaQp[q - 30]);
}

__device__ __forceinline__ bool nz4(uint4 v) {
  return (v.x | v.y | v.z | v.w) != 0;
}

// the CTB grid of a mode: flat (modes 2, 3) CTB16 = a cell, else CTB32
struct Grid {
  int S, wc, hc, n16, nctb;
  __device__ Grid(const MapsArgs& a) {
    S = a.mode >= 2 ? 1 : 2;
    wc = a.w16 / S;
    hc = a.h16 / S;
    n16 = a.h16 * a.w16;
    nctb = wc * hc;
  }
};

// ---- 1. the flags ---------------------------------------------------------

__global__ void __launch_bounds__(kThreads) flags_kernel(const MapsArgs a) {
  const Grid g(a);
  const int lane = threadIdx.x & 31;
  const int u = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int f = blockIdx.y;
  const int units = g.S == 1 ? (g.n16 + 3) / 4 : g.nctb;
  if (u >= units) return;
  int cell[4];
#pragma unroll
  for (int z = 0; z < 4; ++z) {
    if (g.S == 1) {
      cell[z] = 4 * u + z < g.n16 ? 4 * u + z : -1;
    } else {
      const int r = 2 * (u / g.wc) + (z >> 1), c = 2 * (u % g.wc) + (z & 1);
      cell[z] = r * a.w16 + c;
    }
  }
  const uint4* ly = reinterpret_cast<const uint4*>(a.ly);
  const uint4* lc = reinterpret_cast<const uint4*>(lane < 8 ? a.lcb : a.lcr);
  uint4 y[4], c[4];
#pragma unroll
  for (int z = 0; z < 4; ++z) {
    const size_t ci = (size_t)f * g.n16 + (cell[z] < 0 ? 0 : cell[z]);
    y[z] = cell[z] < 0 ? make_uint4(0, 0, 0, 0) : __ldg(ly + ci * 32 + lane);
    c[z] = cell[z] < 0 || lane >= 16 ? make_uint4(0, 0, 0, 0)
                                     : __ldg(lc + ci * 8 + (lane & 7));
  }
  uint8_t* flags = a.scratch + (size_t)f * pad16(g.n16);
  int any = 0;
#pragma unroll
  for (int z = 0; z < 4; ++z) {
    const bool ny = __ballot_sync(0xffffffffu, nz4(y[z])) != 0;
    const bool nc = __ballot_sync(0xffffffffu, nz4(c[z])) != 0;
    const int fl = (ny || nc ? 1 : 0) | (ny ? 2 : 0);
    any |= fl;
    if (lane == z && cell[z] >= 0) flags[cell[z]] = (uint8_t)fl;
  }
  if (g.S == 2 && lane == 0)
    a.scratch[(size_t)a.F * pad16(g.n16) + (size_t)f * pad16(g.nctb) + u] =
        (uint8_t)(any & 1);
}

// ---- 2. the QP chain and the edges ----------------------------------------

// block-wide inclusive prefix max of one value a thread; *total gets the
// block's max
__device__ int block_scan_max(int v, int* sh, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v = max(v, u);
  }
  if (lane == 31) sh[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? sh[lane] : -1;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w = max(w, u);
    }
    if (lane < kWarps) sh[lane] = w;
  }
  __syncthreads();
  const int before = warp ? sh[warp - 1] : -1;
  *total = sh[kWarps - 1];
  __syncthreads();
  return max(v, before);
}

// one frame's per-cell inputs
struct Frame {
  const MapsArgs& a;
  const Grid& g;
  int f;
  const uint8_t* flags;
  __device__ int fl(int r, int c) const { return flags[r * a.w16 + c]; }
  __device__ int split(int r, int c) const {
    return a.split[(size_t)f * g.nctb + (r / 2) * g.wc + c / 2];
  }
};

// spec 8.7.2.4 bS between cells p and q of a P/B frame (JAX _bs_pair)
__device__ int bs_pair(const Frame& fr, int p, int q, int cbf_p, int cbf_q) {
  const MapsArgs& a = fr.a;
  const size_t base = (size_t)fr.f * fr.g.n16;
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
__device__ int tu_cbf(const Frame& fr, int r, int c) {
  if (fr.split(r, c)) return (fr.fl(r, c) >> 1) & 1;
  const int r0 = r & ~1, c0 = c & ~1;
  return ((fr.fl(r0, c0) | fr.fl(r0, c0 + 1) | fr.fl(r0 + 1, c0) |
           fr.fl(r0 + 1, c0 + 1)) >> 1) & 1;
}

// bS of the edge between cells p = (r, c) and q = (rq, cq) (the right or
// lower neighbour); `internal`: the edge lies inside a CTB32
__device__ int edge_bs(const Frame& fr, int r, int c, int rq, int cq,
                       bool internal) {
  const MapsArgs& a = fr.a;
  if (a.mode == 2) return 2;
  if (a.mode == 3)
    return bs_pair(fr, r * a.w16 + c, rq * a.w16 + cq, (fr.fl(r, c) >> 1) & 1,
                   (fr.fl(rq, cq) >> 1) & 1);
  const int sp = fr.split(rq, cq);
  if (a.mode == 0) return internal ? 2 * sp : 2;
  if (internal && sp == 0) return 0;
  return bs_pair(fr, r * a.w16 + c, rq * a.w16 + cq, tu_cbf(fr, r, c),
                 tu_cbf(fr, rq, cq));
}

// grid (CTB rows, F); dynamic shared memory (2 wc + 3 w16 + 32) ints
__global__ void __launch_bounds__(kThreads) edges_kernel(const MapsArgs a) {
  extern __shared__ int sm[];
  const Grid g(a);
  const int R = blockIdx.x, f = blockIdx.y, tid = threadIdx.x;
  const uint8_t* flags = a.scratch + (size_t)f * pad16(g.n16);
  const uint8_t* ctbf =
      g.S == 1 ? flags
               : a.scratch + (size_t)a.F * pad16(g.n16) +
                     (size_t)f * pad16(g.nctb);
  const Frame fr{a, g, f, flags};
  int* sh = sm;                   // [32] the scans' warp totals
  int* incl = sm + 32;            // [2 wc] last coded CTB at or before K
  int* eff = incl + 2 * g.wc;     // [(S + 1) w16] decoded QPs
  const int K0 = R * g.wc, K1 = min(g.nctb, K0 + 2 * g.wc);
  // the last coded CTB before this row: 16 CTB bytes a thread a load
  int last = -1;
  const uint4* c4 = reinterpret_cast<const uint4*>(ctbf);
  for (int q = tid; q * 16 < K0; q += kThreads) {
    const uint4 v = c4[q];
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (((w[i >> 2] >> (8 * (i & 3))) & 1) && q * 16 + i < K0)
        last = q * 16 + i;
  }
  int carry0;                     // the last coded CTB before K0, or -1
  block_scan_max(last, sh, &carry0);
  // the scan over this row's CTBs and the next row's
  int run = carry0;
  for (int k0 = K0; k0 < K1; k0 += kThreads) {
    const int k = k0 + tid;
    int total;
    const int v = block_scan_max(k < K1 && (ctbf[k] & 1) ? k : -1, sh,
                                 &total);
    if (k < K1) incl[k - K0] = max(v, run);
    run = max(run, total);
  }
  __syncthreads();
  // decoded QPs of this row's cell rows and of the cell row below
  const int rlo = g.S * R;
  const int nrows = min(g.S, a.h16 - rlo);          // this row's cell rows
  const int nq = min(g.S + 1, a.h16 - rlo);          // with the row below
  const int w16 = a.w16;
  for (int i = tid; i < nq * w16; i += kThreads) {
    const int r = rlo + i / w16, c = i % w16;
    int q;
    if (g.S == 1) {
      const int last = incl[r * g.wc + c - K0];
      q = last >= 0 ? a.qp_sig[last] : a.slice_qp;
    } else {
      const int k = (r / 2) * g.wc + c / 2;
      const int r0 = r & ~1, c0 = c & ~1;
      const int cz0 = fr.fl(r0, c0) & 1, cz1 = fr.fl(r0, c0 + 1) & 1;
      const int cz2 = fr.fl(r0 + 1, c0) & 1, cz3 = fr.fl(r0 + 1, c0 + 1) & 1;
      int firstz = 4;
      if (cz0 | cz1 | cz2 | cz3)
        firstz = fr.split(r, c) ? (cz0 ? 0 : (cz1 ? 1 : (cz2 ? 2 : 3))) : 0;
      const int z = (r & 1) * 2 + (c & 1);
      if (z >= firstz) {
        q = a.qp_sig[k];
      } else {
        const int carry = k == K0 ? carry0 : incl[k - K0 - 1];
        q = carry >= 0 ? a.qp_sig[carry] : a.slice_qp;
      }
    }
    eff[i] = q;
  }
  __syncthreads();
  // a thread an edge: this row's vertical edges, the horizontal edges below
  // its cell rows
  const int nv = nrows * (w16 - 1);
  const int nh = (nq - 1) * w16;
  for (int e = tid; e < nv + nh; e += kThreads) {
    int r, c, rq, cq;
    bool internal;
    if (e < nv) {
      r = rlo + e / (w16 - 1), c = e % (w16 - 1), rq = r, cq = c + 1;
      internal = (c & 1) == 0;
    } else {
      r = rlo + (e - nv) / w16, c = (e - nv) % w16, rq = r + 1, cq = c;
      internal = (r & 1) == 0;
    }
    const int bs = edge_bs(fr, r, c, rq, cq, internal);
    const int q = (eff[(r - rlo) * w16 + c] + eff[(rq - rlo) * w16 + cq] +
                   1) >> 1;
    if (e < nv) {
      const size_t o = ((size_t)f * a.h16 + r) * (w16 - 1) + c;
      a.bs_v[o] = bs;
      a.qp_v[o] = q;
      a.qpc_v[o] = chroma_qp(q);
    } else {
      const size_t o = ((size_t)f * (a.h16 - 1) + r) * w16 + c;
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
  const int S = a.mode >= 2 ? 1 : 2;
  const int wc = a.w16 / S, hc = a.h16 / S;
  const int units = S == 1 ? (a.h16 * a.w16 + 3) / 4 : wc * hc;
  flags_kernel<<<dim3((units + kWarps - 1) / kWarps, a.F), kThreads, 0,
                 stream>>>(a);
  const size_t smem = (size_t)(32 + 2 * wc + 3 * a.w16) * sizeof(int);
  edges_kernel<<<dim3(hc, a.F), kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}
