// Kernel K10 `sao_analyse`: per-CTU SAO statistics and the RD choice of
// the SAO parameters, for luma (one plane), jointly for cb and cr (two
// planes that share the type and the edge class), or for a whole frame
// (luma at the CTU size and cb + cr at half of it, one launch).
//
// Replaces, from the JAX package: ops/sao.py sao_analyse (:75) and
// sao_analyse_chroma (:257), with their _eo_cat_map (:42), _block_sum and
// _block_sum3 statistics.
//
// Entry points (plain C, caller's stream, return cudaGetLastError()):
//   sao_analyse(orig_a, rec_a, orig_b, rec_b [H,W] i32, H, W, ctu, two,
//               lam [n] f32, rows [n,12] i32, gain [n] f32)
//     two = 0: one plane (a); rows are (type, eo_class, band_pos,
//     offsets[4], 0...) and gain the cost of "off" less the chosen cost.
//     two = 1: cb (a) and cr (b); rows are (type, eo_class, band_pos_a,
//     offsets_a[4], band_pos_b, offsets_b[4]) and gain is 0.
//   sao_analyse_frame(oy, ry [H,W] i32, H, W, ctu, ocb, rcb, ocr,
//                     rcr [H/2,W/2] i32, lam [n] f32, rows_y [n,12] i32,
//                     gain [n] f32, rows_c [n,12] i32)
//     both analyses of a frame: luma at ctu into rows_y and gain, cb and cr
//     at ctu / 2 into rows_c, on the same CTU grid and lambdas.
// Samples are 8-bit (0..255): the band is v >> 3.
//
// What bounds it on an H100: bytes at the roofline (the int32 planes read
// once, the neighbours from L1); on the card the counters' shared-memory
// traffic and the RD choice's instructions take most of its time
// (PERF.md, PR 17).  Design: a group of warps a CTU (one where the largest plane's CTU side
// is 8 or 16, four at 32), four warps a CTA, so a CTA holds four CTUs or
// one:
//   - each lane classifies P adjacent samples of a row (P = 4, 2 for luma
//     at a CTU side of 8) from 16- or 8-byte loads of its row and the rows
//     above and below, the two side columns by single loads; the group's
//     warps take the planes' rows in turn; cb and cr of side 8 share one
//     step, lanes 0-15 cb and 16-31 cr;
//   - it adds each sample into counters of its own, (1 << 20) + (orig -
//     rec) a sample (the count above bit 20, the error sum below it), in
//     shared memory laid out [counter][lane]: no atomics, no bank
//     conflicts, whatever the content; 16 edge (class, category) counters,
//     32 band counters, a discard counter for category 0 (a neighbour
//     outside the picture gives category 0);
//   - a sample's edge index 2 + sgn + sgn picks its counter of each class
//     from a byte table (__byte_perm), no branches; its five counters are
//     read together, then written;
//   - after each plane a warp sums every counter over its 32 lanes (16-byte
//     reads rotated across the banks) and adds the sums, less those after
//     the plane before, into the CTU's totals with one shared atomicAdd
//     each: the counters are zeroed once, as the kernel starts (the shared
//     memory's bandwidth, which reading and zeroing them took, is what
//     held the CTB16 frame back);
//   - the RD choice of each plane runs on one warp, a lane a candidate:
//     lane 4 k + c prices edge class k's category c, lane b band b at both
//     signs in one loop; the category costs are added in order c = 0..3
//     and the band windows ((d0 + d1) + d2) + d3 through shuffles; a
//     (value, index) shuffle minimum with ties to the lower index gives
//     the first minimum a sequential "<" scan gives.  With four warps a
//     CTU the three planes' choices run in parallel.
// Exact: the packed sums stay in int32 (a CTU holds at most 1024 samples
// of |orig - rec| <= 255, so |error sum| < 2^19 and count << 20 <= 2^30;
// a lane adds at most 16 samples into a counter over a CTU's planes, so a
// warp's sums stay below 32 x 16 x 2^21 = 2^30) and equal the JAX f32
// block sums, which stay below 2^24.  The RD choice
// is f32 in the JAX expression's order as XLA's CPU backend evaluates it:
// cost(h) = cnt h^2 - 2 h (sign E) + lam (h + 1) for h = 0..7, whose last
// product and sum XLA fuses into one multiply-add for the edge categories
// and not for the bands; cnt h^2 - 2 h (sign E) is an exact integer below
// 2^24 in f32, exact in any order.  The file is built with
// --fmad=false, so the one fused multiply-add is the explicit __fmaf_rn.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;
// a lane's counters: 16 edge (class k, category c) at 4 k + c - 1, 32
// bands from kBand0, the discard counter
constexpr int kBand0 = 16;
constexpr int kStats = 48;
constexpr int kDiscard = 48;
constexpr int kCounters = 49;

struct Plane {
  const int32_t* orig;
  const int32_t* rec;  // null: the plane is not analysed
  int h, w, c;         // size and CTU side
};

struct Args {
  Plane pl[3];         // luma, cb, cr
  const float* lam;
  int n, ctus_x;
  int32_t* rows_y;     // [n, 12] or null
  float* gain;         // [n] or null
  int32_t* rows_c;     // [n, 12] or null
};

// the RD choices of one plane
struct PlaneRd {
  float dist[4];       // summed category cost per edge class
  int eo_off[16];      // [class][category] signed offsets
  float win_min;       // best 4-band window cost
  int pos;             // its first band
  int bo_off[4];
};

// P ints (2 or 4) from one 8- or 16-byte load
template <int P>
__device__ __forceinline__ void ldv(const int32_t* src, int* v) {
  if constexpr (P == 2) {
    const int2 x = __ldg(reinterpret_cast<const int2*>(src));
    v[0] = x.x, v[1] = x.y;
  } else {
    const int4 x = __ldg(reinterpret_cast<const int4*>(src));
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  }
}

// r[0..P+1]: columns x0 - 1 .. x0 + P of row y (0 outside the picture)
template <int P>
__device__ __forceinline__ void load_row(const Plane& pl, int y, int x0,
                                         int* r) {
  if (y < 0 || y >= pl.h) {
#pragma unroll
    for (int q = 0; q < P + 2; ++q) r[q] = 0;
    return;
  }
  const int32_t* row = pl.rec + (size_t)y * pl.w;
  ldv<P>(row + x0, r + 1);
  r[0] = x0 > 0 ? __ldg(row + x0 - 1) : 0;
  r[P + 1] = x0 + P < pl.w ? __ldg(row + x0 + P) : 0;
}

// counter of edge index 2 + sgn + sgn (0..4) of class k: categories 1, 2,
// 0 (the discard counter), 3, 4; as __byte_perm tables, the low byte
// picked by the index, the others by a 5, a zero byte
__host__ __device__ constexpr unsigned row_lo(int k) {
  return (unsigned)(4 * k) | (unsigned)(4 * k + 1) << 8 |
         (unsigned)kDiscard << 16 | (unsigned)(4 * k + 2) << 24;
}
__host__ __device__ constexpr unsigned row_hi(int k) {
  return (unsigned)(4 * k + 3);
}

__device__ __forceinline__ int sgn(int v) { return min(max(v, -1), 1); }

// a lane's step: it classifies the P adjacent samples of plane pl from
// (y, x0) and adds them into its counters hcol[32 * counter].  A sample's
// five counters differ (class k's are 4 k .. 4 k + 3, the bands from 16)
// except where classes share the discard counter, whose value is never
// read: so its five loads go out before its five stores, not one
// read-modify-write after another.
template <int P>
__device__ __forceinline__ void accumulate(const Plane& pl, int y, int x0,
                                           int* hcol) {
  int U[P + 2], C[P + 2], D[P + 2], o[P];
  load_row<P>(pl, y - 1, x0, U);
  load_row<P>(pl, y, x0, C);
  load_row<P>(pl, y + 1, x0, D);
  ldv<P>(pl.orig + (size_t)y * pl.w + x0, o);
  const bool vert = y > 0 && y + 1 < pl.h;
  int hs[P + 1];            // sgn of each step along the row, shared
#pragma unroll
  for (int j = 0; j <= P; ++j) hs[j] = sgn(C[j + 1] - C[j]);
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const int v = C[q + 1];
    const int pk = (1 << 20) + (o[q] - v);
    const bool horz = x0 + q > 0 && x0 + q + 1 < pl.w;
    // (class, first neighbour, second neighbour, both in the picture); class
    // 0 from the row's steps
    const int a[4] = {0, U[q + 1], U[q], U[q + 2]};
    const int b[4] = {0, D[q + 1], D[q + 2], D[q]};
    const bool ok[4] = {horz, vert, horz && vert, horz && vert};
    int* cnt[5];
    int val[5];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int sel = 0x5552 + (k ? sgn(v - a[k]) + sgn(v - b[k])
                                  : hs[q] - hs[q + 1]);
      cnt[k] = hcol + 32 * (ok[k] ? (int)__byte_perm(row_lo(k), row_hi(k),
                                                      sel)
                                  : kDiscard);
    }
    cnt[4] = hcol + 32 * (kBand0 + (v >> 3));
#pragma unroll
    for (int k = 0; k < 5; ++k) val[k] = *cnt[k];
#pragma unroll
    for (int k = 0; k < 5; ++k) *cnt[k] = val[k] + pk;
  }
}

// a warp's counters zeroed by 16-byte stores
__device__ __forceinline__ void zero_counters(int* hist, int lane) {
  int4* z = reinterpret_cast<int4*>(hist);
  for (int i = lane; i < 8 * kCounters; i += 32) z[i] = make_int4(0, 0, 0, 0);
}

// a warp's counters summed over its lanes into the CTU's totals: lane l
// sums counter l from 8 16-byte pieces, lanes 0-15 and 16-31 apart, and
// the half of counter 32 + l / 2 that its parity names from 4, the
// pieces' order rotated by the counter so that the 32 lanes' loads hit
// each bank at most 4 times (4 wavefronts, as any 512-byte load takes).
// Lanes 0-15 add into tot_lo, lanes 16-31 into tot_hi (the same plane's,
// or cb's and cr's when they share a step).  The counters are not zeroed
// between planes: a plane's totals are the differences of the sums from
// the sums after the plane before, which a lane keeps (prev).
__device__ __forceinline__ void flush(const int* hist, int lane, int* tot_lo,
                                      int* tot_hi, int (&prev)[3]) {
  const int4* h4 = reinterpret_cast<const int4*>(hist);
  int lo = 0, hi = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int piece = (j + lane) & 7;
    const int4 x = h4[8 * lane + piece];
    const int v = x.x + x.y + x.z + x.w;
    lo += piece < 4 ? v : 0;
    hi += piece < 4 ? 0 : v;
  }
  const int r2 = 32 + (lane >> 1), half = lane & 1;
  int s2 = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int4 x = h4[8 * r2 + 4 * half + ((j + r2) & 3)];
    s2 += x.x + x.y + x.z + x.w;
  }
  atomicAdd(tot_lo + lane, lo - prev[0]);
  atomicAdd(tot_hi + lane, hi - prev[1]);
  atomicAdd((half ? tot_hi : tot_lo) + r2, s2 - prev[2]);
  prev[0] = lo;
  prev[1] = hi;
  prev[2] = s2;
}

// (count, error sum) of a packed total
__device__ __forceinline__ void unpack(int t, int* e, int* cnt) {
  *cnt = (t + (1 << 19)) >> 20;
  *e = t - (*cnt << 20);
}

// The offset cost cnt h^2 - 2 h (sign E) + lam (h + 1), h = 0..7, and its
// first minimum.  The f32 products cnt h^2 and 2 h (sign E) are exact
// integers below 2^24 (cnt <= 1024, |E| < 2^19), and so are their sum and
// difference, in any order; the edge categories add lam (h + 1) fused,
// the bands add the rounded product.

// one edge category's best signed offset and its cost
__device__ __forceinline__ float best_eo(int e, int cnt, int sign, float lam,
                                         int* off) {
  const float cf = (float)cnt, es = (float)(e * sign);
  float best = 0.0f;
  int bk = 0;
#pragma unroll
  for (int h = 0; h < 8; ++h) {
    const float ab = __fmaf_rn(es, (float)(-2 * h),
                               __fmul_rn(cf, (float)(h * h)));
    const float d = __fmaf_rn(lam, (float)(h + 1), ab);
    if (h == 0 || d < best) {
      best = d;
      bk = h;
    }
  }
  *off = bk * sign;
  return best;
}

// one band's best offset at either sign (the negative sign's on a tie
// only where strictly cheaper) and its cost
__device__ __forceinline__ float best_band(int e, int cnt, float lam,
                                           int* off) {
  const float cf = (float)cnt, ef = (float)e;
  float dp = 0.0f, dn = 0.0f;
  int hp = 0, hn = 0;
#pragma unroll
  for (int h = 0; h < 8; ++h) {
    const float lk = __fmul_rn(lam, (float)(h + 1));
    const float a = __fmul_rn(cf, (float)(h * h));
    const float b = __fmul_rn(ef, (float)(2 * h));
    const float fp = __fadd_rn(__fsub_rn(a, b), lk);
    const float fn = __fadd_rn(__fadd_rn(a, b), lk);
    if (h == 0 || fp < dp) {
      dp = fp;
      hp = h;
    }
    if (h == 0 || fn < dn) {
      dn = fn;
      hn = h;
    }
  }
  *off = dn < dp ? -hn : hp;
  return dn < dp ? dn : dp;
}

// one plane's RD choices from its totals, on one warp
__device__ __forceinline__ void plane_rd(const int* tot, float lam, int lane,
                                         PlaneRd* r) {
  int e, cnt;
  unpack(tot[kBand0 + lane], &e, &cnt);        // band lane
  int ob;
  const float db = best_band(e, cnt, lam, &ob);
  float eo_cost = 0.0f;
  int eo_off = 0;
  if (lane < 16) {                 // edge class lane >> 2, category lane & 3
    unpack(tot[lane], &e, &cnt);
    eo_cost = best_eo(e, cnt, (lane & 3) <= 1 ? 1 : -1, lam, &eo_off);
  }
  // the class's category costs added in order
  float dist = 0.0f;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    dist = __fadd_rn(dist, __shfl_sync(kFull, eo_cost, (lane & 12) + c));
  // band windows, the first minimum
  float w = __fadd_rn(
      __fadd_rn(__fadd_rn(db, __shfl_down_sync(kFull, db, 1)),
                __shfl_down_sync(kFull, db, 2)),
      __shfl_down_sync(kFull, db, 3));
  if (lane >= 29) w = INFINITY;
  int pos = lane;
#pragma unroll
  for (int m = 16; m; m >>= 1) {
    const float ow = __shfl_xor_sync(kFull, w, m);
    const int op_ = __shfl_xor_sync(kFull, pos, m);
    if (ow < w || (ow == w && op_ < pos)) {
      w = ow;
      pos = op_;
    }
  }
  const int bo = __shfl_sync(kFull, ob, (pos + (lane & 3)) & 31);
  if (lane < 16) r->eo_off[lane] = eo_off;
  if (lane < 16 && (lane & 3) == 0) r->dist[lane >> 2] = dist;
  if (lane < 4) r->bo_off[lane] = bo;
  if (lane == 0) {
    r->win_min = w;
    r->pos = pos;
  }
}

// the type and class choice of one plane (luma), or of cb (a) and cr (b)
__device__ __forceinline__ void write_rows(const PlaneRd& a, const PlaneRd* b,
                                           float lam, int32_t* row,
                                           float* gain) {
  float eo[4];
  float bo;
  if (b) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      eo[k] = __fadd_rn(__fadd_rn(a.dist[k], b->dist[k]),
                        __fmul_rn(lam, 10.0f));
    bo = __fadd_rn(__fadd_rn(a.win_min, b->win_min), __fmul_rn(lam, 16.0f));
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      eo[k] = __fadd_rn(a.dist[k], __fmul_rn(lam, 5.0f));
    bo = __fadd_rn(a.win_min, __fmul_rn(lam, 8.0f));
  }
  int cls = 0;
  float eo_best = eo[0];
#pragma unroll
  for (int k = 1; k < 4; ++k)
    if (eo[k] < eo_best) {
      cls = k;
      eo_best = eo[k];
    }
  const float off_d = __fmul_rn(lam, 1.0f);
  int type = 0;
  float best = off_d;
  if (bo < best) {
    type = 1;
    best = bo;
  }
  if (eo_best < best) {
    type = 2;
    best = eo_best;
  }
  row[0] = type;
  row[1] = cls;
  row[2] = a.pos;
  for (int k = 0; k < 4; ++k)
    row[3 + k] = type == 1 ? a.bo_off[k]
                           : (type == 2 ? a.eo_off[4 * cls + k] : 0);
  if (b) {
    row[7] = b->pos;
    for (int k = 0; k < 4; ++k)
      row[8 + k] = type == 1 ? b->bo_off[k]
                             : (type == 2 ? b->eo_off[4 * cls + k] : 0);
    if (gain) *gain = 0.0f;
  } else {
    for (int k = 7; k < 12; ++k) row[k] = 0;
    *gain = __fsub_rn(off_d, best);
  }
}

// G warps a CTU (1 or 4)
template <int G>
__global__ void __launch_bounds__(kThreads) sao_kernel(const Args a) {
  constexpr int CPC = kWarps / G;   // CTUs a CTA
  __shared__ __align__(16) int hist[kWarps][kCounters * 32];
  __shared__ int tot[CPC][3][kStats];
  __shared__ PlaneRd rd[CPC][3];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = warp / G, wg = warp % G;
  const int ci = blockIdx.x * CPC + grp;
  const bool valid = ci < a.n;
  zero_counters(hist[warp], lane);
  for (int i = 32 * wg + lane; i < 3 * kStats; i += 32 * G)
    (&tot[grp][0][0])[i] = 0;
  __syncthreads();
  const int cy = ci / a.ctus_x, cx = ci % a.ctus_x;
  if (valid) {
    int base = 0;                   // the planes' steps, dealt in turn
    int prev[3] = {0, 0, 0};        // the sums after the plane before
    int* hcol = &hist[warp][lane];
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      const Plane& pl = a.pl[p];
      if (pl.rec == nullptr) continue;
      if (p == 1 && pl.c == 8) {
        // cb and cr of side 8 share one step: lanes 0-15 take cb, 16-31
        // cr, 4 adjacent samples each, and one flush sums the halves apart
        if (base % G == wg) {
          const bool cb = lane < 16;
          const Plane pc{cb ? a.pl[1].orig : a.pl[2].orig,
                         cb ? a.pl[1].rec : a.pl[2].rec, pl.h, pl.w, 8};
          accumulate<4>(pc, cy * 8 + ((lane & 15) >> 1),
                        cx * 8 + (lane & 1) * 4, hcol);
          __syncwarp();
          flush(hist[warp], lane, tot[grp][1], tot[grp][2], prev);
          __syncwarp();
        }
        break;
      }
      // P adjacent samples a lane, 2^lg lanes a row, 32 / 2^lg rows a step
      const int P = pl.c == 8 ? 2 : 4;
      const int lg = 31 - __clz(pl.c / P);
      const int steps = pl.c * pl.c / (32 * P);
      const int s0 = ((wg - base) % G + G) % G;
      for (int s = s0; s < steps; s += G) {
        const int y = cy * pl.c + (s << (5 - lg)) + (lane >> lg);
        const int x0 = cx * pl.c + (lane & ((1 << lg) - 1)) * P;
        if (P == 2)
          accumulate<2>(pl, y, x0, hcol);
        else
          accumulate<4>(pl, y, x0, hcol);
      }
      base += steps;
      if (s0 < steps) {
        __syncwarp();
        flush(hist[warp], lane, tot[grp][p], tot[grp][p], prev);
        __syncwarp();
      }
    }
  }
  __syncthreads();
  const float lam = valid ? a.lam[ci] : 0.0f;
#pragma unroll
  for (int p = 0; p < 3; ++p)
    if (valid && a.pl[p].rec != nullptr && p % G == wg)
      plane_rd(tot[grp][p], lam, lane, &rd[grp][p]);
  __syncthreads();
  if (!valid || wg != 0) return;
  if (lane == 0 && a.pl[0].rec != nullptr)
    write_rows(rd[grp][0], nullptr, lam, a.rows_y + 12 * ci, a.gain + ci);
  if (lane == 1 && a.pl[1].rec != nullptr)
    write_rows(rd[grp][1], &rd[grp][2], lam, a.rows_c + 12 * ci,
               a.pl[0].rec == nullptr && a.gain ? a.gain + ci : nullptr);
}

bool aligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

int launch(const Args& a, cudaStream_t stream) {
  int side = 0;
  for (const Plane& pl : a.pl) {
    if (pl.rec == nullptr) continue;
    if ((pl.c != 8 && pl.c != 16 && pl.c != 32) || pl.h % pl.c ||
        pl.w % pl.c || !aligned(pl.orig) || !aligned(pl.rec) ||
        (pl.h / pl.c) * (pl.w / pl.c) != a.n || pl.w / pl.c != a.ctus_x)
      return (int)cudaErrorInvalidValue;
    if (pl.c > side) side = pl.c;
  }
  if (a.n <= 0) return (int)cudaSuccess;
  if (side == 32)
    sao_kernel<4><<<a.n, kThreads, 0, stream>>>(a);
  else
    sao_kernel<1><<<(a.n + kWarps - 1) / kWarps, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sao_analyse(const int32_t* orig_a, const int32_t* rec_a,
                           const int32_t* orig_b, const int32_t* rec_b,
                           int H, int W, int ctu, int two, const float* lam,
                           int32_t* rows, float* gain, cudaStream_t stream) {
  if (ctu <= 0) return (int)cudaErrorInvalidValue;
  Args a{};
  const Plane pa{orig_a, rec_a, H, W, ctu};
  if (two) {
    a.pl[1] = pa;
    a.pl[2] = Plane{orig_b, rec_b, H, W, ctu};
    a.rows_c = rows;
  } else {
    a.pl[0] = pa;
    a.rows_y = rows;
  }
  a.lam = lam;
  a.gain = gain;
  a.n = (H / ctu) * (W / ctu);
  a.ctus_x = W / ctu;
  return launch(a, stream);
}

extern "C" int sao_analyse_frame(const int32_t* oy, const int32_t* ry, int H,
                                 int W, int ctu, const int32_t* ocb,
                                 const int32_t* rcb, const int32_t* ocr,
                                 const int32_t* rcr, const float* lam,
                                 int32_t* rows_y, float* gain,
                                 int32_t* rows_c, cudaStream_t stream) {
  if (ctu != 16 && ctu != 32) return (int)cudaErrorInvalidValue;
  Args a{};
  a.pl[0] = Plane{oy, ry, H, W, ctu};
  a.pl[1] = Plane{ocb, rcb, H / 2, W / 2, ctu / 2};
  a.pl[2] = Plane{ocr, rcr, H / 2, W / 2, ctu / 2};
  a.lam = lam;
  a.n = (H / ctu) * (W / ctu);
  a.ctus_x = W / ctu;
  a.rows_y = rows_y;
  a.gain = gain;
  a.rows_c = rows_c;
  return launch(a, stream);
}
