// Kernel K10 `sao_analyse`: per-CTU SAO statistics and the RD choice of
// the SAO parameters, for luma (one plane) or jointly for cb and cr (two
// planes that share the type and the edge class).
//
// Replaces, from the JAX package: ops/sao.py sao_analyse (:75) and
// sao_analyse_chroma (:257), with their _eo_cat_map (:42), _block_sum and
// _block_sum3 statistics.
//
// Entry point (plain C, caller's stream, returns cudaGetLastError()):
//   sao_analyse(orig_a, rec_a, orig_b, rec_b [H,W] i32, H, W, ctu, two,
//               lam [n] f32, rows [n,12] i32, gain [n] f32)
// two = 0: one plane (a); rows are (type, eo_class, band_pos, offsets[4],
// 0...) and gain the cost of "off" less the chosen cost.  two = 1: cb (a)
// and cr (b); rows are (type, eo_class, band_pos_a, offsets_a[4],
// band_pos_b, offsets_b[4]) and gain is 0.
//
// What bounds it on an H100: bytes (two int32 planes read once, plus the
// neighbours from L1); the RD choice is a few hundred flops per CTU.  One
// block per CTU.  Its threads classify the CTU's samples against the
// deblocked (pre-SAO) plane for the 4 edge classes (a neighbour outside
// the picture gives category 0) and the 32 bands, and add (orig - rec) and
// the count per category and band into shared int32 counters: exact, and
// equal to the JAX f32 block sums, which stay below 2^24.  Then one thread
// runs the RD choice in f32 in the JAX expression's order as XLA's CPU
// backend evaluates it: cost(h) = cnt h^2 - 2 h (sign E) + lam (h + 1) for
// h = 0..7, whose last product and sum XLA fuses into one multiply-add for
// the edge categories and not for the bands; the four category costs added
// in order; band windows summed ((d0 + d1) + d2) + d3; first minima.  The
// file is built with --fmad=false, so the one fused multiply-add is the
// explicit __fmaf_rn.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__constant__ int kNb[4][4] = {{0, -1, 0, 1}, {-1, 0, 1, 0},
                              {-1, -1, 1, 1}, {-1, 1, 1, -1}};

__device__ __forceinline__ int sgn(int v) { return (v > 0) - (v < 0); }

struct Stats {
  int eo_e[4][4];   // [class][category 1..4]
  int eo_c[4][4];
  int bo_e[32];
  int bo_c[32];
};

struct PlaneRd {
  float dist[4];      // summed category cost per edge class
  int eo_off[4][4];   // [class][category] signed offsets
  float win_min;      // best 4-band window cost
  int pos;            // its first band
  int bo_off[4];
};

__device__ void accumulate(const int32_t* __restrict__ orig,
                           const int32_t* __restrict__ rec, int H, int W,
                           int ctu, int cy, int cx, Stats* s) {
  const int n = ctu * ctu;
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    const int y = cy * ctu + p / ctu, x = cx * ctu + p % ctu;
    const int v = rec[(size_t)y * W + x];
    const int d = orig[(size_t)y * W + x] - v;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int y0 = y + kNb[k][0], x0 = x + kNb[k][1];
      const int y1 = y + kNb[k][2], x1 = x + kNb[k][3];
      if (y0 < 0 || y0 >= H || x0 < 0 || x0 >= W || y1 < 0 || y1 >= H ||
          x1 < 0 || x1 >= W)
        continue;
      const int edge = 2 + sgn(v - rec[(size_t)y0 * W + x0]) +
                       sgn(v - rec[(size_t)y1 * W + x1]);
      const int cat = edge == 2 ? 0 : (edge < 2 ? edge + 1 : edge);
      if (cat) {
        atomicAdd(&s->eo_e[k][cat - 1], d);
        atomicAdd(&s->eo_c[k][cat - 1], 1);
      }
    }
    atomicAdd(&s->bo_e[v >> 3], d);
    atomicAdd(&s->bo_c[v >> 3], 1);
  }
}

// min over h = 0..7 of cnt h^2 - 2 h (sign E) + lam (h + 1); returns the
// cost, writes the signed offset (the first minimum).
__device__ float best_offset(int e, int cnt, int sign, float lam, bool fused,
                             int* off) {
  const float es = __fmul_rn((float)e, (float)sign);
  const float cf = (float)cnt;
  float best = 0.0f;
  int bk = 0;
  for (int h = 0; h < 8; ++h) {
    const float c = (float)h;
    const float a = __fmul_rn(cf, __fmul_rn(c, c));
    const float b = __fmul_rn(__fmul_rn(2.0f, c), es);
    const float ab = __fsub_rn(a, b);
    const float k = __fadd_rn(c, 1.0f);
    const float d = fused ? __fmaf_rn(lam, k, ab)
                          : __fadd_rn(ab, __fmul_rn(lam, k));
    if (h == 0 || d < best) {
      best = d;
      bk = h;
    }
  }
  *off = bk * sign;
  return best;
}

__device__ void plane_rd(const Stats& s, float lam, PlaneRd* r) {
  for (int k = 0; k < 4; ++k) {
    float dist = 0.0f;
    for (int c = 0; c < 4; ++c)
      dist = __fadd_rn(dist, best_offset(s.eo_e[k][c], s.eo_c[k][c],
                                         c <= 1 ? 1 : -1, lam, true,
                                         &r->eo_off[k][c]));
    r->dist[k] = dist;
  }
  float db[32];
  int ob[32];
  for (int j = 0; j < 32; ++j) {
    int op, on;
    const float dp = best_offset(s.bo_e[j], s.bo_c[j], 1, lam, false, &op);
    const float dn = best_offset(s.bo_e[j], s.bo_c[j], -1, lam, false, &on);
    ob[j] = dn < dp ? on : op;
    db[j] = dn < dp ? dn : dp;
  }
  float wmin = 0.0f;
  int pos = 0;
  for (int p = 0; p < 29; ++p) {
    const float w =
        __fadd_rn(__fadd_rn(__fadd_rn(db[p], db[p + 1]), db[p + 2]),
                  db[p + 3]);
    if (p == 0 || w < wmin) {
      wmin = w;
      pos = p;
    }
  }
  r->win_min = wmin;
  r->pos = pos;
  for (int k = 0; k < 4; ++k) r->bo_off[k] = ob[pos + k];
}

__global__ void sao_analyse_kernel(const int32_t* __restrict__ orig_a,
                                   const int32_t* __restrict__ rec_a,
                                   const int32_t* __restrict__ orig_b,
                                   const int32_t* __restrict__ rec_b, int H,
                                   int W, int ctu, int two,
                                   const float* __restrict__ lam_arr,
                                   int32_t* __restrict__ rows,
                                   float* __restrict__ gain) {
  __shared__ Stats st[2];
  const int ci = blockIdx.x;
  const int wc = W / ctu;
  const int cy = ci / wc, cx = ci % wc;
  int* flat = &st[0].eo_e[0][0];
  for (int i = threadIdx.x; i < (int)(2 * sizeof(Stats) / sizeof(int));
       i += blockDim.x)
    flat[i] = 0;
  __syncthreads();
  accumulate(orig_a, rec_a, H, W, ctu, cy, cx, &st[0]);
  if (two) accumulate(orig_b, rec_b, H, W, ctu, cy, cx, &st[1]);
  __syncthreads();
  if (threadIdx.x != 0) return;
  const float lam = lam_arr[ci];
  int32_t* row = rows + 12 * ci;
  PlaneRd a, b;
  plane_rd(st[0], lam, &a);
  float eo[4];
  float bo;
  if (two) {
    plane_rd(st[1], lam, &b);
    for (int k = 0; k < 4; ++k)
      eo[k] = __fadd_rn(__fadd_rn(a.dist[k], b.dist[k]),
                        __fmul_rn(lam, 10.0f));
    bo = __fadd_rn(__fadd_rn(a.win_min, b.win_min), __fmul_rn(lam, 16.0f));
  } else {
    for (int k = 0; k < 4; ++k)
      eo[k] = __fadd_rn(a.dist[k], __fmul_rn(lam, 5.0f));
    bo = __fadd_rn(a.win_min, __fmul_rn(lam, 8.0f));
  }
  int cls = 0;
  for (int k = 1; k < 4; ++k)
    if (eo[k] < eo[cls]) cls = k;
  const float off_d = __fmul_rn(lam, 1.0f);
  int type = 0;
  float best = off_d;
  if (bo < best) {
    type = 1;
    best = bo;
  }
  if (eo[cls] < best) {
    type = 2;
    best = eo[cls];
  }
  row[0] = type;
  row[1] = cls;
  row[2] = a.pos;
  for (int k = 0; k < 4; ++k)
    row[3 + k] = type == 1 ? a.bo_off[k] : (type == 2 ? a.eo_off[cls][k] : 0);
  if (two) {
    row[7] = b.pos;
    for (int k = 0; k < 4; ++k)
      row[8 + k] =
          type == 1 ? b.bo_off[k] : (type == 2 ? b.eo_off[cls][k] : 0);
    gain[ci] = 0.0f;
  } else {
    for (int k = 7; k < 12; ++k) row[k] = 0;
    gain[ci] = __fsub_rn(off_d, best);
  }
}

}  // namespace

extern "C" int sao_analyse(const int32_t* orig_a, const int32_t* rec_a,
                           const int32_t* orig_b, const int32_t* rec_b,
                           int H, int W, int ctu, int two, const float* lam,
                           int32_t* rows, float* gain, cudaStream_t stream) {
  if (ctu <= 0 || H % ctu || W % ctu) return (int)cudaErrorInvalidValue;
  const int n = (H / ctu) * (W / ctu);
  sao_analyse_kernel<<<n, kThreads, 0, stream>>>(
      orig_a, rec_a, orig_b, rec_b, H, W, ctu, two, lam, rows, gain);
  return (int)cudaGetLastError();
}
