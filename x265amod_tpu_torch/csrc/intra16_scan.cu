// Kernel K23 `intra16_scan`: the flat CTB16 all-intra wavefront scan, for a
// batch of F frames: per CTU16 the 35-mode RD decision on true
// reconstructed references, the chosen mode's luma and DM chroma coding,
// and the reconstruction the next CTUs predict from.  Also the commit scan
// of the flat P and B frames: given per-CTU kinds, only the intra CTUs
// (kind 2) are coded.
//
// Replaces, from the JAX package: models/intra_frame.py, the scan body of
// `_encode_frame` (:183-234, `lax.scan` at :236); and the commit scans of
// models/inter_frame.py (:394-458, `lax.scan` at :457) and
// models/b_frame.py (:489-548, :547), whose inter cells the wrapper has
// already written (their recon and levels, mode 1, so that a left inter
// neighbour reads as mode 1: JAX `left_intra` :403-405) and whose rates
// read the P or B rows of the tu_bits table.  Per CTU:
//   - the raw neighbours from the recon planes (:144-155) with the flat
//     grid's availability (left iff cx > 0, top iff cy > 0, top-right iff
//     also cx < wc - 1, below-left never), the spec 8.4.4.2.2 substitution
//     and the [1 2 1] smoothing, and all 35 luma predictions (the
//     prediction arithmetic of intra_chain.cuh, a row at a time:
//     `pred_rows`);
//   - for every mode the residual chain: forward DCT, quant (intra
//     rounding), sign-bit hiding, dequant, inverse DCT, clip (K2's group
//     chain, chain_lanes.cuh), the SSD, and the rate `tu_bits` at the
//     slice type's states (tu_bits.cuh);
//     lossless: levels = residual, recon = source, SSD 0 (:165-172);
//   - the MPM bins from the left CTU's mode only (:202-210), the cost
//     fma(lam, rbits + mbits, ssd) (XLA's vfmadd231ss in the argmin
//     fusion), and the first minimum (jnp.argmin);
//   - the two chroma chains at the chosen mode (DM, 8x8, c_idx 1), K2's
//     group chain;
//   - the levels into raster cells [F, hc, wc, 16, 16] / [.., 8, 8], the
//     mode into [F, hc, wc] (the next CTU's left mode), the recon into the
//     raster planes, which the later CTUs read.
//
// Design: two launches a call.  The first (one thread block) writes the
// ticket list: every CTU to code (all, or the kind-2 CTUs of a P/B
// commit, compacted from the kinds on the device) in wavefront order (the
// anti-diagonal d = cx + 2 cy, then the frame, then cy), and zeroes the
// done flags.  The second is persistent: as many clusters as fit take
// tickets from a global counter (atomicAdd), one CTU a ticket.  A CTU
// spins (acquire loads) on the done flags of its left, top-left, top and
// top-right neighbours among the coded CTUs (a P/B commit's inter CTUs
// are written before the call) and publishes its own (release) once its
// recon, levels and mode are out: luma, Cb and Cr each have their own flag,
// so a CTU's luma never waits on its neighbours' chroma.  Every CTU a
// ticket waits on holds a smaller ticket, taken by a cluster that is
// already running, so the scan cannot deadlock at any occupancy.  The
// frames of a batch run side by side, and the critical path is the
// longest chain of dependent CTUs: 254 at 1920x1088, fewer in a commit
// whose intra CTUs are scattered.
//
// A CTU is a cluster of 5 CTAs of 128 threads.  Each CTA codes 7 of the
// 35 modes, one mode per 16 lanes (the group chain's layout, lane = line),
// in its own shared memory (about 22 KB): its prediction, chain, SSD and
// rate (the rate's counts summed by warp reductions).  5 x 7 rather than 7 x 5: 7 modes x 16 lanes fill a CTA's 4 warps
// (one per scheduler of an SM), so a stage takes as long as with 5 modes,
// while the CTU takes 5 SMs' slots instead of 7 and its barrier spans 5
// CTAs.  The 35 costs meet through distributed shared memory after a
// cluster barrier; warp 0 of every CTA takes the first minimum (lowest
// mode on a tie); the CTA that holds the winner writes the luma recon,
// levels and mode and publishes; then CTAs 3 and 4 code Cb and Cr at the
// same time (8 lanes each).  Each CTA reads its references itself (warp 0:
// the available samples through L2, a ballot-based substitution, the
// smoothing and the DC value).  Lossless is a template parameter.  Built
// with --fmad=false: the cost's only FMA is written out.
//
// What bounds it on an H100: the latency of one CTU's chain of dependent
// stages times the longest chain of CTUs, far above its bytes and its
// integer operations.  Per CTU at 1920x1088 on an H100 SXM (700 W) about
// 11 us from its last neighbour's flag to its own (`ScanArgs.trace` takes
// the stamps; profile_port.py reads them): the hand-off 0.4, the
// references 0.9, the 7 modes of a CTA 7.6, the cluster barrier and the
// decision 1.7, the luma write and release 0.7.
//
// Entry point (plain C, caller's stream, returns cudaGetLastError() and the
// number of launches it enqueued in *launches):
//   intra16_scan(const ScanArgs* args, int* launches, cudaStream_t)

#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "chain_lanes.cuh"
#include "tu_bits.cuh"

extern "C" {
struct ScanArgs {
  // batch and geometry (luma plane W x H, CTB16 grid wc x hc)
  int F, W, H, wc, hc;
  int sbh, lossless;
  // source planes [F, H, W] and [F, H/2, W/2]
  const int32_t *src_y, *src_cb, *src_cr;
  // recon planes, read as references and written
  int32_t *rec_y, *rec_cb, *rec_cr;
  // levels [F, hc, wc, 16, 16] and [F, hc, wc, 8, 8]
  int16_t *ly, *lcb, *lcr;
  // chosen luma mode per CTU [F, hc, wc]
  int32_t* modes;
  // per-CTU QP, chroma QP and lambda [hc, wc] (shared by the batch)
  const int32_t *qp, *qpc;
  const float* lam;
  // tu_bits table [52 * 13] f32: luma rows at the slice type's states
  const float* bits;
  // per-CTU kinds [F, hc, wc] (2 = intra), or null: every CTU is intra
  const int32_t* kinds;
  // scratch (any contents): the ticket list [2 + F hc wc] (count, next
  // ticket, CTU indices in wavefront order) and the done flags [3, F hc
  // wc] (luma, Cb, Cr)
  int32_t *sched, *flags;
  // null, or [F hc wc, 12] global-timer stamps (ns) per CTU: ticket taken,
  // luma neighbours acquired, references read, costs out, decision, luma
  // published, Cb neighbours acquired, Cb published (thread 0 of a CTA);
  // then, for the last mode group of the first CTA (mode 6), prediction,
  // chain, rate counts and cost done
  uint64_t* trace;
};
}

namespace {

namespace cg = cooperative_groups;
using namespace chain_lanes;

constexpr int kModes = 35;
constexpr int kCluster = 5;                 // CTAs a CTU
constexpr int kPerCta = 7;                  // modes a CTA
constexpr int kN = 16, kP = kN + 1;
constexpr int kThreads = 128;               // 7 modes x 16 lanes (+ 16)
constexpr int kCb = kCluster - 2, kCr = kCluster - 1;   // chroma CTAs
constexpr int kListThreads = 1024;
static_assert(kCluster * kPerCta == kModes, "35 modes over the cluster");
static_assert(kPerCta * kN <= kThreads, "a group of 16 lanes a mode");

struct Smem {
  int s[4 * kN + 1], f[4 * kN + 1];     // luma references
  int cs[33], cf[33];                   // chroma references
  int orig[kN * kP];                    // the source block, padded rows
  int corig[8 * 9];
  int S[kPerCta][kN * kP];              // each mode's tile
  int CS[8 * 9];                        // the chroma tile
  int16_t Pm[kPerCta][kN * kN];         // predictions
  int16_t L[kPerCta][kN * kN];          // levels
  int16_t Rc[kPerCta][kN * kN];         // reconstructions
  int line[kPerCta][3 * kN + 2];        // each mode's reference line
  int cline[3 * 8 + 2];
  float cost[kPerCta];
  int ticket, best, dc, cdc;
};

struct Avail {
  bool t0, t1, l0, c;
};

__device__ __forceinline__ int ld_acquire(const int32_t* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int32_t* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}


__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

constexpr int kStamps = 12;

// Stamp k of CTU id by thread t of the calling CTA, when tracing.
__device__ __forceinline__ void stamp(const ScanArgs& a, size_t id, int k,
                                      int t = 0) {
  if (a.trace != nullptr && (int)threadIdx.x == t)
    a.trace[id * kStamps + k] = global_ns();
}

// Lanes 0-3 wait, one each, until the coded ones among the left,
// top-left, top and top-right neighbours of CTU (cx, cy) of frame fi have
// set their flag in fl; then the whole CTA goes on.  A flag that stays
// unset for 10 s can only be a fault (a whole 1080p frame takes
// milliseconds): the kernel traps, and the call reports a launch failure
// instead of hanging.
__device__ void wait_neighbours(const ScanArgs& a, const int32_t* fl,
                                int fi, int cx, int cy) {
  const int t = threadIdx.x;
  if (t < 4) {
    const int x = cx + (t == 3) - (t < 2), y = cy - (t > 0);
    const size_t i = (size_t)fi * a.wc * a.hc + (size_t)y * a.wc + x;
    // the neighbour exists and is coded in this call (a P/B commit's
    // inter CTUs are written before it)
    if (x >= 0 && x < a.wc && y >= 0 &&
        (a.kinds == nullptr || a.kinds[i] == 2) && ld_acquire(fl + i) == 0) {
      const unsigned long long t0 = global_ns();
      while (ld_acquire(fl + i) == 0) {
        __nanosleep(32);
        if (global_ns() - t0 > 10000000000ull) __trap();
      }
    }
  }
  __syncthreads();
}

// The CTA's writes so far are visible to whoever acquires *flag: the
// barrier orders them before thread 0's release.
__device__ __forceinline__ void publish(int32_t* flag) {
  __syncthreads();
  if (threadIdx.x == 0) st_release(flag, 1);
}

// Warp 0: the reference scan of the n x n block at (x0, y0) of plane rec
// (row stride pw): left[2n-1 .. 0], corner, top[0 .. 2n-1].  Only the
// available samples are read (through L2: other SMs wrote them), then the
// spec 8.4.4.2.2 substitution (an unavailable sample takes the nearest
// available one before it in the scan, a leading run the first available
// one, nothing available 1 << 7), the [1 2 1] smoothing into f, and the
// DC value of the substituted scan, returned in every lane.
__device__ int warp_refs(const int32_t* rec, int pw, int x0, int y0, int n,
                         int log2n, const Avail& av, int* s, int* f) {
  const int lane = threadIdx.x & 31;
  const int m = 4 * n + 1;
  int val[3];
  unsigned msk[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int i = lane + 32 * j;
    int x = x0 - 1, y = y0 - 1;
    bool ok;
    if (i < 2 * n) {
      const int k = 2 * n - 1 - i;
      y = y0 + k;
      ok = k < n && av.l0;
    } else if (i == 2 * n) {
      ok = av.c;
    } else {
      const int k = i - 2 * n - 1;
      x = x0 + k;
      ok = i < m && (k < n ? av.t0 : av.t1);
    }
    val[j] = ok ? __ldcg(rec + (size_t)y * pw + x) : 0;
    msk[j] = __ballot_sync(0xffffffffu, ok);
  }
  const bool any = (msk[0] | msk[1] | msk[2]) != 0u;
  const int first = msk[0] ? __ffs(msk[0]) - 1
                    : (msk[1] ? 31 + __ffs(msk[1])
                              : 63 + __ffs(msk[2]));
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    // the nearest available entry at or before i, else the first one
    const unsigned below =
        lane == 31 ? msk[j] : (msk[j] & ((2u << lane) - 1u));
    int src = -1;
    if (below) {
      src = 32 * j + 31 - __clz(below);
    } else {
#pragma unroll
      for (int jj = j - 1; jj >= 0; --jj)
        if (src < 0 && msk[jj]) src = 32 * jj + 31 - __clz(msk[jj]);
    }
    if (src < 0) src = first;
    const int v0 = __shfl_sync(0xffffffffu, val[0], src & 31);
    const int v1 = __shfl_sync(0xffffffffu, val[1], src & 31);
    const int v2 = __shfl_sync(0xffffffffu, val[2], src & 31);
    const int i = lane + 32 * j;
    if (i < m) s[i] = !any ? 128 : (src < 32 ? v0 : (src < 64 ? v1 : v2));
  }
  __syncwarp();
  int acc = 0;
  for (int i = lane; i < m; i += 32) {
    f[i] = (i == 0 || i == m - 1)
               ? s[i]
               : (s[i - 1] + 2 * s[i] + s[i + 1] + 2) >> 2;
    if (i >= n && i < 2 * n) acc += s[i];                 // left[0 .. n-1]
    if (i > 2 * n && i <= 3 * n) acc += s[i];             // top[0 .. n-1]
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  __syncwarp();
  return (acc + n) >> (log2n + 1);
}

// Row l of the N x N prediction at `mode` by lane l of a group, from
// intra_chain.cuh's parts, the mode's part chosen once for the row: an
// angular mode first lays out its reference line (line_at, i in [-N, 2N +
// 1]), a few entries a lane, then every sample is two taps of that line
// (taps_at), the edge filters of modes 10 and 26 overriding them.  line:
// the group's [3N + 2] scratch; every lane of the group (mask) must call
// it.
template <int N>
__device__ __forceinline__ void pred_rows(const RefView& r, int mode,
                                          int c_idx, int dc, int l,
                                          unsigned mask, int* line,
                                          int* out) {
  constexpr int LOG2N = N == 8 ? 3 : 4;
  const int* R = filter_flag(mode, N, c_idx) ? r.f : r.s;
  const bool edge = c_idx == 0;
  if (mode == 0) {
#pragma unroll
    for (int x = 0; x < N; ++x) out[x] = planar_at(R, N, LOG2N, l, x);
    return;
  }
  if (mode == 1) {
#pragma unroll
    for (int x = 0; x < N; ++x) out[x] = dc_at(r.s, dc, N, edge, l, x);
    return;
  }
  for (int e = l; e < 3 * N + 2; e += N)
    line[e] = line_at(R, N, mode, e - N);
  __syncwarp(mask);
  const int* L = line + N;
#pragma unroll
  for (int x = 0; x < N; ++x) {
    int v = taps_at(mode, [L](int i) { return L[i]; }, l, x);
    if (edge && mode == 26 && x == 0) v = edge26_at<8>(r.s, N, l);
    if (edge && mode == 10 && l == 0) v = edge10_at<8>(r.s, N, x);
    out[x] = v;
  }
  __syncwarp(mask);
}

// This CTA's 7 luma modes, one per 16 lanes: prediction, chain (or, lossless,
// levels = residual), rate and cost into sm.cost.
template <bool LOSSLESS>
__device__ void luma_modes(Smem& sm, const ScanArgs& a, size_t id, int rank,
                           int qp, const float* row, float lam, int left) {
  const int sbh = a.sbh;
  const int last = (kPerCta - 1) * kN;   // lane 0 of the last group
  const bool tr = rank == 0;
  const int g = threadIdx.x / kN, l = threadIdx.x % kN;
  if (g >= kPerCta) return;
  const int m = rank * kPerCta + g;
  const unsigned mask = group_mask<kN>();
  const RefView r{sm.s, sm.f, kN};
  const int dc = sm.dc;
  int16_t* pm = sm.Pm[g];
  int16_t* lv = sm.L[g];
  int ssd = 0;
  int pr[kN];
  pred_rows<kN>(r, m, 0, dc, l, mask, sm.line[g], pr);
  if (tr) stamp(a, id, 8, last);
  if (LOSSLESS) {
#pragma unroll
    for (int x = 0; x < kN; ++x)
      lv[l * kN + x] = (int16_t)(sm.orig[l * kP + x] - pr[x]);
  } else {
    int16_t* rc = sm.Rc[g];
    ssd = group_chain<kN, 8, false>(
        l, mask, sm.S[g], nullptr, qp, sbh, 1, RdoqRow{},
        [&](int y, int* v) {
#pragma unroll
          for (int x = 0; x < kN; ++x) {
            pm[y * kN + x] = (int16_t)pr[x];
            v[x] = sm.orig[y * kP + x] - pr[x];
          }
        },
        [&](int y, int* v) {
#pragma unroll
          for (int x = 0; x < kN; ++x) v[x] = pm[y * kN + x];
        },
        [&](int y, int* v) {
#pragma unroll
          for (int x = 0; x < kN; ++x) v[x] = sm.orig[y * kP + x];
        },
        [&](int u, int x, int v) { lv[u * kN + x] = (int16_t)v; },
        [&](int y, const int* rr) {
#pragma unroll
          for (int x = 0; x < kN; ++x) rc[y * kN + x] = (int16_t)rr[x];
        });
  }
  __syncwarp(mask);
  if (tr) stamp(a, id, 9, last);
  const tu_bits_dev::TuCounts cnt =
      tu_bits_dev::group_counts_lanes(lv, kN, l, mask);
  if (tr) stamp(a, id, 10, last);
  if (l == 0) {
    // MPM bins from the left CTU's mode only
    const bool small = left < 2;
    const int mpm0 = small ? 0 : left, mpm2 = small ? 26 : 0;
    const float mbits = m == mpm0 ? 2.0f
                        : (m == 1 || m == mpm2) ? 3.0f : 6.0f;
    const float rbits = tu_bits_dev::total_bits(cnt, kN, row);
    sm.cost[g] = __fmaf_rn(lam, __fadd_rn(mbits, rbits), (float)ssd);
    if (tr) stamp(a, id, 11, last);
  }
}

// One chroma plane of CTU id at the chosen mode, by a whole CTA (8 lanes
// code it): waits for the plane's neighbours, then prediction and chain
// (or, lossless, levels = residual and recon = source), written out, and
// publishes the plane's flag.
template <bool LOSSLESS>
__device__ void code_chroma(Smem& sm, const ScanArgs& a, int32_t* fl,
                            const int32_t* src, int32_t* rec, int16_t* lv,
                            int fi, int cx, int cy, const Avail& av,
                            int mode, int qp, size_t id, bool tr) {
  const int pw = a.W / 2, x0 = 8 * cx, y0 = 8 * cy;
  for (int i = threadIdx.x; i < 64; i += kThreads)
    sm.corig[(i / 8) * 9 + i % 8] = __ldg(src + (size_t)(y0 + i / 8) * pw +
                                          x0 + i % 8);
  wait_neighbours(a, fl, fi, cx, cy);
  if (tr) stamp(a, id, 6);
  if (threadIdx.x < 32) {
    const int dc = warp_refs(rec, pw, x0, y0, 8, 3, av, sm.cs, sm.cf);
    if (threadIdx.x == 0) sm.cdc = dc;
  }
  __syncthreads();
  if (threadIdx.x < 8) {
    const int l = threadIdx.x;
    const RefView r{sm.cs, sm.cf, 8};
    const int dc = sm.cdc;
    int32_t* out = rec + (size_t)y0 * pw + x0;
    const unsigned mask = group_mask<8>();
    int pr[8];
    pred_rows<8>(r, mode, 1, dc, l, mask, sm.cline, pr);
    if (LOSSLESS) {
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        const int o = sm.corig[l * 9 + x];
        lv[l * 8 + x] = (int16_t)(o - pr[x]);
        out[(size_t)l * pw + x] = o;
      }
    } else {
      group_chain<8, 8, false>(
          l, mask, sm.CS, nullptr, qp, a.sbh, 1, RdoqRow{},
          [&](int y, int* v) {
#pragma unroll
            for (int x = 0; x < 8; ++x) v[x] = sm.corig[y * 9 + x] - pr[x];
          },
          [&](int y, int* v) {
#pragma unroll
            for (int x = 0; x < 8; ++x) v[x] = pr[x];
          },
          [&](int y, int* v) {
#pragma unroll
            for (int x = 0; x < 8; ++x) v[x] = sm.corig[y * 9 + x];
          },
          [&](int u, int x, int v) { lv[u * 8 + x] = (int16_t)v; },
          [&](int y, const int* rr) {
#pragma unroll
            for (int x = 0; x < 8; ++x) out[(size_t)y * pw + x] = rr[x];
          });
    }
  }
  publish(fl + id);
  if (tr) stamp(a, id, 7);
}

template <bool LOSSLESS>
__global__ void __launch_bounds__(kThreads) scan_kernel(const ScanArgs a) {
  __shared__ __align__(16) Smem sm;
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  const int tid = threadIdx.x;
  const int W = a.W, H = a.H, Wc = W / 2, Hc = H / 2;
  const int nctu = a.wc * a.hc;
  const size_t total = (size_t)a.F * nctu;
  const int count = a.sched[0];
  int* counter = a.sched + 1;
  const int32_t* list = a.sched + 2;
  int32_t* fl_y = a.flags;
  int32_t* fl_cb = a.flags + total;
  int32_t* fl_cr = a.flags + 2 * total;
  for (;;) {
    if (rank == 0 && tid == 0) sm.ticket = atomicAdd(counter, 1);
    cl.sync();
    const int t = *cl.map_shared_rank(&sm.ticket, 0);
    if (t >= count) break;
    const int id = list[t];
    if (rank == 0) stamp(a, id, 0);
    const int fi = id / nctu, ctu = id % nctu;
    const int cy = ctu / a.wc, cx = ctu % a.wc;
    const int x0 = 16 * cx, y0 = 16 * cy;
    const Avail av{cy > 0, cy > 0 && cx < a.wc - 1, cx > 0, cx > 0 && cy > 0};
    const int qp = a.qp[ctu];
    const int32_t* sy = a.src_y + (size_t)fi * H * W;
    int32_t* ry = a.rec_y + (size_t)fi * H * W;

    // ---- luma: every CTA its 7 modes ---------------------------------
    // the source first: it does not wait on the neighbours
    for (int i = tid; i < kN * kN; i += kThreads)
      sm.orig[(i / kN) * kP + i % kN] =
          __ldg(sy + (size_t)(y0 + i / kN) * W + x0 + i % kN);
    wait_neighbours(a, fl_y, fi, cx, cy);
    if (rank == 0) stamp(a, id, 1);
    if (tid < 32) {
      const int dc = warp_refs(ry, W, x0, y0, kN, 4, av, sm.s, sm.f);
      if (tid == 0) sm.dc = dc;
    }
    __syncthreads();
    if (rank == 0) stamp(a, id, 2);
    const int left = cx > 0 ? __ldcg(a.modes + id - 1) : 1;
    luma_modes<LOSSLESS>(sm, a, id, rank, qp,
                         a.bits + (qp < 0 ? 0 : (qp > 51 ? 51 : qp)) * 13,
                         a.lam[ctu], left);
    if (rank == 0 && a.trace != nullptr) {
      __syncthreads();
      stamp(a, id, 3);
    }
    cl.sync();

    // ---- the first minimum of the 35 costs, in every CTA --------------
    if (tid < 32) {
      float bc = *cl.map_shared_rank(&sm.cost[tid % kPerCta],
                                     tid / kPerCta);
      int bi = tid;
      if (tid + 32 < kModes) {
        const float c1 = *cl.map_shared_rank(&sm.cost[(tid + 32) % kPerCta],
                                             (tid + 32) / kPerCta);
        if (c1 < bc) {
          bc = c1;
          bi = tid + 32;
        }
      }
#pragma unroll
      for (int o = 16; o; o >>= 1) {
        const float oc = __shfl_xor_sync(0xffffffffu, bc, o);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
        if (oc < bc || (oc == bc && oi < bi)) {
          bc = oc;
          bi = oi;
        }
      }
      if (tid == 0) sm.best = bi;
    }
    __syncthreads();
    if (rank == 0) stamp(a, id, 4);
    const int best = sm.best;
    if (rank == best / kPerCta) {
      // the recon and the mode, which later CTUs read, then the levels
      const int g = best % kPerCta;
      for (int i = tid; i < kN * kN; i += kThreads)
        ry[(size_t)(y0 + i / kN) * W + x0 + i % kN] =
            LOSSLESS ? sm.orig[(i / kN) * kP + i % kN] : sm.Rc[g][i];
      if (tid == 0) a.modes[id] = best;
      publish(fl_y + id);
      stamp(a, id, 5);
      int16_t* lv = a.ly + (size_t)id * kN * kN;
      for (int i = tid; i < kN * kN; i += kThreads) lv[i] = sm.L[g][i];
    }

    // ---- chroma at the chosen mode: Cb and Cr side by side -------------
    if (rank == kCb || rank == kCr) {
      const bool cr = rank == kCr;
      const size_t coff = (size_t)fi * Hc * Wc;
      code_chroma<LOSSLESS>(sm, a, cr ? fl_cr : fl_cb,
                            (cr ? a.src_cr : a.src_cb) + coff,
                            (cr ? a.rec_cr : a.rec_cb) + coff,
                            (cr ? a.lcr : a.lcb) + (size_t)id * 64, fi, cx,
                            cy, av, best, a.qpc[ctu], id, rank == kCb);
    }
  }
  cl.sync();   // no CTA leaves while another may read its shared memory
}

// One thread block: the ticket list in wavefront order and zeroed flags.
// Thread j counts the CTUs to code on its diagonals, a block-wide scan
// places them.
__global__ void __launch_bounds__(kListThreads) list_kernel(
    const ScanArgs a) {
  __shared__ int part[kListThreads];
  const int tid = threadIdx.x;
  const int nctu = a.wc * a.hc;
  const int total = a.F * nctu;
  const int nd = a.wc + 2 * (a.hc - 1);
  for (int i = tid; i < 3 * total; i += kListThreads) a.flags[i] = 0;
  const int per = (nd + kListThreads - 1) / kListThreads;
  const int d0 = tid * per, d1 = d0 + per < nd ? d0 + per : nd;
  auto coded = [&](int f, int cy, int cx) {
    return a.kinds == nullptr ||
           a.kinds[(size_t)f * nctu + cy * a.wc + cx] == 2;
  };
  int c = 0;
  for (int d = d0; d < d1; ++d) {
    const int lo = d - a.wc + 1 > 0 ? (d - a.wc + 2) / 2 : 0;
    const int hi = d / 2 < a.hc - 1 ? d / 2 : a.hc - 1;
    for (int f = 0; f < a.F; ++f)
      for (int cy = lo; cy <= hi; ++cy) c += coded(f, cy, d - 2 * cy);
  }
  part[tid] = c;
  __syncthreads();
  for (int o = 1; o < kListThreads; o <<= 1) {
    const int v = tid >= o ? part[tid - o] : 0;
    __syncthreads();
    part[tid] += v;
    __syncthreads();
  }
  int pos = part[tid] - c;
  int32_t* list = a.sched + 2;
  for (int d = d0; d < d1; ++d) {
    const int lo = d - a.wc + 1 > 0 ? (d - a.wc + 2) / 2 : 0;
    const int hi = d / 2 < a.hc - 1 ? d / 2 : a.hc - 1;
    for (int f = 0; f < a.F; ++f)
      for (int cy = lo; cy <= hi; ++cy)
        if (coded(f, cy, d - 2 * cy))
          list[pos++] = f * nctu + cy * a.wc + d - 2 * cy;
  }
  if (tid == kListThreads - 1) {
    a.sched[0] = part[tid];
    a.sched[1] = 0;
  }
}

template <bool LOSSLESS>
int launch_all(const ScanArgs& a, int* launches, cudaStream_t stream) {
  list_kernel<<<1, kListThreads, 0, stream>>>(a);
  ++*launches;
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.blockDim = dim3(kThreads);
  cfg.gridDim = dim3(kCluster);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // clusters that fit on the card, asked once per device (the query costs
  // more host time than a commit's whole scan)
  static int fits[64] = {};
  int dev = 0, fit = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 64 && fits[dev] > 0) {
    fit = fits[dev];
  } else {
    e = cudaOccupancyMaxActiveClusters(&fit, scan_kernel<LOSSLESS>, &cfg);
    if (e != cudaSuccess) return (int)e;
    if (fit < 1) return (int)cudaErrorLaunchOutOfResources;
    if (dev < 64) fits[dev] = fit;
  }
  const int total = a.F * a.wc * a.hc;
  const int n = fit < total ? fit : total;
  cfg.gridDim = dim3(kCluster * n);
  e = cudaLaunchKernelEx(&cfg, scan_kernel<LOSSLESS>, a);
  ++*launches;
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int intra16_scan(const ScanArgs* args, int* launches,
                            cudaStream_t stream) {
  const ScanArgs& a = *args;
  *launches = 0;
  if (a.F < 1 || a.wc < 1 || a.hc < 1 || a.W != 16 * a.wc ||
      a.H != 16 * a.hc || a.sched == nullptr || a.flags == nullptr ||
      (a.lossless && a.kinds != nullptr))
    return (int)cudaErrorInvalidValue;
  return a.lossless ? launch_all<true>(a, launches, stream)
                    : launch_all<false>(a, launches, stream);
}
