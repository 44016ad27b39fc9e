// Kernel K5 `me_ssd_grid`: the dense SSD grid of every bn x bn block of a
// frame at every integer offset in [-sr, sr]^2 of a reference plane read at
// clamped coordinates (the JAX edge padding).
//
// Replaces, from the JAX package: ops/me.py me_ssd_grid (a grouped f32
// convolution, w2 - 2 corr + c2, over im2col windows).
//
// Entry points (plain C, caller's stream, returns cudaGetLastError()):
//   me_ssd_grid(cur [nb,bn,bn] i32, ref [H,W] i32, H, W, bn, sr,
//               out [nb,S,S] f32),  S = 2 sr + 1, nb = (H/bn) (W/bn)
//   me_ssd_grid_argmin(cur, ref, H, W, bn, sr, lam [nb] f32, out,
//               mv_out [nb,2] i32 (dx, dy)): the same grid, and the ME
//               argmin folded into the epilogue (the JAX package's
//               models/inter_tree.py best_mv :227-229, the first minimum
//               of fma(lam, mvd_bits(4 d), grid[d])): as a thread stores
//               an offset's f32 SSD it forms the cost from that value
//               with __fmaf_rn, mvd_bits = (2 + X[dx]) + X[dy]
//               from a table X[d] = 2 bitlen(4 |d - sr|) in shared memory
//               (ops/me.py mvd_bits; exact small integers, f32 adds), and
//               keeps the first minimum of each run of dy (a strict less)
//               and of its runs (ties to the lower index); a shuffle tree
//               in each warp on the key (cost bits << 32) | index (the
//               costs are non-negative floats, whose bits order as their
//               values do) and a shared atomicMin over the warps' keys
//               take the least (cost, index): ties go to the lower index,
//               jnp.argmin's order.  Every float step is an explicit _rn
//               intrinsic: this file is built with FMA contraction on.
//
// What bounds it on an H100: the correlation, S^2 bn^2 multiply-adds per
// block against 4 bn^2 bytes read and 4 S^2 written; on the int32 ALUs,
// one thread an offset, it is bound by the shared-memory loads of its
// operands (two a multiply-add).  Here SSD = c2 - 2 corr + w2, and
// the correlation runs on the tensor cores as an exact 8-bit product with
// s32 accumulation (mma.sync m16n8k16 at bn 16, m16n8k32 at bn 32):
//   corr[dy][dx] = sum_{r, x} w[r][dx + x] * c[r - dy][x]
// is A . B with A[dx][(r, x)] = w[r][dx + x] (a Toeplitz stack of window
// row r, the same for every dy) and B[(r, x)][dy] = c[r - dy][x] (zero
// outside the block).  A warp owns 8 offsets dy (one n-tile) and every dx
// (M padded to whole 16-row tiles, the padding discarded), and walks the
// bn + 7 window rows that its dy reach: every offset is done in one pass.
// The rows of A are 1-byte shifts of one another, so a lane builds its
// fragments from aligned 32-bit words of the byte window with funnel
// shifts (no ldmatrix); the kernel is built for the number of 16-row
// tiles that S needs, so the accumulators take no more registers than
// that.  The rest is plain integer work spread over the block: each warp
// loads four window rows at once and stores their bytes and squares; the
// window energies w2 are box sums of the squares, a thread sliding the box
// along one run of a row, then down one run of a column, where it also
// combines and stores its offsets.  Every term is exact modulo 2^32; the
// SSD is the exact int32 value (at most 1024 * 255^2 < 2^31 for 8-bit
// samples), converted to f32 once, round to nearest.
//
// Which samples take which product, decided per block by a block-wide vote
// on the window and the block (no wrapper argument):
//   - every window sample in [0, 255]: one u8 x u8 product;
//   - a window sample outside [0, 255] but inside [-2048, 2047] (K8's
//     half-pel plane of an 8-bit plane lies in [-263, 518]): each sample
//     splits as v = 256 h + l, l a u8 and h an s8 in [-8, 7], and corr =
//     256 sum c h + sum c l: the h product first, scaled by 256, then the
//     l product into the same accumulator, every partial sum below 2^31
//     (256 * 1024 * 255 * 8 + 1024 * 255^2);
//   - anything else (a block sample outside [0, 255], a window sample
//     beyond 12 bits): an exact int32 loop over device memory (no encoder
//     path gives such input).
// Every path gives the same bits: the SSD modulo 2^32, as an int32.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void mma_u8(int (&d)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2], bool k32,
                                       bool hi) {
  // k32 and hi are uniform across the warp (template / block vote)
  if (k32) {
    if (hi)
      asm volatile(
          "mma.sync.aligned.m16n8k32.row.col.s32.s8.u8.s32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
            "r"(b[1]));
    else
      asm volatile(
          "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
            "r"(b[1]));
  } else {
    if (hi)
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.s32.s8.u8.s32 "
          "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
          : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
          : "r"(a[0]), "r"(a[1]), "r"(b[0]));
    else
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.s32.u8.u8.s32 "
          "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
          : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
          : "r"(a[0]), "r"(a[1]), "r"(b[0]));
  }
}

// Sliding segments of the box sums: a row's (a column's) S outputs are
// cut into kSeg runs, one thread a run.
constexpr int kSeg = 4;

// the least (cost, index) of a thread's and another's, ties to the lower
// index
__device__ __forceinline__ void keep_min(float& c, int& i, float c2,
                                         int i2) {
  if (c2 < c || (c2 == c && i2 < i)) {
    c = c2;
    i = i2;
  }
}

// the CTA's first minimum of the threads' (c, i) into mv_out[b]: a warp's
// least key (cost bits << 32) | index by a shuffle tree, then the least of
// the warps' keys by a shared atomicMin on *key (~0 before the call);
// every thread of the CTA calls it
__device__ void argmin_store(float c, int i, int S, int sr,
                             unsigned long long* key, int32_t* mv_out,
                             int b) {
  unsigned long long k =
      ((unsigned long long)__float_as_uint(c) << 32) | (unsigned)i;
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    const unsigned long long k2 = __shfl_down_sync(0xffffffffu, k, off);
    k = k2 < k ? k2 : k;
  }
  if ((threadIdx.x & 31) == 0) atomicMin(key, k);
  __syncthreads();
  if (threadIdx.x == 0) {
    const int idx = (int)(*key & 0xffffffffu);
    mv_out[2 * b] = idx % S - sr;
    mv_out[2 * b + 1] = idx / S - sr;
  }
}

template <int BN, int MT>
__device__ __forceinline__ void me_ssd_body(const int32_t* __restrict__ cur,
                                            const int32_t* __restrict__ ref,
                                            int H, int W, int sr,
                                            float* __restrict__ out,
                                            const float* __restrict__ lam,
                                            int32_t* __restrict__ mv_out) {
  const bool am = mv_out != nullptr;    // the folded argmin
  constexpr bool k32 = BN == 32;
  constexpr int kWords = 4 * MT + (k32 ? 4 : 0);
  extern __shared__ __align__(16) unsigned char sh[];
  const int S = 2 * sr + 1;
  const int ws = BN + 2 * sr;
  const int pitch = (16 * MT + BN + 4 + 15) & ~15;
  const int nw = blockDim.x >> 5;
  uint8_t* wl = sh;                                   // [ws][pitch] u8
  int8_t* wh = (int8_t*)(sh + ws * pitch);            // [ws][pitch] s8
  uint8_t* cb = sh + 2 * ws * pitch;                  // [BN][BN] u8
  const int sp = ws + 1;   // odd: the runs of a warp hit distinct banks
  unsigned* sq = (unsigned*)(cb + BN * BN);           // [ws][sp] w^2
  unsigned* rs = sq + ws * sp;                        // [ws][S]
  unsigned* cs = rs + ws * S;                         // [S][S]
  unsigned* c2w = cs + S * S;                         // [nw]
  // am: the argmin's key and table X[d]
  unsigned long long* amk = reinterpret_cast<unsigned long long*>(
      (reinterpret_cast<uintptr_t>(c2w + nw) + 7) & ~(uintptr_t)7);
  float* xb = (float*)(amk + 1);                      // [S]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x;
  const int wb = W / BN;
  const int bx = (b % wb) * BN, by = (b / wb) * BN;
  const int32_t* c = cur + (size_t)b * BN * BN;

  // the window as byte planes and squares (a warp loads four rows at
  // once), the block as bytes; the range of both for the votes
  int lo = 0, hi = 0;
  int xo[4];
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) {
    const int xx = bx - sr + 32 * ch + lane;
    xo[ch] = xx < 0 ? 0 : (xx > W - 1 ? W - 1 : xx);
  }
  for (int r0 = 4 * warp; r0 < ws; r0 += 4 * nw) {
    int v[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      int y = by - sr + r0 + k;
      y = y < 0 ? 0 : (y > H - 1 ? H - 1 : y);
      const int32_t* row = ref + (size_t)y * W;
#pragma unroll
      for (int ch = 0; ch < 4; ++ch)
        v[k][ch] = r0 + k < ws && 32 * ch + lane < ws ? row[xo[ch]] : 0;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) {
        const int x = 32 * ch + lane, r = r0 + k;
        if (r < ws && x < pitch) {
          const int u = v[k][ch];
          lo = min(lo, u);
          hi = max(hi, u);
          wl[r * pitch + x] = (uint8_t)(u & 255);
          wh[r * pitch + x] = (int8_t)(u >> 8);
          if (x < ws) sq[r * sp + x] = (unsigned)u * (unsigned)u;
        }
      }
    }
  }
  if (am) {
    if (tid == 0) *amk = ~0ULL;
    for (int d = tid; d < S; d += blockDim.x) {
      const int a = 4 * abs(d - sr);
      xb[d] = a ? __int2float_rn(2 * (32 - __clz(a))) : 0.0f;
    }
  }
  unsigned c2 = 0;
  int clo = 0, chi = 0;
  for (int i = tid; i < BN * BN; i += blockDim.x) {
    const int u = c[i];
    clo = min(clo, u);
    chi = max(chi, u);
    cb[i] = (uint8_t)u;
    c2 += (unsigned)u * (unsigned)u;
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) c2 += __shfl_xor_sync(0xffffffffu, c2, o);
  if (lane == 0) c2w[warp] = c2;
  const int split = __syncthreads_or(lo < 0 || hi > 255) ? 1 : 0;
  const int wide =
      __syncthreads_or(lo < -2048 || hi > 2047 || clo < 0 || chi > 255);
  float* o = out + (size_t)b * S * S;

  if (wide) {
    // beyond the byte split's range: the exact int32 loop, from device
    // memory
    float best = __int_as_float(0x7f800000);   // am: +inf
    int bi = S * S;
    for (int t = tid; t < S * S; t += blockDim.x) {
      const int dy = t / S, dx = t % S;
      unsigned acc = 0;
      for (int y = 0; y < BN; ++y) {
        int ry = by - sr + dy + y;
        ry = ry < 0 ? 0 : (ry > H - 1 ? H - 1 : ry);
        for (int x = 0; x < BN; ++x) {
          int rx = bx - sr + dx + x;
          rx = rx < 0 ? 0 : (rx > W - 1 ? W - 1 : rx);
          const unsigned d =
              (unsigned)c[y * BN + x] - (unsigned)ref[(size_t)ry * W + rx];
          acc += d * d;
        }
      }
      const float v = __int2float_rn((int)acc);
      o[t] = v;
      if (am)
        keep_min(best, bi, __fmaf_rn(lam[b], __fadd_rn(__fadd_rn(
                     2.0f, xb[dx]), xb[dy]), v), t);
    }
    if (am) argmin_store(best, bi, S, sr, amk, mv_out, b);
    return;
  }

  // row energies rs[r][dx] = sum_{x < BN} w[r][dx + x]^2, a thread a run
  // of dx sliding along the row
  const int run = (S + kSeg - 1) / kSeg;
  for (int task = tid; task < ws * kSeg; task += blockDim.x) {
    const int r = task / kSeg, dx0 = (task % kSeg) * run;
    const int dx1 = min(dx0 + run, S);
    if (dx0 >= dx1) continue;
    const unsigned* q = sq + r * sp;
    unsigned acc = 0;
#pragma unroll
    for (int x = 0; x < BN; ++x) acc += q[dx0 + x];
    rs[r * S + dx0] = acc;
    for (int dx = dx0 + 1; dx < dx1; ++dx) {
      acc += q[dx + BN - 1] - q[dx - 1];
      rs[r * S + dx] = acc;
    }
  }

  // the correlation: warp `warp` owns dy in [8 warp, 8 warp + 8).  With
  // the byte split the h plane goes first, its sums scaled by 256 (at most
  // 256 * 1024 * 255 * 8 + 1024 * 255^2 < 2^31), then the l plane adds in.
  {
    const int g = lane >> 2, t = lane & 3;
    const int dy0 = 8 * warp;
    const int sh8 = (g & 3) * 8;
    const int qb = t + (g >> 2);
    int acc[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0;
    const int r_end = min(dy0 + 8 + BN - 1, ws);
    const unsigned* cbw = (const unsigned*)cb;
    for (int plane = split; plane >= 0; --plane) {
      const unsigned char* base =
          plane ? (const unsigned char*)wh : (const unsigned char*)wl;
      for (int r = dy0; r < r_end; ++r) {
        const int y = r - dy0 - g;
        const bool in = y >= 0 && y < BN;
        unsigned bf[2];
        bf[0] = in ? cbw[y * (BN / 4) + t] : 0u;
        bf[1] = (k32 && in) ? cbw[y * (BN / 4) + 4 + t] : 0u;
        const unsigned* rw = (const unsigned*)(base + r * pitch) + qb;
        unsigned wd[kWords];
#pragma unroll
        for (int k = 0; k < kWords; ++k) wd[k] = rw[k];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          unsigned a[4];
          a[0] = __funnelshift_r(wd[4 * i], wd[4 * i + 1], sh8);
          a[1] = __funnelshift_r(wd[4 * i + 2], wd[4 * i + 3], sh8);
          if (k32) {
            a[2] = __funnelshift_r(wd[4 * i + 4], wd[4 * i + 5], sh8);
            a[3] = __funnelshift_r(wd[4 * i + 6], wd[4 * i + 7], sh8);
          } else {
            a[2] = a[3] = 0u;
          }
          mma_u8(acc[i], a, bf, k32, plane);
        }
      }
      if (plane) {
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = (int)((unsigned)acc[i][j] << 8);
      }
    }
    // corr into cs[dy][dx]: c0, c1 at (dx = 16 i + g, dy = dy0 + 2 t + j),
    // c2, c3 at dx + 8
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int dx = 16 * i + g + (j >> 1) * 8;
        const int dy = dy0 + 2 * t + (j & 1);
        if (dx < S && dy < S) cs[dy * S + dx] = (unsigned)acc[i][j];
      }
    }
  }
  __syncthreads();

  // SSD = c2 - 2 corr + w2: a thread a run of dy down one column, the box
  // sliding down the row energies; neighbouring threads store neighbouring
  // offsets
  unsigned c2all = 0;
  for (int k = 0; k < nw; ++k) c2all += c2w[k];
  // am: this thread's first minimum
  float best = __int_as_float(0x7f800000);   // +inf
  int bi = S * S;
  for (int task = tid; task < S * kSeg; task += blockDim.x) {
    const int dx = task % S, dy0 = (task / S) * run;
    const int dy1 = min(dy0 + run, S);
    if (dy0 >= dy1) continue;
    unsigned w2 = 0;
#pragma unroll
    for (int y = 0; y < BN; ++y) w2 += rs[(dy0 + y) * S + dx];
    // am: the run's first minimum (dy increasing: a strict less)
    float rb = __int_as_float(0x7f800000);
    int rdy = dy0;
    for (int dy = dy0; dy < dy1; ++dy) {
      if (dy > dy0) w2 += rs[(dy + BN - 1) * S + dx] - rs[(dy - 1) * S + dx];
      const float v = __int2float_rn((int)(c2all - 2u * cs[dy * S + dx] +
                                           w2));
      o[dy * S + dx] = v;
      if (am) {
        const float c = __fmaf_rn(
            lam[b], __fadd_rn(__fadd_rn(2.0f, xb[dx]), xb[dy]), v);
        if (c < rb) {
          rb = c;
          rdy = dy;
        }
      }
    }
    if (am) keep_min(best, bi, rb, rdy * S + dx);
  }
  if (am) argmin_store(best, bi, S, sr, amk, mv_out, b);
}

// The kernels of bn 16 and 32.  Without a minimum of CTAs an SM, ptxas
// gives the bn-16 instances 64-81 registers and holds the bn-32 ones at
// 56, which the folded argmin exceeds at 3 and 5 tiles (a spill): the
// bn-32 kernel asks for 3 CTAs of 288 threads (at most 72 registers), 2
// at 1 tile (sr <= 7), which spills 8 bytes at 72.  A minimum on the
// bn-16 kernel changes its allocation (of 1: 106-114 registers, 20 %
// slower; of 3: 72, the fold 5 % slower).
template <int MT>
__global__ void __launch_bounds__(288)
    me_ssd16_kernel(const int32_t* __restrict__ cur,
                    const int32_t* __restrict__ ref, int H, int W, int sr,
                    float* __restrict__ out, const float* __restrict__ lam,
                    int32_t* __restrict__ mv_out) {
  me_ssd_body<16, MT>(cur, ref, H, W, sr, out, lam, mv_out);
}

template <int MT>
__global__ void __launch_bounds__(288, MT == 1 ? 2 : 3)
    me_ssd32_kernel(const int32_t* __restrict__ cur,
                    const int32_t* __restrict__ ref, int H, int W, int sr,
                    float* __restrict__ out, const float* __restrict__ lam,
                    int32_t* __restrict__ mv_out) {
  me_ssd_body<32, MT>(cur, ref, H, W, sr, out, lam, mv_out);
}

// the argmin (am) adds its key, 8-byte aligned, and its table of S floats
template <int BN, int MT>
size_t smem_bytes(int sr, int warps, bool am) {
  const int S = 2 * sr + 1, ws = BN + 2 * sr;
  const int pitch = (16 * MT + BN + 4 + 15) & ~15;
  return (size_t)2 * ws * pitch + BN * BN +
         (size_t)4 * (ws * (ws + 1) + ws * S + S * S + warps) +
         (am ? 16 + 4 * (size_t)S : 0);
}

template <int BN, int MT>
int launch(const int32_t* cur, const int32_t* ref, int H, int W, int sr,
           float* out, const float* lam, int32_t* mv_out,
           cudaStream_t stream) {
  const int nb = (H / BN) * (W / BN);
  const int S = 2 * sr + 1;
  const int warps = (S + 7) / 8;
  const bool am = mv_out != nullptr;
  const size_t shmem = smem_bytes<BN, MT>(sr, warps, am);
  const auto kernel = BN == 16 ? me_ssd16_kernel<MT> : me_ssd32_kernel<MT>;
  if (shmem > 48 * 1024) {    // the largest windows (sr 32) take ~100 KB
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<nb, 32 * warps, shmem, stream>>>(cur, ref, H, W, sr, out, lam,
                                            mv_out);
  return (int)cudaGetLastError();
}

// the kernel for the 16-row tiles of dx that S = 2 sr + 1 needs
template <int BN>
int launch_tiles(const int32_t* cur, const int32_t* ref, int H, int W,
                 int sr, float* out, const float* lam, int32_t* mv_out,
                 cudaStream_t stream) {
  switch ((2 * sr + 1 + 15) / 16) {
    case 1: return launch<BN, 1>(cur, ref, H, W, sr, out, lam, mv_out,
                                 stream);
    case 2: return launch<BN, 2>(cur, ref, H, W, sr, out, lam, mv_out,
                                 stream);
    case 3: return launch<BN, 3>(cur, ref, H, W, sr, out, lam, mv_out,
                                 stream);
    case 4: return launch<BN, 4>(cur, ref, H, W, sr, out, lam, mv_out,
                                 stream);
    default: return launch<BN, 5>(cur, ref, H, W, sr, out, lam, mv_out,
                                  stream);
  }
}

int launch_bn(const int32_t* cur, const int32_t* ref, int H, int W, int bn,
              int sr, float* out, const float* lam, int32_t* mv_out,
              cudaStream_t stream) {
  if ((bn != 16 && bn != 32) || sr < 1 || sr > 32)
    return (int)cudaErrorInvalidValue;
  return bn == 16
             ? launch_tiles<16>(cur, ref, H, W, sr, out, lam, mv_out, stream)
             : launch_tiles<32>(cur, ref, H, W, sr, out, lam, mv_out, stream);
}

}  // namespace

extern "C" int me_ssd_grid(const int32_t* cur, const int32_t* ref, int H,
                           int W, int bn, int sr, float* out,
                           cudaStream_t stream) {
  return launch_bn(cur, ref, H, W, bn, sr, out, nullptr, nullptr, stream);
}

extern "C" int me_ssd_grid_argmin(const int32_t* cur, const int32_t* ref,
                                  int H, int W, int bn, int sr,
                                  const float* lam, float* out,
                                  int32_t* mv_out, cudaStream_t stream) {
  if (lam == nullptr || mv_out == nullptr) return (int)cudaErrorInvalidValue;
  return launch_bn(cur, ref, H, W, bn, sr, out, lam, mv_out, stream);
}
