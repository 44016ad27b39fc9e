// Kernel K12 `lowres_aq`: the lookahead's half-resolution plane and the
// auto-variance AQ offsets of one frame, in one pass over its planes.
//
// Replaces, from the JAX package: models/lookahead.py lowres_half (the
// rounded 2x2 mean) and aq_offsets (per 16x16 block, log2 of the energy of
// its four luma 8x8 blocks and the co-located cb and cr 8x8 blocks, minus
// the frame mean, times f32(strength * 1.0397)).
//
// Entry point (plain C, caller's stream, returns cudaGetLastError()):
//   lowres_aq(y [H,W] u8, cb, cr [H/2,W/2] u8, lowres [H/2,W/2] u8 out,
//             s [H/16,W/16] f32 scratch, off [H/16,W/16] f32 out, H, W,
//             scale, stream)           H, W multiples of 16
//
// What bounds it on an H100: bytes (each plane read once, 1.5 bytes per
// luma sample in, 0.25 out; a few integer operations per sample).  Pass 1:
// one 64-thread block per 16x16 block; each thread reads a 2x2 luma quad
// (its lowres sample) and one cb and one cr sample, and shared-memory
// integer atomics sum x and x^2 of the six 8x8 blocks, so each energy is
// exact: 64 sum x^2 - (sum x)^2 (JAX forms an f32 sum of rounded squares;
// the tolerance against it is 1e-5 on the offsets).  s = log2(E/64 + 1) is
// taken in f64 and rounded to f32.  Pass 2: one block sums s in f64, which
// is exact for these values (each s is 0 or at least log2(1 + 63/64), all
// below 32, so every f32 term fits in the sum's 53 bits), hence the same
// in any order; the mean is that sum over the count, rounded to f32, and
// each offset scale * (s - mean) in f32 (built with --fmad=false).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void lowres_aq_pass1(const uint8_t* __restrict__ y,
                                const uint8_t* __restrict__ cb,
                                const uint8_t* __restrict__ cr,
                                uint8_t* __restrict__ lowres,
                                float* __restrict__ s, int H, int W) {
  // sums and sums of squares: luma quadrants 0-3, cb 4, cr 5
  __shared__ int sum[6];
  __shared__ int sq[6];
  const int t = threadIdx.x;          // 0..63
  if (t < 6) {
    sum[t] = 0;
    sq[t] = 0;
  }
  __syncthreads();
  const int wc = W / 16;
  const int qy = blockIdx.x / wc, qx = blockIdx.x % wc;
  const int ly = t >> 3, lx = t & 7;  // lowres sample within the block
  const int yy = qy * 16 + 2 * ly, xx = qx * 16 + 2 * lx;
  const int a = y[(size_t)yy * W + xx], b = y[(size_t)yy * W + xx + 1];
  const int c = y[(size_t)(yy + 1) * W + xx];
  const int d = y[(size_t)(yy + 1) * W + xx + 1];
  lowres[(size_t)(qy * 8 + ly) * (W / 2) + qx * 8 + lx] =
      (uint8_t)((a + c + b + d + 2) >> 2);
  const int q = (ly >> 2) * 2 + (lx >> 2);
  atomicAdd(&sum[q], a + b + c + d);
  atomicAdd(&sq[q], a * a + b * b + c * c + d * d);
  const size_t ci = (size_t)(qy * 8 + ly) * (W / 2) + qx * 8 + lx;
  const int u = cb[ci], v = cr[ci];
  atomicAdd(&sum[4], u);
  atomicAdd(&sq[4], u * u);
  atomicAdd(&sum[5], v);
  atomicAdd(&sq[5], v * v);
  __syncthreads();
  if (t == 0) {
    long long e = 0;
    for (int k = 0; k < 6; ++k)
      e += 64LL * sq[k] - (long long)sum[k] * sum[k];
    s[blockIdx.x] = (float)log2((double)e / 64.0 + 1.0);
  }
}

__global__ void lowres_aq_pass2(const float* __restrict__ s,
                                float* __restrict__ off, int n,
                                float scale) {
  __shared__ double part[1024];
  double acc = 0.0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) acc += (double)s[i];
  part[threadIdx.x] = acc;
  __syncthreads();
  for (int k = blockDim.x / 2; k > 0; k >>= 1) {
    if (threadIdx.x < k) part[threadIdx.x] += part[threadIdx.x + k];
    __syncthreads();
  }
  const float mean = (float)(part[0] / (double)n);
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    off[i] = __fmul_rn(scale, __fsub_rn(s[i], mean));
}

}  // namespace

extern "C" int lowres_aq(const uint8_t* y, const uint8_t* cb,
                         const uint8_t* cr, uint8_t* lowres, float* s,
                         float* off, int H, int W, float scale,
                         cudaStream_t stream) {
  if (H <= 0 || W <= 0 || H % 16 || W % 16)
    return (int)cudaErrorInvalidValue;
  const int n = (H / 16) * (W / 16);
  lowres_aq_pass1<<<n, 64, 0, stream>>>(y, cb, cr, lowres, s, H, W);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  lowres_aq_pass2<<<1, 1024, 0, stream>>>(s, off, n, scale);
  return (int)cudaGetLastError();
}
