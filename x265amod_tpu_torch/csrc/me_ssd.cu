// Kernel K5 `me_ssd_grid`: the dense SSD grid of every bn x bn block of a
// frame at every integer offset in [-sr, sr]^2 of a reference plane read at
// clamped coordinates (the JAX edge padding).
//
// Replaces, from the JAX package: ops/me.py me_ssd_grid (a grouped f32
// convolution, w2 - 2 corr + c2, over im2col windows).
//
// Entry point (plain C, caller's stream, returns cudaGetLastError()):
//   me_ssd_grid(cur [nb,bn,bn] i32, ref [H,W] i32, H, W, bn, sr,
//               out [nb,S,S] f32),  S = 2 sr + 1, nb = (H/bn) (W/bn)
//
// What bounds it on an H100: integer operations (S^2 bn^2 multiply-adds per
// block against 4 bn^2 bytes read).  One thread block owns one block: the
// (bn + 2 sr)^2 reference window and the block sit in shared memory, and
// each thread sums the exact int32 SSD of one offset (at most
// 1024 * 255^2 < 2^31), converted to f32 once, round to nearest.  JAX's f32
// form is exact while its terms stay below 2^24; beyond that (bn 32 on
// bright content) the exact sum is the normative value.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void me_ssd_kernel(const int32_t* __restrict__ cur,
                              const int32_t* __restrict__ ref, int H, int W,
                              int bn, int sr, float* __restrict__ out) {
  extern __shared__ int sh[];
  const int S = 2 * sr + 1;
  const int ws = bn + 2 * sr;
  int* win = sh;
  int* blk = sh + ws * ws;
  const int b = blockIdx.x;
  const int wb = W / bn;
  const int bx = (b % wb) * bn, by = (b / wb) * bn;
  for (int i = threadIdx.x; i < ws * ws; i += blockDim.x) {
    int y = by - sr + i / ws, x = bx - sr + i % ws;
    y = y < 0 ? 0 : (y > H - 1 ? H - 1 : y);
    x = x < 0 ? 0 : (x > W - 1 ? W - 1 : x);
    win[i] = ref[(size_t)y * W + x];
  }
  const int32_t* c = cur + (size_t)b * bn * bn;
  for (int i = threadIdx.x; i < bn * bn; i += blockDim.x) blk[i] = c[i];
  __syncthreads();
  for (int o = threadIdx.x; o < S * S; o += blockDim.x) {
    const int dy = o / S, dx = o % S;
    int acc = 0;
    for (int y = 0; y < bn; ++y) {
      const int* wr = win + (dy + y) * ws + dx;
      const int* cr = blk + y * bn;
      for (int x = 0; x < bn; ++x) {
        const int d = cr[x] - wr[x];
        acc += d * d;
      }
    }
    out[(size_t)b * S * S + o] = __int2float_rn(acc);
  }
}

}  // namespace

extern "C" int me_ssd_grid(const int32_t* cur, const int32_t* ref, int H,
                           int W, int bn, int sr, float* out,
                           cudaStream_t stream) {
  if ((bn != 16 && bn != 32) || sr < 1 || sr > 32)
    return (int)cudaErrorInvalidValue;
  const int nb = (H / bn) * (W / bn);
  const int ws = bn + 2 * sr;
  const size_t shmem = (size_t)(ws * ws + bn * bn) * sizeof(int);
  const int S = 2 * sr + 1;
  int threads = ((S * S + 31) / 32) * 32;
  threads = threads > 1024 ? 1024 : threads;
  me_ssd_kernel<<<nb, threads, shmem, stream>>>(cur, ref, H, W, bn, sr, out);
  return (int)cudaGetLastError();
}
