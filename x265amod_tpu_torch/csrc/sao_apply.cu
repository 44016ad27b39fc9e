// Kernel K11 `sao_apply`: applies every CTU's SAO parameters to one plane.
//
// Replaces, from the JAX package: ops/sao.py sao_apply (:168) with its
// _eo_cat_map (:42) classification.
//
// Entry point (plain C, caller's stream, returns cudaGetLastError()):
//   sao_apply(rec [H,W] i32, H, W, ctu, params [n,7] i32, out [H,W] i32)
// params rows are (type 0 off / 1 band / 2 edge, eo_class, band_pos,
// offsets[4]) per CTU in raster order.
//
// What bounds it on an H100: bytes (one int32 in, one out per sample; the
// neighbours and the CTU's row hit L1).  One thread per sample: it reads
// its CTU's row, classifies the sample against the INPUT plane (never the
// output, so the order of the threads does not matter; a neighbour outside
// the picture gives category 0), adds the offset and clips to 0..255.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__constant__ int kNb[4][4] = {{0, -1, 0, 1}, {-1, 0, 1, 0},
                              {-1, -1, 1, 1}, {-1, 1, 1, -1}};

__device__ __forceinline__ int sgn(int v) { return (v > 0) - (v < 0); }

__global__ void sao_apply_kernel(const int32_t* __restrict__ rec, int H,
                                 int W, int ctu,
                                 const int32_t* __restrict__ params,
                                 int32_t* __restrict__ out) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)H * W) return;
  const int y = (int)(idx / W), x = (int)(idx % W);
  const int32_t* pr = params + 7 * ((y / ctu) * (W / ctu) + x / ctu);
  const int v = rec[idx];
  int off = 0;
  if (pr[0] == 2) {
    const int* d = kNb[pr[1]];
    const int y0 = y + d[0], x0 = x + d[1], y1 = y + d[2], x1 = x + d[3];
    if (y0 >= 0 && y0 < H && x0 >= 0 && x0 < W && y1 >= 0 && y1 < H &&
        x1 >= 0 && x1 < W) {
      const int edge = 2 + sgn(v - rec[(size_t)y0 * W + x0]) +
                       sgn(v - rec[(size_t)y1 * W + x1]);
      const int cat = edge == 2 ? 0 : (edge < 2 ? edge + 1 : edge);
      if (cat) off = pr[2 + cat];
    }
  } else if (pr[0] == 1) {
    const int rel = (v >> 3) - pr[2];
    if (rel >= 0 && rel < 4) off = pr[3 + rel];
  }
  const int o = v + off;
  out[idx] = o < 0 ? 0 : (o > 255 ? 255 : o);
}

}  // namespace

extern "C" int sao_apply(const int32_t* rec, int H, int W, int ctu,
                         const int32_t* params, int32_t* out,
                         cudaStream_t stream) {
  if (ctu <= 0 || H % ctu || W % ctu) return (int)cudaErrorInvalidValue;
  const int64_t total = (int64_t)H * W;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  sao_apply_kernel<<<blocks, threads, 0, stream>>>(rec, H, W, ctu, params,
                                                   out);
  return (int)cudaGetLastError();
}
