// Kernel K1 `intra_pred`: HEVC intra prediction for the CTU32 tree.
//
// Replaces, from the JAX package: ops/intra.py substitute_refs_general,
// predict_all_modes_batch and predict_modes_batch, and
// models/intra_tree.py _satd_modes (the 8x8 Hadamard SATD of all 35 modes).
//
// Entry points (plain C, launched on the caller's stream, return
// cudaGetLastError()):
//   intra_satd35  raw refs + availability + source block -> [B, 35] SATD
//   intra_predict raw refs + availability + modes [B, K] -> [B, K, n, n]
// Both take the bit depth (8 or 10), a template parameter of the kernels:
// the mid-grey fill of a block without references is 1 << (bd - 1), the
// mode 10/26 edge filters clip to (1 << bd) - 1 (JAX ops/intra.py:141,
// 262, 356, 390).
//
// What bounds it on an H100: integer work, not bytes.  satd35 reads one
// n x n source block and 8n+1 reference samples per block and writes 35
// ints, but computes 35 n x n predictions and their Hadamard transforms
// (about 35 * n * n * 12 integer operations).  The JAX version
// materialises all predictions, [B, 35, n, n] int32 (about 550 MB per CU
// size at the main path's 16-frame batch); here each thread builds one
// 8x8 prediction tile in registers from the references in shared memory
// (two taps per sample, ((32 - f) * a + f * b + 16) >> 5), transforms it
// with add/sub butterflies and adds its SATD into a shared per-mode sum,
// so the predictions never reach device memory.  Integer atomics make
// the sums order-independent and exact.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__constant__ int kAngle[35] = {
    0, 0, 32, 26, 21, 17, 13, 9, 5, 2, 0, -2, -5, -9, -13, -17, -21, -26,
    -32, -26, -21, -17, -13, -9, -5, -2, 0, 2, 5, 9, 13, 17, 21, 26, 32};
__constant__ int kInvAngle[35] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, -4096, -1638, -910, -630, -482, -390,
    -315, -256, -315, -390, -482, -630, -910, -1638, -4096, 0, 0, 0, 0, 0,
    0, 0, 0, 0};

constexpr int kMaxN = 32;
constexpr int kMaxSeq = 4 * kMaxN + 1;   // left(2n) + corner + top(2n)

// Reference scan layout (spec 8.4.4.2.2): seq[0 .. 2n-1] = left[2n-1 .. 0],
// seq[2n] = corner, seq[2n+1 .. 4n] = top[0 .. 2n-1].
struct RefView {
  const int* s;   // substituted (unfiltered) scan
  const int* f;   // [1 2 1]-filtered scan
  int n;
};

__device__ __forceinline__ int top_at(const int* s, int n, int i) {
  return s[2 * n + 1 + i];
}
__device__ __forceinline__ int left_at(const int* s, int n, int i) {
  return s[2 * n - 1 - i];
}

__device__ __forceinline__ bool filter_flag(int mode, int n, int c_idx) {
  if (c_idx != 0 || n == 4) return false;
  if (mode == 1) return false;
  if (mode == 0) return true;
  int d26 = abs(mode - 26), d10 = abs(mode - 10);
  int md = d26 < d10 ? d26 : d10;
  int thres = n == 8 ? 7 : (n == 16 ? 1 : 0);
  return md > thres;
}

// Load raw refs of block b, substitute unavailable samples (one thread,
// sequential scan exactly as the spec), then smooth (all threads).
template <int BD>
__device__ void load_refs(const int32_t* top_raw, const int32_t* left_raw,
                          const int32_t* corner_raw, const uint8_t* av_top,
                          const uint8_t* av_left, const uint8_t* av_corner,
                          int b, int n, int* s, int* f) {
  const int m = 4 * n + 1;
  if (threadIdx.x == 0) {
    const int32_t* tr = top_raw + (size_t)b * 2 * n;
    const int32_t* lr = left_raw + (size_t)b * 2 * n;
    const uint8_t* at = av_top + (size_t)b * 2 * n;
    const uint8_t* al = av_left + (size_t)b * 2 * n;
    int first = -1;
    for (int i = 0; i < m; ++i) {
      bool a;
      int v;
      if (i < 2 * n) {
        a = al[2 * n - 1 - i];
        v = lr[2 * n - 1 - i];
      } else if (i == 2 * n) {
        a = av_corner[b];
        v = corner_raw[b];
      } else {
        a = at[i - 2 * n - 1];
        v = tr[i - 2 * n - 1];
      }
      s[i] = v;
      f[i] = a;   // availability, until the smoothing overwrites f
      if (a && first < 0) first = i;
    }
    if (first < 0) {
      for (int i = 0; i < m; ++i) s[i] = 1 << (BD - 1);
    } else {
      int prev = s[first];   // a leading run takes the first sample
      for (int i = 0; i < m; ++i) {
        if (!f[i]) s[i] = prev;
        prev = s[i];
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    f[i] = (i == 0 || i == m - 1)
               ? s[i]
               : (s[i - 1] + 2 * s[i] + s[i + 1] + 2) >> 2;
  }
  __syncthreads();
}

// Sample (y, x) of mode `mode`; dc is the DC value of the unfiltered refs.
template <int BD>
__device__ __forceinline__ int pred_sample(const RefView& r, int mode,
                                           int c_idx, int log2n, int dc,
                                           int y, int x) {
  const int n = r.n;
  const int* u = r.s;
  const int* R = filter_flag(mode, n, c_idx) ? r.f : r.s;
  const bool edge = c_idx == 0 && n < 32;
  if (mode == 0) {
    return ((n - 1 - x) * left_at(R, n, y) + (x + 1) * top_at(R, n, n) +
            (n - 1 - y) * top_at(R, n, x) + (y + 1) * left_at(R, n, n) +
            n) >> (log2n + 1);
  }
  if (mode == 1) {
    if (edge) {
      if (x == 0 && y == 0)
        return (left_at(u, n, 0) + 2 * dc + top_at(u, n, 0) + 2) >> 2;
      if (y == 0) return (top_at(u, n, x) + 3 * dc + 2) >> 2;
      if (x == 0) return (left_at(u, n, y) + 3 * dc + 2) >> 2;
    }
    return dc;
  }
  if (edge && mode == 26 && x == 0) {
    int v = top_at(u, n, 0) + ((left_at(u, n, y) - u[2 * n]) >> 1);
    return v < 0 ? 0 : (v > (1 << BD) - 1 ? (1 << BD) - 1 : v);
  }
  if (edge && mode == 10 && y == 0) {
    int v = left_at(u, n, 0) + ((top_at(u, n, x) - u[2 * n]) >> 1);
    return v < 0 ? 0 : (v > (1 << BD) - 1 ? (1 << BD) - 1 : v);
  }
  const bool vertical = mode >= 18;
  const int angle = kAngle[mode];
  const int k = vertical ? y : x;
  const int j = vertical ? x : y;
  const int pos = (k + 1) * angle;
  const int idx = pos >> 5;
  const int fr = pos & 31;
  // reference line position i in [-n, 2n + 1] -> sample
  auto ref = [&](int i) -> int {
    if (i == 0) return R[2 * n];
    if (i >= 1) {
      int t = i <= 2 * n ? i - 1 : 2 * n - 1;
      return vertical ? top_at(R, n, t) : left_at(R, n, t);
    }
    int e = ((i * kInvAngle[mode] + 128) >> 8) - 1;
    if (e < 0) return R[2 * n];
    if (e > 2 * n - 1) e = 2 * n - 1;
    return vertical ? left_at(R, n, e) : top_at(R, n, e);
  };
  const int i0 = idx + 1 + j;
  const int a = ref(i0);
  const int bb = fr ? ref(i0 + 1) : a;
  return ((32 - fr) * a + fr * bb + 16) >> 5;
}

__device__ __forceinline__ int dc_value(const int* s, int n, int log2n) {
  int acc = 0;
  for (int i = 0; i < n; ++i) acc += top_at(s, n, i) + left_at(s, n, i);
  return (acc + n) >> (log2n + 1);
}

__device__ __forceinline__ void fwht8(int* v) {
#pragma unroll
  for (int s = 1; s < 8; s <<= 1) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (!(i & s)) {
        int a = v[i], b = v[i + s];
        v[i] = a + b;
        v[i + s] = a - b;
      }
    }
  }
}

template <int BD>
__global__ void satd35_kernel(const int32_t* __restrict__ orig,
                              const int32_t* top_raw,
                              const int32_t* left_raw,
                              const int32_t* corner_raw,
                              const uint8_t* av_top, const uint8_t* av_left,
                              const uint8_t* av_corner,
                              int32_t* __restrict__ out, int n, int c_idx) {
  __shared__ int s[kMaxSeq];
  __shared__ int f[kMaxSeq];
  __shared__ int src[kMaxN * kMaxN];
  __shared__ int sat[35];
  __shared__ int dc_sh;
  const int b = blockIdx.x;
  const int log2n = 31 - __clz(n);
  for (int i = threadIdx.x; i < n * n; i += blockDim.x)
    src[i] = orig[(size_t)b * n * n + i];
  if (threadIdx.x < 35) sat[threadIdx.x] = 0;
  load_refs<BD>(top_raw, left_raw, corner_raw, av_top, av_left, av_corner,
                b, n, s, f);
  if (threadIdx.x == 0) dc_sh = dc_value(s, n, log2n);
  __syncthreads();
  const RefView r{s, f, n};
  const int dc = dc_sh;
  const int kb = n / 8;
  const int tasks = 35 * kb * kb;
  for (int t = threadIdx.x; t < tasks; t += blockDim.x) {
    const int mode = t / (kb * kb);
    const int sb = t % (kb * kb);
    const int y0 = (sb / kb) * 8, x0 = (sb % kb) * 8;
    int d[8][8];
#pragma unroll
    for (int yy = 0; yy < 8; ++yy) {
#pragma unroll
      for (int xx = 0; xx < 8; ++xx) {
        d[yy][xx] = src[(y0 + yy) * n + x0 + xx] -
                    pred_sample<BD>(r, mode, c_idx, log2n, dc, y0 + yy,
                                    x0 + xx);
      }
      fwht8(d[yy]);
    }
    int acc = 0;
#pragma unroll
    for (int xx = 0; xx < 8; ++xx) {
      int col[8];
#pragma unroll
      for (int yy = 0; yy < 8; ++yy) col[yy] = d[yy][xx];
      fwht8(col);
#pragma unroll
      for (int yy = 0; yy < 8; ++yy) acc += abs(col[yy]);
    }
    atomicAdd(&sat[mode], (acc + 2) >> 2);
  }
  __syncthreads();
  if (threadIdx.x < 35) out[(size_t)b * 35 + threadIdx.x] = sat[threadIdx.x];
}

template <int BD>
__global__ void predict_kernel(const int32_t* top_raw,
                               const int32_t* left_raw,
                               const int32_t* corner_raw,
                               const uint8_t* av_top,
                               const uint8_t* av_left,
                               const uint8_t* av_corner,
                               const int32_t* __restrict__ modes,
                               int32_t* __restrict__ out, int K, int n,
                               int c_idx) {
  __shared__ int s[kMaxSeq];
  __shared__ int f[kMaxSeq];
  __shared__ int dc_sh;
  const int bk = blockIdx.x;
  const int b = bk / K;
  const int log2n = 31 - __clz(n);
  load_refs<BD>(top_raw, left_raw, corner_raw, av_top, av_left, av_corner,
                b, n, s, f);
  if (threadIdx.x == 0) dc_sh = dc_value(s, n, log2n);
  __syncthreads();
  const RefView r{s, f, n};
  const int mode = modes[bk];
  for (int i = threadIdx.x; i < n * n; i += blockDim.x) {
    out[(size_t)bk * n * n + i] =
        pred_sample<BD>(r, mode, c_idx, log2n, dc_sh, i / n, i % n);
  }
}

}  // namespace

extern "C" int intra_satd35(const int32_t* orig, const int32_t* top_raw,
                            const int32_t* left_raw,
                            const int32_t* corner_raw, const uint8_t* av_top,
                            const uint8_t* av_left,
                            const uint8_t* av_corner, int32_t* out, int B,
                            int n, int c_idx, int bd, cudaStream_t stream) {
  if (n != 8 && n != 16 && n != 32) return (int)cudaErrorInvalidValue;
  if (bd != 8 && bd != 10) return (int)cudaErrorInvalidValue;
  if (bd == 8)
    satd35_kernel<8><<<B, 128, 0, stream>>>(orig, top_raw, left_raw,
                                            corner_raw, av_top, av_left,
                                            av_corner, out, n, c_idx);
  else
    satd35_kernel<10><<<B, 128, 0, stream>>>(orig, top_raw, left_raw,
                                             corner_raw, av_top, av_left,
                                             av_corner, out, n, c_idx);
  return (int)cudaGetLastError();
}

extern "C" int intra_predict(const int32_t* top_raw, const int32_t* left_raw,
                             const int32_t* corner_raw,
                             const uint8_t* av_top, const uint8_t* av_left,
                             const uint8_t* av_corner, const int32_t* modes,
                             int32_t* out, int B, int K, int n, int c_idx,
                             int bd, cudaStream_t stream) {
  if (n != 8 && n != 16 && n != 32) return (int)cudaErrorInvalidValue;
  if (bd != 8 && bd != 10) return (int)cudaErrorInvalidValue;
  if (bd == 8)
    predict_kernel<8><<<B * K, 256, 0, stream>>>(top_raw, left_raw,
                                                 corner_raw, av_top, av_left,
                                                 av_corner, modes, out, K, n,
                                                 c_idx);
  else
    predict_kernel<10><<<B * K, 256, 0, stream>>>(top_raw, left_raw,
                                                  corner_raw, av_top,
                                                  av_left, av_corner, modes,
                                                  out, K, n, c_idx);
  return (int)cudaGetLastError();
}
