// Phase difference + bilinear resize of consecutive band frames.
//
// Replaces the TPU kernel phase_diff_resize_blocked
// (mimamo_tpu/pallas/phase_kernel.py, body _make_blocked_kernel/_atan2).
// For each (b, t, k) pair of a complex band [B, T, K, h, w]:
//   prod = c_t * conj(c_{t-1}),  dphi = atan2(Im, Re)             (fp32)
//   optionally dphi *= |prod| / (mean(|prod|) + 1e-6)
//   out[b, t-1, c0 + k] = R_h dphi R_w^T   (half-pixel bilinear, P x P)
//
// Bound on the H100: bytes. Per pair it reads two h x w complex64 planes
// and writes P*P floats, doing ~30 flops per output pixel, far below the
// card's ~20 flop/byte balance point for fp32 SIMT math.
//
// Design: the whole band tensor is read once (the kernel forms the pair
// (t, t-1) itself, where the TPU call read band[:, 1:] and band[:, :-1] as
// two arrays), one block per pair. If weighting is on, a block-wide sum of
// |prod| comes first. Then each output pixel gathers its <= 2x2 source taps
// (the two nonzeros per row of the resize matrix, passed in as index/weight
// arrays) and computes atan2f of each tap's product on the fly: dphi never
// reaches device memory and no matmul is needed. The result is written at
// the scale's channel offset of the final [B, T-1, S*K, P, P] buffer, so
// the scales need no concat. atan2f replaces the TPU's minimax polynomial,
// which existed only because Mosaic had no atan2.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void product(const float2* cur, const float2* prev,
                                        int i, float& re, float& im) {
  const float2 a = cur[i];
  const float2 p = prev[i];
  re = a.x * p.x + a.y * p.y;
  im = a.y * p.x - a.x * p.y;
}

__global__ void __launch_bounds__(kThreads)
phase_diff_resize_kernel(const float2* __restrict__ band,
                         float* __restrict__ out,
                         const int* __restrict__ row_idx,
                         const float* __restrict__ row_wts,
                         const int* __restrict__ col_idx,
                         const float* __restrict__ col_wts,
                         int T, int K, int h, int w, int P, int C, int c0,
                         int weighting) {
  const int pair = blockIdx.x;            // over B * (T-1) * K
  const int k = pair % K;
  const int bt = pair / K;
  const int t = bt % (T - 1) + 1;         // frame t pairs with t-1
  const int b = bt / (T - 1);
  const long long hw = static_cast<long long>(h) * w;
  const float2* cur = band + ((static_cast<long long>(b) * T + t) * K + k) * hw;
  const float2* prev = cur - K * hw;

  __shared__ float warp_sums[kThreads / 32];
  float denom = 1.f;
  if (weighting) {
    float sum = 0.f;
    for (long long i = threadIdx.x; i < hw; i += kThreads) {
      float re, im;
      product(cur, prev, static_cast<int>(i), re, im);
      sum += sqrtf(re * re + im * im);
    }
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = sum;
    __syncthreads();
    float total = 0.f;
    for (int i = 0; i < kThreads / 32; ++i) total += warp_sums[i];
    denom = total / static_cast<float>(hw) + 1e-6f;
  }

  float* o = out + ((static_cast<long long>(b) * (T - 1) + (t - 1)) * C + c0 + k)
                       * static_cast<long long>(P) * P;
  for (int i = threadIdx.x; i < P * P; i += kThreads) {
    const int p = i / P;
    const int q = i - p * P;
    float acc = 0.f;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int r = row_idx[2 * p + a];
      float racc = 0.f;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float re, im;
        product(cur, prev, r * w + col_idx[2 * q + c], re, im);
        float d = atan2f(im, re);
        if (weighting) d *= sqrtf(re * re + im * im) / denom;
        racc += col_wts[2 * q + c] * d;
      }
      acc += row_wts[2 * p + a] * racc;
    }
    o[i] = acc;
  }
}

}  // namespace

extern "C" int mimamo_phase_diff_resize(
    const void* band, void* out, const void* row_idx, const void* row_wts,
    const void* col_idx, const void* col_wts, int B, int T, int K, int h,
    int w, int P, int C, int c0, int weighting, void* stream) {
  const int pairs = B * (T - 1) * K;
  phase_diff_resize_kernel<<<pairs, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(band), static_cast<float*>(out),
      static_cast<const int*>(row_idx), static_cast<const float*>(row_wts),
      static_cast<const int*>(col_idx), static_cast<const float*>(col_wts),
      T, K, h, w, P, C, c0, weighting);
  return static_cast<int>(cudaGetLastError());
}
