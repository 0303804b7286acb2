// Fused ResNet stem: mean-sub + exact 2x upscale + conv1 7x7/2 + bias + relu
// + maxpool 3x3/2, from the S x S crop to the [N, S/2, S/2, 64] bf16 map.
//
// Replaces the TPU kernel stem_fused (mimamo_tpu/pallas/stem_kernel.py, body
// _stem_kernel; operands from prepare_stem_weights/prepare_stem_input), which
// the TPU path computed as composite_stem.
//
// Bound on the H100: operations. conv1 on the 2S x 2S grid is 147 MACs per
// conv pixel and channel (90.6 GFLOP for 384 crops of 112^2) against ~212 MB
// of crop read plus pooled map written.
//
// Design: one block per (crop, strip of kRows pooled rows). The block forms
// the strip's upscaled rows in shared memory on the fly from the crop (fp32
// mean-sub and interleave upscale, rounded to bf16 where conv1 casts; zero
// rows/cols outside [0, 2S) are conv1's zero padding), so the 2S x 2S image
// never reaches device memory. Each thread computes two conv pixels x 32
// channels with fp32 FMAs on the bf16-valued operands, adds the bias, applies
// relu, and stores the strip's 2*kRows+1 conv rows to shared memory as bf16
// (rounding commutes with max); the block then max-pools them and writes
// only the pooled rows. Conv rows outside [0, S) hold zero, which is the
// pool's padding since post-relu values are >= 0. This first version uses
// SIMT FMAs, not tensor cores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 2;                  // pooled rows per block
constexpr int kConvRows = 2 * kRows + 1;  // conv rows per block
constexpr int kURows = 4 * kRows + 7;     // upscaled rows per block
constexpr int kTaps = 147;                // 7 * 7 * 3
constexpr int kOut = 64;

// floats of the upscaled strip, rounded up so the weights after it stay
// 16-byte aligned for float4 loads
__host__ __device__ inline int strip_floats(int S) {
  return (kURows * (2 * S + 6) * 3 + 3) / 4 * 4;
}

// Row-interpolated crop value at crop (row of upscaled row ur, column col),
// for channel ch, mean already subtracted. ur in [0, 2S).
__device__ __forceinline__ float row_interp(const float* img, int S, int ur,
                                           int col, int ch, float mean) {
  const int i = ur >> 1;
  const int nb = (ur & 1) ? min(i + 1, S - 1) : max(i - 1, 0);
  const float x = img[(i * S + col) * 3 + ch] - mean;
  const float y = img[(nb * S + col) * 3 + ch] - mean;
  return (ur & 1) ? __fadd_rn(__fmul_rn(0.75f, x), __fmul_rn(0.25f, y))
                  : __fadd_rn(__fmul_rn(0.25f, y), __fmul_rn(0.75f, x));
}

__device__ __forceinline__ float upscaled(const float* img, int S, int ur,
                                          int uc, int ch, float mean) {
  if (ur < 0 || ur >= 2 * S || uc < 0 || uc >= 2 * S) return 0.f;
  const int j = uc >> 1;
  const int nb = (uc & 1) ? min(j + 1, S - 1) : max(j - 1, 0);
  const float x = row_interp(img, S, ur, j, ch, mean);
  const float y = row_interp(img, S, ur, nb, ch, mean);
  const float u = (uc & 1) ? __fadd_rn(__fmul_rn(0.75f, x), __fmul_rn(0.25f, y))
                           : __fadd_rn(__fmul_rn(0.25f, y), __fmul_rn(0.75f, x));
  return __bfloat162float(__float2bfloat16_rn(u));
}

__global__ void __launch_bounds__(kThreads)
stem_kernel(const float* __restrict__ crops, const __nv_bfloat16* __restrict__ w,
            const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
            int S, float m0, float m1, float m2) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int uw = 2 * S + 6;                    // upscaled cols -3 .. 2S+2
  float* su = reinterpret_cast<float*>(smem);  // [kURows][uw][3]
  float* sw = su + strip_floats(S);           // [kTaps][64]
  __nv_bfloat16* sc = reinterpret_cast<__nv_bfloat16*>(sw + kTaps * kOut);
                                               // [kConvRows][S][64]
  const int sp = S / 2;
  const int strips = (sp + kRows - 1) / kRows;
  const int n = blockIdx.x / strips;
  const int pr0 = (blockIdx.x % strips) * kRows;
  const float* img = crops + static_cast<long long>(n) * S * S * 3;
  const float mean[3] = {m0, m1, m2};

  const int ur0 = 4 * pr0 - 5;                 // first upscaled row
  for (int i = threadIdx.x; i < kURows * uw * 3; i += kThreads) {
    const int ch = i % 3;
    const int col = (i / 3) % uw;
    const int row = i / (3 * uw);
    su[i] = upscaled(img, S, ur0 + row, col - 3, ch, mean[ch]);
  }
  for (int i = threadIdx.x; i < kTaps * kOut; i += kThreads)
    sw[i] = __bfloat162float(w[i]);
  __syncthreads();

  // conv: item -> (local conv row j, conv cols 2m and 2m+1, channel half)
  const int items = kConvRows * (S / 2) * 2;
  for (int item = threadIdx.x; item < items; item += kThreads) {
    const int half = item & 1;
    const int m = (item >> 1) % (S / 2);
    const int j = (item >> 1) / (S / 2);
    const int c0 = 2 * m;
    const int oc0 = 32 * half;
    float acc0[32], acc1[32];
#pragma unroll
    for (int o = 0; o < 32; ++o) acc0[o] = acc1[o] = 0.f;
    for (int ky = 0; ky < 7; ++ky) {
      const float* row = su + (2 * j + ky) * uw * 3;
      for (int kx = 0; kx < 7; ++kx) {
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          const float v0 = row[(2 * c0 + kx) * 3 + ch];
          const float v1 = row[(2 * c0 + 2 + kx) * 3 + ch];
          const float4* wt = reinterpret_cast<const float4*>(
              sw + ((ky * 7 + kx) * 3 + ch) * kOut + oc0);
#pragma unroll
          for (int o4 = 0; o4 < 8; ++o4) {
            const float4 wv = wt[o4];
            acc0[4 * o4 + 0] += v0 * wv.x;
            acc0[4 * o4 + 1] += v0 * wv.y;
            acc0[4 * o4 + 2] += v0 * wv.z;
            acc0[4 * o4 + 3] += v0 * wv.w;
            acc1[4 * o4 + 0] += v1 * wv.x;
            acc1[4 * o4 + 1] += v1 * wv.y;
            acc1[4 * o4 + 2] += v1 * wv.z;
            acc1[4 * o4 + 3] += v1 * wv.w;
          }
        }
      }
    }
    const int cr = 2 * pr0 - 1 + j;            // global conv row
    const bool valid = cr >= 0 && cr < S;
    __nv_bfloat16* dst0 = sc + (j * S + c0) * kOut + oc0;
    __nv_bfloat16* dst1 = dst0 + kOut;
#pragma unroll
    for (int o = 0; o < 32; ++o) {
      const float b = bias[oc0 + o];
      dst0[o] = __float2bfloat16_rn(valid ? fmaxf(acc0[o] + b, 0.f) : 0.f);
      dst1[o] = __float2bfloat16_rn(valid ? fmaxf(acc1[o] + b, 0.f) : 0.f);
    }
  }
  __syncthreads();

  // 3x3/2 max pool of the strip's conv rows
  for (int i = threadIdx.x; i < kRows * sp * kOut; i += kThreads) {
    const int oc = i % kOut;
    const int pc = (i / kOut) % sp;
    const int r = i / (kOut * sp);
    if (pr0 + r >= sp) continue;
    float best = 0.f;
    for (int dj = 0; dj < 3; ++dj) {
      const __nv_bfloat16* row = sc + (2 * r + dj) * S * kOut;
      for (int dc = -1; dc <= 1; ++dc) {
        const int cc = 2 * pc + dc;
        if (cc >= 0) best = fmaxf(best, __bfloat162float(row[cc * kOut + oc]));
      }
    }
    out[((static_cast<long long>(n) * sp + pr0 + r) * sp + pc) * kOut + oc] =
        __float2bfloat16_rn(best);
  }
}

}  // namespace

extern "C" int mimamo_stem_smem_bytes(int S) {
  return (strip_floats(S) + kTaps * kOut) * 4 +
         kConvRows * S * kOut * 2;
}

extern "C" int mimamo_stem(const void* crops, const void* w, const void* bias,
                           void* out, int N, int S, float m0, float m1,
                           float m2, void* stream) {
  const int smem = mimamo_stem_smem_bytes(S);
  cudaError_t err = cudaFuncSetAttribute(
      stem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int strips = (S / 2 + kRows - 1) / kRows;
  stem_kernel<<<N * strips, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(crops), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), S, m0,
      m1, m2);
  return static_cast<int>(cudaGetLastError());
}
