// NHWC bf16 implicit-GEMM convolution with a fused bias/residual/relu
// epilogue: the building block of ResNet-50 layer2.
//
// Replaces the TPU kernel layer2_fused (mimamo_tpu/pallas/layer2_kernel.py,
// body _layer2_kernel; operands from pack_layer2_params). layer2_fused in
// mimamo_tpu_torch/kernels/layer2_kernel.py launches this kernel 13 times: the
// downsample projection, conv1, conv2 and conv3 of block 0 and conv1..conv3 of
// blocks 1-3, keeping the TPU kernel's rounding points (y1 and y2 rounded to
// bf16, the projection kept in fp32, residual add and relu in fp32, the
// residual stream in bf16).
//
// Bound on the H100: operations. layer2 is 1.90 GFLOP per 56x56x256 frame
// (730 GFLOP for 384 frames) against ~0.46 GB of activations in and out.
//
// Design: out[m, n] = sum_k A[m, k] W[n, k] with m = (image, oy, ox),
// n = output channel and k = (ky, kx, ci); A is gathered from the NHWC input
// on the fly (implicit GEMM: the im2col matrix never exists). A block computes
// a 128 x 128 output tile with 8 warps, each a 64 x 32 sub-tile of 16x16x16
// bf16 tensor-core fragments (nvcuda::wmma, fp32 accumulation). K advances
// 32 at a time through a 3-stage cp.async ring in shared memory; rows of A
// that fall in the zero padding, or past the last pixel, are zero-filled by
// the copy itself. The epilogue stages each warp's fragments in shared memory
// and applies bias, the optional residual (bf16 or fp32) and relu, storing
// bf16 or fp32. Cin must be a multiple of 32 and Cout of 128. wgmma/TMA and a
// single fused launch for the whole layer are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int kBM = 128, kBN = 128, kBK = 32, kStages = 3, kThreads = 256;
constexpr int kLd = kBK + 8;               // smem row pitch (bf16), 80 bytes
constexpr int kTileElems = kBM * kLd;      // one A or B stage
constexpr int kEpiLd = 32 + 4;             // epilogue pitch (floats)
constexpr int kPipeBytes = 2 * kStages * kTileElems * 2;
constexpr int kEpiBytes = 8 * 64 * kEpiLd * 4;
constexpr int kSmemBytes = kPipeBytes > kEpiBytes ? kPipeBytes : kEpiBytes;

struct ConvArgs {
  const __nv_bfloat16* x;     // [N, H, W, Cin]
  const __nv_bfloat16* w;     // [Cout, KH, KW, Cin]
  const float* bias;          // [Cout]
  const void* res;            // [N, Ho, Wo, Cout] or null
  void* out;                  // [N, Ho, Wo, Cout]
  int N, H, W, Cin, Cout, KH, KW, stride, pad, Ho, Wo;
  int res_f32, out_f32, relu;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;        // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__global__ void __launch_bounds__(kThreads)
conv_kernel(const ConvArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sb = sa + kStages * kTileElems;

  const int M = a.N * a.Ho * a.Wo;
  const int K = a.KH * a.KW * a.Cin;
  const int KT = K / kBK;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;

  // Each thread copies two 16-byte chunks of A and two of B per stage:
  // chunk c of 512 -> row c / 4, k-offset 8 * (c % 4).
  int a_img[2], a_iy[2], a_ix[2];
  bool a_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + (tid + i * kThreads) / 4;
    a_ok[i] = m < M;
    const int mm = a_ok[i] ? m : 0;
    const int ox = mm % a.Wo;
    const int oy = (mm / a.Wo) % a.Ho;
    a_img[i] = mm / (a.Wo * a.Ho);
    a_iy[i] = oy * a.stride - a.pad;
    a_ix[i] = ox * a.stride - a.pad;
  }

  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * kBK;
    const int tap = k0 / a.Cin;
    const int ci0 = k0 - tap * a.Cin;
    const int ky = tap / a.KW;
    const int kx = tap - ky * a.KW;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads;
      const int row = c / 4;
      const int koff = 8 * (c % 4);
      const int iy = a_iy[i] + ky;
      const int ix = a_ix[i] + kx;
      const bool ok = a_ok[i] && iy >= 0 && iy < a.H && ix >= 0 && ix < a.W;
      const __nv_bfloat16* src =
          ok ? a.x + ((static_cast<long long>(a_img[i]) * a.H + iy) * a.W + ix)
                         * a.Cin + ci0 + koff
             : a.x;
      cp_async16(sa + stage * kTileElems + row * kLd + koff, src, ok);
      const __nv_bfloat16* wsrc =
          a.w + static_cast<long long>(n0 + row) * K + k0 + koff;
      cp_async16(sb + stage * kTileElems + row * kLd + koff, wsrc, true);
    }
  };

  const int warp = tid / 32;
  const int wm = warp / 4;                 // 0..1: 64-row half
  const int wn = warp % 4;                 // 0..3: 32-col quarter
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = kt + kStages - 1;
    if (next < KT) load_stage(next % kStages, next);
    cp_async_commit();
    const __nv_bfloat16* ta = sa + (kt % kStages) * kTileElems;
    const __nv_bfloat16* tb = sb + (kt % kStages) * kTileElems;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(fa[i], ta + (wm * 64 + i * 16) * kLd + kk, kLd);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], tb + (wn * 32 + j * 16) * kLd + kk, kLd);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // Epilogue: stage this warp's 64 x 32 tile, then one row per step with
  // the 32 lanes on 32 consecutive output channels.
  float* tile = reinterpret_cast<float*>(smem) + warp * 64 * kEpiLd;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(tile + i * 16 * kEpiLd + j * 16, acc[i][j],
                              kEpiLd, wmma::mem_row_major);
  __syncwarp();
  const int lane = tid % 32;
  const int n = n0 + wn * 32 + lane;
  const float b = a.bias[n];
  for (int r = 0; r < 64; ++r) {
    const int m = m0 + wm * 64 + r;
    if (m >= M) break;
    const long long o = static_cast<long long>(m) * a.Cout + n;
    float v = tile[r * kEpiLd + lane] + b;
    if (a.res) {
      v += a.res_f32 ? static_cast<const float*>(a.res)[o]
                     : __bfloat162float(static_cast<const __nv_bfloat16*>(a.res)[o]);
    }
    if (a.relu) v = fmaxf(v, 0.f);
    if (a.out_f32)
      static_cast<float*>(a.out)[o] = v;
    else
      static_cast<__nv_bfloat16*>(a.out)[o] = __float2bfloat16_rn(v);
  }
}

}  // namespace

extern "C" int mimamo_conv_nhwc(const void* x, const void* w, const void* bias,
                                const void* res, void* out, int N, int H, int W,
                                int Cin, int Cout, int KH, int KW, int stride,
                                int pad, int res_f32, int out_f32, int relu,
                                void* stream) {
  ConvArgs a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.bias = static_cast<const float*>(bias);
  a.res = res;
  a.out = out;
  a.N = N; a.H = H; a.W = W; a.Cin = Cin; a.Cout = Cout;
  a.KH = KH; a.KW = KW; a.stride = stride; a.pad = pad;
  a.Ho = (H + 2 * pad - KH) / stride + 1;
  a.Wo = (W + 2 * pad - KW) / stride + 1;
  a.res_f32 = res_f32; a.out_f32 = out_f32; a.relu = relu;
  cudaError_t err = cudaFuncSetAttribute(
      conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long M = static_cast<long long>(N) * a.Ho * a.Wo;
  const dim3 grid(static_cast<unsigned>((M + kBM - 1) / kBM), Cout / kBN);
  conv_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
