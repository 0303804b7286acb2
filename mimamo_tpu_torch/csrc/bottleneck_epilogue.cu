// The epilogue of the backbone's cuDNN convs (FoldedResNet50._bottleneck),
// one pass a conv, in place on the conv's NHWC output y [P, C]:
//
//   after conv1 and conv2:  y = relu(y + b)
//   after conv3:            y = relu((y + b) + r)
//
// r is the block's input or, in a block with a projection, r = d + bd: the
// projection conv's raw output d and its bias bd, added inside this pass.
//
// Replaces no TPU kernel: XLA fused these elementwise ops into its convs.
// On the card PyTorch runs them after cuDNN returns as four or five
// elementwise kernels (the bias add through a broadcast path that does not
// vectorise). Bound by bytes: y read and written once, r (and d) read once.
// The design moves 16-byte vectors (8 bf16 or 4 fp32 channels of one
// pixel) with streaming loads, keeps the biases in shared memory as fp32,
// and runs a grid-stride loop over as many CTAs as the card holds at once,
// kUnroll vectors of each operand in flight a thread.
//
// The rounding is PyTorch's, bit for bit: each add in fp32 and rounded to
// the work dtype (round to nearest even for bf16), in the order
// ((y + b) + (d + bd)); relu as torch.relu on the card (NaN kept, else
// fmaxf with 0) on the rounded sum.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kMaxC = 2048;   // channels of the widest conv (layer4's conv3)

// 16 bytes of T as fp32 lanes, and PyTorch's rounding of an fp32 result.
template <typename T>
struct Vec;

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kLanes = 8;
  __device__ static void unpack(const uint4& u, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = __bfloat1622float2(h[i]);
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
  // every lane already holds a bf16 value: the conversion is exact
  __device__ static uint4 pack(const float* f) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    return u;
  }
  __device__ static float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  __device__ static float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
};

template <>
struct Vec<float> {
  static constexpr int kLanes = 4;
  __device__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
  __device__ static float round(float v) { return v; }
  __device__ static float load(const float* p) { return *p; }
};

// One vector: the lanes of y and r; b points at the conv bias of its
// channels in shared memory, the projection's bias kMaxC floats on.
template <typename T, bool kRes, bool kResBias>
__device__ __forceinline__ uint4 apply(const uint4& y, const uint4& r,
                                       const float* b) {
  using V = Vec<T>;
  constexpr int L = V::kLanes;
  float f[L], g[L], bb[L];
#pragma unroll
  for (int i = 0; i < L; i += 4)
    *reinterpret_cast<float4*>(bb + i) =
        *reinterpret_cast<const float4*>(b + i);
  V::unpack(y, f);
#pragma unroll
  for (int i = 0; i < L; ++i) f[i] = V::round(f[i] + bb[i]);
  if constexpr (kRes) {
    V::unpack(r, g);
    if constexpr (kResBias) {
#pragma unroll
      for (int i = 0; i < L; i += 4)
        *reinterpret_cast<float4*>(bb + i) =
            *reinterpret_cast<const float4*>(b + kMaxC + i);
#pragma unroll
      for (int i = 0; i < L; ++i) g[i] = V::round(g[i] + bb[i]);
    }
#pragma unroll
    for (int i = 0; i < L; ++i) f[i] = V::round(f[i] + g[i]);
  }
#pragma unroll
  for (int i = 0; i < L; ++i) f[i] = isnan(f[i]) ? f[i] : fmaxf(f[i], 0.0f);
  return V::pack(f);
}

// y: nvec 16-byte vectors, cvec of them a pixel (C = cvec * lanes). Thread
// t of CTA c takes, each round, the vectors c * kThreads * kUnroll + t +
// k * kThreads (k < kUnroll); a round moves the whole grid on by `step`
// vectors, so each of a thread's channel offsets moves on by step % cvec.
template <typename T, bool kRes, bool kResBias>
__global__ void __launch_bounds__(kThreads)
    epilogue_kernel(T* __restrict__ y, const T* __restrict__ bias,
                    const T* __restrict__ res, const T* __restrict__ res_bias,
                    long long nvec, int cvec) {
  constexpr int L = Vec<T>::kLanes;
  __shared__ __align__(16) float sb[kResBias ? 2 * kMaxC : kMaxC];
  const int C = cvec * L;
  for (int i = threadIdx.x; i < C; i += kThreads) {
    sb[i] = Vec<T>::load(bias + i);
    if constexpr (kResBias) sb[kMaxC + i] = Vec<T>::load(res_bias + i);
  }
  __syncthreads();

  const long long chunk = static_cast<long long>(kThreads) * kUnroll;
  const long long step = static_cast<long long>(gridDim.x) * chunk;
  const int advance = static_cast<int>(step % cvec);
  long long v0 = blockIdx.x * chunk + threadIdx.x;
  int ch[kUnroll];
#pragma unroll
  for (int k = 0; k < kUnroll; ++k)
    ch[k] = static_cast<int>((v0 + k * kThreads) % cvec);
  uint4* yv = reinterpret_cast<uint4*>(y);
  const uint4* rv = reinterpret_cast<const uint4*>(res);

  for (; v0 < nvec; v0 += step) {
    uint4 a[kUnroll], r[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long v = v0 + k * kThreads;
      if (v < nvec) {
        a[k] = __ldcs(yv + v);
        if constexpr (kRes) r[k] = __ldcs(rv + v);
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long v = v0 + k * kThreads;
      if (v < nvec)
        yv[v] = apply<T, kRes, kResBias>(a[k], r[k], sb + ch[k] * L);
      ch[k] += advance;
      if (ch[k] >= cvec) ch[k] -= cvec;
    }
  }
}

// CTAs of one launch: as many as the card holds at once, at most one a
// chunk of the data.
template <typename T, bool kRes, bool kResBias>
int launch(void* y, const void* bias, const void* res, const void* res_bias,
           long long nvec, int cvec, cudaStream_t stream) {
  auto kernel = epilogue_kernel<T, kRes, kResBias>;
  static int fits[64] = {};                // CTAs at once, per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!fits[dev]) {
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    fits[dev] = per_sm * sms;
  }
  const long long chunk = static_cast<long long>(kThreads) * kUnroll;
  const long long chunks = (nvec + chunk - 1) / chunk;
  const int ctas = static_cast<int>(chunks < fits[dev] ? chunks : fits[dev]);
  kernel<<<ctas, kThreads, 0, stream>>>(
      static_cast<T*>(y), static_cast<const T*>(bias),
      static_cast<const T*>(res), static_cast<const T*>(res_bias), nvec, cvec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(void* y, const void* bias, const void* res, const void* res_bias,
             long long nvec, int cvec, cudaStream_t stream) {
  if (res == nullptr)
    return launch<T, false, false>(y, bias, res, res_bias, nvec, cvec, stream);
  if (res_bias == nullptr)
    return launch<T, true, false>(y, bias, res, res_bias, nvec, cvec, stream);
  return launch<T, true, true>(y, bias, res, res_bias, nvec, cvec, stream);
}

}  // namespace

// y [P, C] NHWC in place, bias [C], res [P, C] or null, res_bias [C] or null
// (only with res); all bf16 (bf16 != 0) or all fp32, 16-byte aligned, with
// C = cvec * (8 bf16 or 4 fp32) <= 2048 and nvec = P * cvec > 0.
extern "C" int mimamo_bottleneck_epilogue(void* y, const void* bias,
                                          const void* res,
                                          const void* res_bias,
                                          long long nvec, int cvec, int bf16,
                                          void* stream) {
  const int lanes = bf16 ? 8 : 4;
  if (y == nullptr || bias == nullptr || nvec < 1 || cvec < 1 ||
      cvec * lanes > kMaxC || nvec % cvec ||
      (res == nullptr && res_bias != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(y, bias, res, res_bias, nvec, cvec, s)
              : dispatch<float>(y, bias, res, res_bias, nvec, cvec, s);
}
