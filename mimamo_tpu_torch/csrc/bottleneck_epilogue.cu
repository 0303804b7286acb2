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
//
// After conv3 of an SE-ResNet bottleneck the gate replaces that pass: two
// passes of their own, se_squeeze_kernel and se_scale_kernel, at the end of
// this file.
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

// CTAs of kThreads threads of `kernel` that the current device holds at
// once, into *out; `fits` caches it per device (64 devices). Returns a CUDA
// error code, 0 on success.
template <typename K>
int ctas_at_once(K kernel, int* fits, int* out) {
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
  *out = fits[dev];
  return 0;
}

// CTAs of one launch: as many as the card holds at once, at most one a
// chunk of the data.
template <typename T, bool kRes, bool kResBias>
int launch(void* y, const void* bias, const void* res, const void* res_bias,
           long long nvec, int cvec, cudaStream_t stream) {
  auto kernel = epilogue_kernel<T, kRes, kResBias>;
  static int fits[64] = {};                // CTAs at once, per device
  int at_once = 0;
  if (int e = ctas_at_once(kernel, fits, &at_once)) return e;
  const long long chunk = static_cast<long long>(kThreads) * kUnroll;
  const long long chunks = (nvec + chunk - 1) / chunk;
  const int ctas = static_cast<int>(chunks < at_once ? chunks : at_once);
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

// ---------------------------------------------------------------------------
// The squeeze-and-excitation gate of SE-ResNet-50 (Hu et al.,
// arXiv:1709.01507; FoldedResNet50 under BackboneSpec.se_reduction), on
// conv3's raw NHWC output y [N, HW, C] and its bias b, in two passes around
// the excitation (two small GEMMs that PyTorch runs between them):
//
//   squeeze:  s[n, c] = rnd(S[n, c] / HW),  S[n, c] = sum over p of
//                       rnd(y[n, p, c] + b[c]), summed in fp32
//   scale:    y = relu(rnd(rnd(rnd(y + b) * g[n, c]) + r))   (in place)
//
// rnd rounds an fp32 value to the work dtype (to nearest even for bf16; the
// identity for fp32), as PyTorch's bf16 ops round each result; each add and
// product is one IEEE fp32 operation (__fadd_rn, __fmul_rn: never contracted
// into an fma). r is the block's input or, in a block with a projection,
// r = rnd(d + bd), as in epilogue_kernel. relu as there. The scale pass is
// bit for bit kernels/bottleneck_epilogue.py's se_scale_plain; the squeeze
// sums in another order than its plain version (torch.mean), so the two
// agree to fp32 round-off before the final rounding.
//
// Replaces no TPU kernel: the JAX package has no SE gate. Bound by bytes:
// the gate's work needs y read once, r (or d) read once and the output
// written once. This design reads y twice (the squeeze needs each frame's
// whole map before the first output can be scaled, and cuDNN writes y
// first), so it tops out at 3/4 of that bound. The squeeze reads with the
// default cache policy and the scale walks the frames last to first, so the
// frames the squeeze read last may still be in L2.
//
// The squeeze's order is fixed by HW and C alone: a CTA takes one frame and
// a slice of up to kThreads channel vectors (`width` of them); a thread sums
// its vector's pixels p = row, row + rows, ... in that order, then the
// thread of row 0 adds the other rows' sums in row order. No atomics: a
// frame gets the same bits from run to run and whatever batch it comes in.

namespace {

// One vector of the scale pass: y's lanes, r's, and b, g and bd of the
// same channels.
template <typename T, bool kResBias>
__device__ __forceinline__ uint4 se_apply(const uint4& y, const uint4& r,
                                          const uint4& b, const uint4& g,
                                          const uint4& bd) {
  using V = Vec<T>;
  constexpr int L = V::kLanes;
  float f[L], rr[L], bb[L], gg[L];
  V::unpack(y, f);
  V::unpack(b, bb);
  V::unpack(g, gg);
  V::unpack(r, rr);
#pragma unroll
  for (int i = 0; i < L; ++i)
    f[i] = V::round(__fmul_rn(V::round(__fadd_rn(f[i], bb[i])), gg[i]));
  if constexpr (kResBias) {
    V::unpack(bd, bb);
#pragma unroll
    for (int i = 0; i < L; ++i) rr[i] = V::round(__fadd_rn(rr[i], bb[i]));
  }
#pragma unroll
  for (int i = 0; i < L; ++i) f[i] = V::round(__fadd_rn(f[i], rr[i]));
#pragma unroll
  for (int i = 0; i < L; ++i) f[i] = isnan(f[i]) ? f[i] : fmaxf(f[i], 0.0f);
  return V::pack(f);
}

// grid (ceil(cvec / width), N); s [N, C] in the work dtype.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    se_squeeze_kernel(const T* __restrict__ y, const T* __restrict__ bias,
                      T* __restrict__ s, int hw, int cvec, int width) {
  using V = Vec<T>;
  constexpr int L = V::kLanes;
  __shared__ __align__(16) float part[kThreads * L];
  const int rows = kThreads / width;
  const int row = threadIdx.x / width, col = threadIdx.x % width;
  const int cv = blockIdx.x * width + col;
  const bool active = row < rows && cv < cvec;
  float acc[L];
#pragma unroll
  for (int i = 0; i < L; ++i) acc[i] = 0.0f;
  if (active) {
    float b[L], f[L];
    V::unpack(__ldg(reinterpret_cast<const uint4*>(bias) + cv), b);
    const uint4* yv = reinterpret_cast<const uint4*>(y) +
                      static_cast<long long>(blockIdx.y) * hw * cvec + cv;
    for (int p0 = row; p0 < hw; p0 += rows * kUnroll) {
      uint4 a[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k)
        if (p0 + k * rows < hw)
          a[k] = __ldg(yv + static_cast<long long>(p0 + k * rows) * cvec);
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        if (p0 + k * rows < hw) {
          V::unpack(a[k], f);
#pragma unroll
          for (int i = 0; i < L; ++i)
            acc[i] = __fadd_rn(acc[i], V::round(__fadd_rn(f[i], b[i])));
        }
      }
    }
    if (row > 0) {
#pragma unroll
      for (int i = 0; i < L; ++i) part[threadIdx.x * L + i] = acc[i];
    }
  }
  __syncthreads();
  if (active && row == 0) {
    for (int r = 1; r < rows; ++r) {
      const float* other = part + (r * width + col) * L;
#pragma unroll
      for (int i = 0; i < L; ++i) acc[i] = __fadd_rn(acc[i], other[i]);
    }
    const float area = static_cast<float>(hw);
#pragma unroll
    for (int i = 0; i < L; ++i) acc[i] = __fdiv_rn(acc[i], area);
    reinterpret_cast<uint4*>(s)[static_cast<long long>(blockIdx.y) * cvec +
                                cv] = V::pack(acc);
  }
}

// grid (CTAs a frame, N). CTA (k, j) takes frame n = N - 1 - j; its thread t
// the frame's vectors k * kThreads * kUnroll + t + i * kThreads (i <
// kUnroll), a round moving on by the frame's whole grid, channels tracked
// as in epilogue_kernel.
template <typename T, bool kResBias>
__global__ void __launch_bounds__(kThreads)
    se_scale_kernel(T* __restrict__ y, const T* __restrict__ bias,
                    const T* __restrict__ gate, const T* __restrict__ res,
                    const T* __restrict__ res_bias, int hw, int cvec) {
  const long long n = gridDim.y - 1 - blockIdx.y;
  const long long nvec = static_cast<long long>(hw) * cvec;   // a frame's
  const long long chunk = static_cast<long long>(kThreads) * kUnroll;
  const long long step = static_cast<long long>(gridDim.x) * chunk;
  const int advance = static_cast<int>(step % cvec);
  long long v0 = blockIdx.x * chunk + threadIdx.x;
  int ch[kUnroll];
#pragma unroll
  for (int k = 0; k < kUnroll; ++k)
    ch[k] = static_cast<int>((v0 + k * kThreads) % cvec);
  uint4* yv = reinterpret_cast<uint4*>(y) + n * nvec;
  const uint4* rv = reinterpret_cast<const uint4*>(res) + n * nvec;
  const uint4* bv = reinterpret_cast<const uint4*>(bias);
  const uint4* gv = reinterpret_cast<const uint4*>(gate) + n * cvec;
  const uint4* dv = reinterpret_cast<const uint4*>(res_bias);

  for (; v0 < nvec; v0 += step) {
    uint4 a[kUnroll], r[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long v = v0 + k * kThreads;
      if (v < nvec) {
        a[k] = __ldcs(yv + v);
        r[k] = __ldcs(rv + v);
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long v = v0 + k * kThreads;
      if (v < nvec) {
        const uint4 bd = kResBias ? __ldg(dv + ch[k]) : a[k];
        yv[v] = se_apply<T, kResBias>(a[k], r[k], __ldg(bv + ch[k]),
                                      __ldg(gv + ch[k]), bd);
      }
      ch[k] += advance;
      if (ch[k] >= cvec) ch[k] -= cvec;
    }
  }
}

template <typename T>
int se_squeeze_launch(const void* y, const void* bias, void* s, int n, int hw,
                      int cvec, cudaStream_t stream) {
  const int width = cvec < kThreads ? cvec : kThreads;
  const dim3 grid((cvec + width - 1) / width, n);
  se_squeeze_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(y), static_cast<const T*>(bias),
      static_cast<T*>(s), hw, cvec, width);
  return static_cast<int>(cudaGetLastError());
}

// CTAs a frame: together as many as the card holds at once, at least one a
// frame and at most one a chunk of the frame.
template <typename T, bool kResBias>
int se_scale_launch(void* y, const void* bias, const void* gate,
                    const void* res, const void* res_bias, int n, int hw,
                    int cvec, cudaStream_t stream) {
  auto kernel = se_scale_kernel<T, kResBias>;
  static int fits[64] = {};
  int at_once = 0;
  if (int e = ctas_at_once(kernel, fits, &at_once)) return e;
  const long long chunk = static_cast<long long>(kThreads) * kUnroll;
  const long long chunks = (static_cast<long long>(hw) * cvec + chunk - 1) /
                           chunk;
  long long per_frame = at_once / n;
  if (per_frame > chunks) per_frame = chunks;
  if (per_frame < 1) per_frame = 1;
  const dim3 grid(static_cast<unsigned>(per_frame), n);
  kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<T*>(y), static_cast<const T*>(bias),
      static_cast<const T*>(gate), static_cast<const T*>(res),
      static_cast<const T*>(res_bias), hw, cvec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y [N, HW, C] NHWC (read only), bias [C], s [N, C] out; all bf16 (bf16 !=
// 0) or all fp32, 16-byte aligned, with C = cvec * (8 bf16 or 4 fp32) <=
// 2048, 1 <= n <= 65535 and hw >= 1.
extern "C" int mimamo_se_squeeze(const void* y, const void* bias, void* s,
                                 int n, int hw, int cvec, int bf16,
                                 void* stream) {
  const int lanes = bf16 ? 8 : 4;
  if (y == nullptr || bias == nullptr || s == nullptr || n < 1 ||
      n > 65535 || hw < 1 || cvec < 1 || cvec * lanes > kMaxC)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  return bf16 ? se_squeeze_launch<__nv_bfloat16>(y, bias, s, n, hw, cvec, st)
              : se_squeeze_launch<float>(y, bias, s, n, hw, cvec, st);
}

// y [N, HW, C] NHWC in place, bias [C], gate [N, C], res [N, HW, C],
// res_bias [C] or null; the same types, alignment and limits as
// mimamo_se_squeeze.
extern "C" int mimamo_se_scale(void* y, const void* bias, const void* gate,
                               const void* res, const void* res_bias, int n,
                               int hw, int cvec, int bf16, void* stream) {
  const int lanes = bf16 ? 8 : 4;
  if (y == nullptr || bias == nullptr || gate == nullptr || res == nullptr ||
      n < 1 || n > 65535 || hw < 1 || cvec < 1 || cvec * lanes > kMaxC)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return res_bias
               ? se_scale_launch<__nv_bfloat16, true>(y, bias, gate, res,
                                                      res_bias, n, hw, cvec, st)
               : se_scale_launch<__nv_bfloat16, false>(y, bias, gate, res,
                                                       res_bias, n, hw, cvec,
                                                       st);
  return res_bias ? se_scale_launch<float, true>(y, bias, gate, res, res_bias,
                                                 n, hw, cvec, st)
                  : se_scale_launch<float, false>(y, bias, gate, res,
                                                  res_bias, n, hw, cvec, st);
}
