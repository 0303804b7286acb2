// Phase difference + bilinear resize of consecutive band frames, all
// pyramid scales in one launch.
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
// Design. The resize is separable and each output row has two source-row
// taps, so a strip of output rows p0..p1 needs only a known span of source
// rows. A block owns one strip of one (scale, b, k) plane and walks a run
// of consecutive frames: frame t's strip is copied into shared memory as
// whole rows with cp.async (16 bytes a thread where the address allows,
// 8-byte pieces at a ragged head or tail), stays there as `prev` for pair
// t + 1, and the copy of frame t + 1 is in flight while pair t is computed.
// So every byte of the band is requested once, in full lines. dphi is
// computed once per source pixel into shared memory; the 2 x 2 taps of the
// resize then read shared memory, and the strip's output rows are written
// as one contiguous piece at the scale's channel offset of the final
// [B, T-1, S*K, P, P] buffer. The strips of all scales are blocks of one
// grid (a table of scales comes in by value), so a forward is one launch.
//
// Amplitude weighting needs the mean of |prod| over the whole plane, which
// no strip sees. Each block writes its un-normalised rows (dphi * |prod|,
// resized; the division by the mean commutes with the resize) and the sum
// of |prod| over the source rows it owns (the strips' owned rows partition
// the plane); the block that finishes a plane last adds the partial sums in
// strip order, so the result does not depend on the order of arrival, and
// divides the plane's P x P outputs, which are still in L2.
//
// The kernel is short of issue slots before it is short of bytes (one
// angle per source pixel is most of its instructions), so the angle is the
// TPU kernel's odd minimax polynomial (max error 8.8e-8 rad) with an
// approximate division, about half the instructions of atan2f, and it keeps
// atan2f's results at zeros: atan2(+-0, x >= +0) = +-0, atan2(+-0, x <= -0)
// = +-pi. The product is rounded exactly as PyTorch's complex multiply
// rounds it (one product rounded, the other fused), so that a pixel whose
// angle sits at the +-pi wrap falls on the same side as in the plain
// version.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
// Blocks per SM the register allocation leaves room for: what 8 KB strips
// let an SM hold in shared memory (7 x 29 KB). That caps the kernel at 72
// registers, which it fits without a spill; at 8 (64 registers) it spills.
constexpr int kMinBlocks = 7;
constexpr int kMaxScales = 8;
constexpr int kAhead = 1;           // frames whose copies are in flight
constexpr int kBufs = kAhead + 2;   // those, prev and cur

// One pyramid scale. `strips` holds 6 ints per strip: first and end output
// row, first source row held and number of rows held, first and end source
// row owned (for the weighting sum). Taps: 2 per output row / column.
struct Scale {
  const float2* band;               // [B, T, K, h, w]
  const int* strips;
  const int* row_idx;
  const float* row_wts;
  const int* col_idx;
  const float* col_wts;
  int h, w, c0, ns, first_block, pad;
};

struct Params {
  Scale scale[kMaxScales];
  float* out;                       // [B, T-1, C, P, P]
  float* partial;                   // [n_scales, B, T-1, K, ns_max]
  int* count;                       // [n_scales, B, T-1, K], zero on entry
  int n_scales, B, T, K, P, C;
  int run_len;                      // pairs a block walks
  int weighting;
  int buf_elems;                    // capacity of a strip buffer, 0 mod 4
  int ns_max;
  int tab_rows;                     // most output rows a strip has
};

__device__ __forceinline__ void cp_async_8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Returns once all but the newest N committed groups have landed.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 1 when `src` is 8 but not 16 bytes aligned. The strip is then stored one
// element into its (16-byte aligned) buffer, so that source and destination
// share their alignment and the body can go in 16-byte pieces.
__device__ __forceinline__ int shift_of(const float2* src) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 3) & 1);
}

// Start the copy of n elements from src into buf + shift_of(src).
__device__ __forceinline__ void load_strip(float2* buf, const float2* src,
                                           int n) {
  const int head = shift_of(src);            // elements before 16-byte body
  float2* dst = buf + head;
  const int body = (n - head) >> 1;          // 16-byte pieces
  for (int i = threadIdx.x; i < body; i += kThreads)
    cp_async_16(dst + head + 2 * i, src + head + 2 * i);
  if (threadIdx.x == 0) {
    if (head) cp_async_8(dst, src);
    if ((n - head) & 1) cp_async_8(dst + n - 1, src + n - 1);
  }
}

// atan2(y, x): octant fold onto t = min/max in [0, 1], atan(t) = t * poly(t^2).
__device__ __forceinline__ float fast_atan2(float y, float x) {
  const float ay = fabsf(y), ax = fabsf(x);
  const float t = __fdividef(fminf(ax, ay), fmaxf(fmaxf(ax, ay), 1e-30f));
  const float z = t * t;
  float poly = -4.831131187e-03f;
  poly = fmaf(poly, z, 2.475666561e-02f);
  poly = fmaf(poly, z, -6.021899162e-02f);
  poly = fmaf(poly, z, 9.967915930e-02f);
  poly = fmaf(poly, z, -1.404013684e-01f);
  poly = fmaf(poly, z, 1.997368115e-01f);
  poly = fmaf(poly, z, -3.333230283e-01f);
  poly = fmaf(poly, z, 9.999999582e-01f);
  float a = t * poly;
  if (ay > ax) a = 1.57079632679489662f - a;
  if (signbit(x)) a = 3.14159265358979324f - a;
  a = copysignf(a, y);
  return (x + y != x + y) ? x + y : a;       // NaN in, NaN out
}

// The two taps of one output row or column: offsets into the strip's dphi
// (rows: (source row - r0) * w; columns: source column) and their weights.
struct __align__(16) Taps {
  int i0, i1;
  float w0, w1;
};

__global__ void __launch_bounds__(kThreads, kMinBlocks)
phase_diff_resize_kernel(const __grid_constant__ Params prm) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float warp_sums[kThreads / 32];
  __shared__ int is_last;

  int s = 0;
  while (s + 1 < prm.n_scales &&
         static_cast<int>(blockIdx.x) >= prm.scale[s + 1].first_block)
    ++s;
  const Scale& sc = prm.scale[s];
  const int T = prm.T, K = prm.K, P = prm.P, C = prm.C;
  const int h = sc.h, w = sc.w, ns = sc.ns;
  const int tid = threadIdx.x;

  int r = static_cast<int>(blockIdx.x) - sc.first_block;
  const int j = r % ns;   r /= ns;           // strip: neighbours share rows
  const int k = r % K;    r /= K;
  const int b = r % prm.B;
  const int run = r / prm.B;
  const int t0 = run * prm.run_len;          // frames t0 .. t1
  const int t1 = min(t0 + prm.run_len, T - 1);

  const int* st = sc.strips + 6 * j;
  const int p0 = st[0], p1 = st[1], r0 = st[2], nr = st[3];
  const int own0 = st[4], own1 = st[5];
  const int n = nr * w;                      // elements of one strip
  const int n_out = (p1 - p0) * P;

  const int stride = prm.buf_elems + 2;      // even: buffers stay aligned
  float2* bufs = reinterpret_cast<float2*>(smem);
  float* dphi = reinterpret_cast<float*>(bufs + kBufs * stride);
  Taps* row_taps = reinterpret_cast<Taps*>(dphi + prm.buf_elems);
  Taps* col_taps = row_taps + prm.tab_rows;
  for (int x = tid; x < p1 - p0 + P; x += kThreads) {
    const bool is_row = x < p1 - p0;
    const int v = is_row ? p0 + x : x - (p1 - p0);
    const int* idx = (is_row ? sc.row_idx : sc.col_idx) + 2 * v;
    const float* wts = (is_row ? sc.row_wts : sc.col_wts) + 2 * v;
    Taps tp;
    tp.i0 = is_row ? (idx[0] - r0) * w : idx[0];
    tp.i1 = is_row ? (idx[1] - r0) * w : idx[1];
    tp.w0 = wts[0];
    tp.w1 = wts[1];
    (is_row ? row_taps + x : col_taps + v)[0] = tp;
  }
  // elements of the strip whose rows this block owns (weighting sum)
  const int e_own0 = (own0 - r0) * w, e_own1 = (own1 - r0) * w;
  const float inv_p = 1.f / static_cast<float>(P);

  const long long hw = static_cast<long long>(h) * w;
  const long long frame = K * hw;            // elements from frame to frame
  const float2* src = sc.band + ((static_cast<long long>(b) * T + t0) * K + k) * hw
                      + static_cast<long long>(r0) * w;

  for (int a = 0; a < kAhead; ++a) {         // one group per frame, in order
    if (t0 + a <= t1) load_strip(bufs + a * stride, src + a * frame, n);
    cp_async_commit();
  }
  for (int i = 0; t0 + i <= t1; ++i, src += frame) {
    cp_async_wait<kAhead - 1>();
    __syncthreads();       // frame t0+i is in; pair i-1 is done with its buffers
    if (t0 + i + kAhead <= t1)               // into the buffer of frame i-2
      load_strip(bufs + ((i + kAhead) % kBufs) * stride, src + kAhead * frame, n);
    cp_async_commit();
    if (i == 0) continue;

    const float2* cur = bufs + (i % kBufs) * stride + shift_of(src);
    const float2* prev = bufs + ((i - 1) % kBufs) * stride + shift_of(src - frame);
    float sum = 0.f;
#pragma unroll 4
    for (int e = tid; e < n; e += kThreads) {
      const float2 a = cur[e];
      const float2 q = prev[e];
      const float re = __fmaf_rn(a.x, q.x, __fmul_rn(a.y, q.y));
      const float im = __fmaf_rn(-a.x, q.y, __fmul_rn(a.y, q.x));
      float d = fast_atan2(im, re);
      if (prm.weighting) {
        const float amp = sqrtf(re * re + im * im);
        d *= amp;
        if (e >= e_own0 && e < e_own1) sum += amp;
      }
      dphi[e] = d;
    }
    if (prm.weighting) {
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if ((tid & 31) == 0) warp_sums[tid >> 5] = sum;
    }
    __syncthreads();

    const int t = t0 + i;                    // frame t pairs with t-1
    float* plane = prm.out + ((static_cast<long long>(b) * (T - 1) + (t - 1)) * C
                              + sc.c0 + k) * static_cast<long long>(P) * P;
    float* o = plane + p0 * P;
    for (int x = tid; x < n_out; x += kThreads) {
      // x / P without the integer division: exact while P * P < 2^22,
      // which the wrapper checks
      const int pr = __float2int_rd((static_cast<float>(x) + 0.5f) * inv_p);
      const Taps rt = row_taps[pr];
      const Taps ct = col_taps[x - pr * P];
      const float top = ct.w0 * dphi[rt.i0 + ct.i0] + ct.w1 * dphi[rt.i0 + ct.i1];
      const float bot = ct.w0 * dphi[rt.i1 + ct.i0] + ct.w1 * dphi[rt.i1 + ct.i1];
      o[x] = rt.w0 * top + rt.w1 * bot;
    }

    if (prm.weighting) {
      const long long pair =
          ((static_cast<long long>(s) * prm.B + b) * (T - 1) + (t - 1)) * K + k;
      __syncthreads();                       // the block's rows are written
      if (tid == 0) {
        float total = 0.f;
        for (int v = 0; v < kThreads / 32; ++v) total += warp_sums[v];
        prm.partial[pair * prm.ns_max + j] = total;
        // release the block's rows and its sum (the barrier above orders
        // the other threads' writes before this fence), then take a ticket
        __threadfence();
        is_last = atomicAdd(prm.count + pair, 1) == ns - 1;
      }
      __syncthreads();
      if (is_last) {                         // every strip of the plane is out
        __threadfence();
        float total = 0.f;
        for (int v = 0; v < ns; ++v)
          total += __ldcg(prm.partial + pair * prm.ns_max + v);
        const float denom = total / static_cast<float>(hw) + 1e-6f;
        for (int x = tid; x < P * P; x += kThreads)
          plane[x] = __ldcg(plane + x) / denom;
      }
    }
  }
}

}  // namespace

extern "C" int mimamo_phase_diff_resize(const void* params, int n_blocks,
                                        int smem_bytes, void* stream) {
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        phase_diff_resize_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  phase_diff_resize_kernel<<<n_blocks, kThreads, smem_bytes,
                             static_cast<cudaStream_t>(stream)>>>(
      *static_cast<const Params*>(params));
  return static_cast<int>(cudaGetLastError());
}
