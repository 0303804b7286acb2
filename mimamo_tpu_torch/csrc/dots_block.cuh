// The dot sequence of one bottleneck block of the two floor probes, on
// Hopper: one launch per block, conv1 -> conv2 -> conv3 (+ projection) in
// one CTA, as in layer2.cu, with no tap shifts and no pad masks.
//
// Replaces the dots-only Pallas kernels of the probes: `make_kernel_dots`
// of bench/layer1_probe.py (called by layer1_dots) and of
// bench/layer2_probe.py (layer2_fused_g4(dots_only=True)). layer1_dots.cu
// and layer2_dots.cu instantiate it; the wrappers are
// kernels/layer1_dots_kernel.py and layer2_dots in kernels/layer2_kernel.py.
//
// The function. A frame's state is P positions ("grid rows" of a padded
// grid of row stride G, flattened) x cin channels, bf16. For output
// position f:
//   y1[f]  = relu(s[f] . W1 + b1) in bf16, 0 for f outside [0, P)
//   acc[f] = sum over dy of [y1, y1, y1][f + G (dy - 1)] . W2[dy]
//            (K = 3 W: the probe packs its dx taps into K but shifts none)
//   y2[f]  = relu(acc[f] + b2) in bf16
//   out[f] = relu(y2[f] . W3 + b3 + res[f]) in bf16, where res is
//            s[f] . Wd + bd (the projection) or s[f] (identity)
// fp32 accumulation throughout. The block's source rows are read through
// a row map: s[f] = src[n, ((f % wrap) / seg) * seg_stride
// + ((f % wrap) % seg) * cin] for 0 <= f < P, which gives the probes'
// repeated inputs (layer1: x[:576] after the 3,136 pixels; layer2: the
// even-row plane of a [N, 28, 2, 28, 512] tensor, rows of 28 pixels 2 x 28
// pixels apart, repeated after 784) and the stored state of the next
// blocks (wrap = seg = P). The last block writes a crop of the grid, the
// others the whole P x OUT state.
//
// Bound on the H100: operations (see the wrappers for the counts).
//
// Design (layer2.cu's tile structure). A CTA owns 128 output positions
// (two wgmma m64 tiles, one per consumer warpgroup) of one frame and
// computes y1 on them and on one grid row (G positions) above and below.
// Sources and weights come by TMA into a 3-slot mbarrier ring. The
// source is a 4-D tensor map [N, segments, seg, cin] read in boxes of R
// rows, R the largest of 64, 32, ... that divides G (where the
// projection's rows start) and, for a wrapped source, seg, wrap and P, so
// that no box crosses a segment, the wrap or the grid's end: R = 64 for
// layer1, 32 for the layer2 states, 4 for the layer2 plane (28-pixel
// rows). A box's rows land where a single box would put them, in the
// 128-byte swizzle, which TMA applies by shared-memory address; the 32
// lanes of the producer warp issue a chunk's boxes together, from a table
// of box coordinates made once per CTA. y1 is kept without swizzle
// (8-row x 16-byte core matrices)
// so a dy tap is a step of the descriptor; conv2's three K blocks of each
// tap point at the same y1 rows. y2 overwrites y1; conv3 and the
// projection accumulate into the same registers, 128 output channels at
// a time; the epilogue stages the tile in shared memory and writes it with
// 16-byte stores.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace dots {

using namespace hopper;

constexpr int kStages = 3;
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 32;
constexpr int kM = 128;                      // output positions per CTA
constexpr int kWBytes = 128 * 128;           // weight chunk: <= 128 rows x 64 k
constexpr int kStgPitch = (128 + 8) * 2;     // output staging row, bytes
constexpr int kStgBytes = 64 * kStgPitch;

struct Params {
  CUtensorMap x, w1, w2, w3, wd;
  const __nv_bfloat16* src;
  __nv_bfloat16* out;
  const float* b1;
  const float* b2;
  const float* b3;
  const float* bd;          // projection bias, or null
  long long frame_stride;   // source elements between frames
  long long seg_stride;     // source elements between segments of seg rows
  int wrap, seg, cin;
  int box;                  // source rows a TMA box
  int kc1;                  // 64-channel K chunks of conv1 and the projection
  int proj;                 // projection (else identity residual)
  int crop_h, crop_w, crop_r0, crop_c0;  // crop_h == 0: whole state out
};

// G: grid row stride; W: bottleneck width; OUT: output channels; P: grid
// positions a frame.
template <int G, int W, int OUT, int P>
struct Shape {
  static constexpr int kM1 = kM + 2 * G;            // y1 rows
  static constexpr int kXBytes = kM1 * 128;         // source chunk: 64 ch
  static constexpr int kSlotBytes = kXBytes + kWBytes;
  static constexpr int kYLbo = kM1 * 16;            // bytes between 8-ch groups
  static constexpr int kYBytes = (W / 8) * kYLbo;
  static constexpr int kBiasFloats = 2 * W + OUT;   // b1 | b2 | b3 (+ bd)
  static constexpr int kBoxes = kM1 / 4;           // most boxes a chunk
  static constexpr int kSmemBytes = 1024 + kStages * kSlotBytes + kYBytes +
                                    2 * kStgBytes + 4 * kBiasFloats +
                                    8 * kBoxes + 2 * kStages * 8;
  static constexpr int kTiles = (P + kM - 1) / kM;
  static_assert(kM % G == 0 && (W == 64 || W == 128) && OUT % 128 == 0, "");
};

struct Ring {
  int slot = 0;
  uint32_t phase = 0;
  __device__ void next() {
    if (++slot == kStages) {
      slot = 0;
      phase ^= 1;
    }
  }
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int N>
__device__ __forceinline__ void wgmma_n(float* d, uint64_t da, uint64_t db,
                                        int scale_d) {
  if constexpr (N == 64)
    wgmma_n64(d, da, db, scale_d);
  else
    wgmma_n128(d, da, db, scale_d);
}

template <int G, int W, int OUT, int P>
__global__ void __launch_bounds__(kThreads, 1)
dots_block_kernel(const __grid_constant__ Params p) {
  using S = Shape<G, W, OUT, P>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* ybuf = ring + kStages * S::kSlotBytes;
  unsigned char* stg = ybuf + S::kYBytes;
  float* bias = reinterpret_cast<float*>(stg + 2 * kStgBytes);
  int2* boxes = reinterpret_cast<int2*>(bias + S::kBiasFloats);
  uint64_t* full = reinterpret_cast<uint64_t*>(boxes + S::kBoxes);
  uint64_t* empty = full + kStages;

  const int n = blockIdx.x / S::kTiles;
  const int tile0 = (blockIdx.x % S::kTiles) * kM;   // first output position
  const int f0 = tile0 - G;                          // first y1 position
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    fence_mbar_init();
  }
  // (row in segment, segment) of the box at y1 positions f0 + box * b.
  // Unwrapped sources take the box as it falls (TMA zero-fills rows
  // outside [0, P)); a wrapped one is all zeros outside [0, P).
  for (int b = tid; b < S::kM1 / p.box; b += kThreads) {
    const int f = f0 + b * p.box;
    int2 c = make_int2(f, 0);
    if (p.wrap < P) {
      const int fw = f % p.wrap;
      c = f >= 0 && f < P ? make_int2(fw % p.seg, fw / p.seg)
                          : make_int2(-p.box, 0);
    }
    boxes[b] = c;
  }
  for (int i = tid; i < S::kBiasFloats; i += kThreads) {
    const int c = i - 2 * W;
    bias[i] = i < W       ? p.b1[i]
              : i < 2 * W ? p.b2[i - W]
                          : p.b3[c] + (p.bd ? p.bd[c] : 0.f);
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producer warp: every load by TMA ----
    const int lane = tid - kConsumers;
    Ring r;
    // y1 rows [q0, q0 + nq), channels [c0, c0 + 64) of the source, and a
    // weight chunk
    auto load = [&](int q0, int nq, int c0, const CUtensorMap* wmap, int wk,
                    int wn, uint32_t wbytes) {
      mbar_wait(&empty[r.slot], r.phase ^ 1);
      unsigned char* slot = ring + r.slot * S::kSlotBytes;
      if (lane == 0) {
        mbar_expect_tx(&full[r.slot], nq * 128 + wbytes);
        tma_load_2d(slot + S::kXBytes, wmap, &full[r.slot], wk, wn);
      }
      __syncwarp();
      for (int b = lane; b < nq / p.box; b += 32) {
        const int2 c = boxes[q0 / p.box + b];
        tma_load_4d(slot + b * p.box * 128, &p.x, &full[r.slot], c0, c.x, c.y,
                    n);
      }
      r.next();
    };
    for (int kc = 0; kc < p.kc1; ++kc)
      load(0, S::kM1, 64 * kc, &p.w1, 64 * kc, 0, W * 128);
    for (int t = 0; t < 9; ++t)               // (dy, K block of 3 W)
      for (int h = 0; h < W / 64; ++h)
        load(0, 0, 0, &p.w2, W * t + 64 * h, 0, W * 128);
    for (int nc = 0; nc < OUT / 128; ++nc) {
      for (int kc = 0; kc < W / 64; ++kc)
        load(0, 0, 0, &p.w3, 64 * kc, 128 * nc, kWBytes);
      if (p.proj)
        for (int kc = 0; kc < p.kc1; ++kc)
          load(G, kM, 64 * kc, &p.wd, 64 * kc, 128 * nc, kWBytes);
    }
    return;
  }

  // ---- consumers: warpgroup wg owns output positions [64 wg, 64 wg + 64) ----
  const int wg = tid / 128, t = tid % 128;
  const int fr = (t / 32) * 16 + (t % 32) / 4;   // fragment row (and +8)
  const int fc = 2 * (t % 4);                    // fragment column in an n8
  const int o0 = 64 * wg;
  const uint32_t ring_a = smem_u32(ring), y_a = smem_u32(ybuf);
  Ring r;
  int prev = -1;
  auto begin = [&]() -> uint32_t {
    mbar_wait(&full[r.slot], r.phase);
    wgmma_fence();
    return ring_a + r.slot * S::kSlotBytes;
  };
  auto end = [&]() {               // keep one wgmma group in flight
    wgmma_commit();
    wgmma_wait<1>();
    if (prev >= 0) mbar_arrive(&empty[prev]);
    prev = r.slot;
    r.next();
  };
  auto drain = [&]() {
    wgmma_wait<0>();
    mbar_arrive(&empty[prev]);
    prev = -1;
  };
  const float2* bias2 = reinterpret_cast<const float2*>(bias);
  auto y_at = [&](int ch, int row) {   // y1 / y2 element (ch, y1 row)
    return reinterpret_cast<uint32_t*>(ybuf + (ch / 8) * S::kYLbo + row * 16 +
                                       (ch % 8) * 2);
  };

  // conv1: y1 rows [0, kM1). Width 64: warpgroup wg takes m tiles 2 wg and
  // 2 wg + 1, all channels; width 128: all three m tiles, channels
  // [64 wg, 64 wg + 64).
  {
    constexpr int kMT = W == 64 ? 2 : 3;
    static_assert(kMT * 64 * (W == 64 ? 2 : 1) == S::kM1, "");
    const int mt0 = W == 64 ? 2 * wg : 0;
    const int cb = W == 64 ? 0 : 64 * wg;
    float acc[kMT][32];
    for (int kc = 0; kc < p.kc1; ++kc) {
      const uint32_t a = begin();
      const uint32_t b = a + S::kXBytes + cb * 128;
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
          wgmma_n64(acc[mt], desc_sw128(a + (mt0 + mt) * 8192 + 32 * k),
                    desc_sw128(b + 32 * k), kc | k);
      end();
    }
    float2 bb[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) bb[j] = bias2[(cb + 8 * j + fc) / 2];
    drain();
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int q = 64 * (mt0 + mt) + fr + 8 * hh;
        const bool ok = f0 + q >= 0 && f0 + q < P;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float v0 = fmaxf(acc[mt][4 * j + 2 * hh] + bb[j].x, 0.f);
          const float v1 = fmaxf(acc[mt][4 * j + 2 * hh + 1] + bb[j].y, 0.f);
          *y_at(cb + 8 * j + fc, q) = ok ? pack_bf16(v0, v1) : 0u;
        }
      }
    fence_proxy_async();
    bar_sync(1, kConsumers);
  }

  // conv2: for each dy, three K blocks of W channels, all on y1 shifted by
  // dy grid rows
  {
    float acc[W / 2];
    for (int t9 = 0; t9 < 9; ++t9) {
      const int row = o0 + (t9 / 3) * G;
      for (int h = 0; h < W / 64; ++h) {
        const uint32_t b = begin() + S::kXBytes;
        const uint32_t a = y_a + 8 * h * S::kYLbo + row * 16;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          wgmma_n<W>(acc, desc_interleave(a + 2 * k * S::kYLbo, S::kYLbo),
                     desc_sw128(b + 32 * k), t9 | h | k);
        end();
      }
    }
    float2 bb[W / 8];
#pragma unroll
    for (int j = 0; j < W / 8; ++j) bb[j] = bias2[W / 2 + (8 * j + fc) / 2];
    drain();
    bar_sync(1, kConsumers);       // both warpgroups are done reading y1
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int j = 0; j < W / 8; ++j)
        *y_at(8 * j + fc, o0 + fr + 8 * hh) =
            pack_bf16(fmaxf(acc[4 * j + 2 * hh] + bb[j].x, 0.f),
                      fmaxf(acc[4 * j + 2 * hh + 1] + bb[j].y, 0.f));
    fence_proxy_async();
    bar_sync(2 + wg, 128);
  }

  // conv3 (+ projection), 128 output channels at a time
  float acc[64];
  float2 bb[16];
  unsigned char* my_stg = stg + wg * kStgBytes;
  for (int nc = 0; nc < OUT / 128; ++nc) {
    const int stages = W / 64 + (p.proj ? p.kc1 : 0);
    for (int s = 0; s < stages; ++s) {
      const uint32_t x = begin();
      const uint32_t b = x + S::kXBytes;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint64_t da =
            s < W / 64
                ? desc_interleave(y_a + (8 * s + 2 * k) * S::kYLbo + o0 * 16,
                                  S::kYLbo)
                : desc_sw128(x + o0 * 128 + 32 * k);
        wgmma_n128(acc, da, desc_sw128(b + 32 * k), s | k);
      }
      end();
    }
    uint32_t res[32];              // identity residual, fetched meanwhile
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int f = tile0 + o0 + fr + 8 * hh, fw = f % p.wrap;
      const bool ok = !p.proj && f < P;
      const uint32_t* src = reinterpret_cast<const uint32_t*>(
          p.src + (ok ? n * p.frame_stride + (fw / p.seg) * p.seg_stride +
                            static_cast<long long>(fw % p.seg) * p.cin
                      : 0) +
          128 * nc + fc);
#pragma unroll
      for (int j = 0; j < 16; ++j) res[2 * j + hh] = ok ? src[4 * j] : 0u;
    }
#pragma unroll
    for (int j = 0; j < 16; ++j)
      bb[j] = bias2[W + (128 * nc + 8 * j + fc) / 2];
    drain();
    bar_sync(2 + wg, 128);         // the previous chunk's stores have read stg
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = fr + 8 * hh;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const __nv_bfloat162 rv =
            *reinterpret_cast<const __nv_bfloat162*>(&res[2 * j + hh]);
        const float v0 =
            fmaxf(acc[4 * j + 2 * hh] + bb[j].x + __low2float(rv), 0.f);
        const float v1 =
            fmaxf(acc[4 * j + 2 * hh + 1] + bb[j].y + __high2float(rv), 0.f);
        *reinterpret_cast<uint32_t*>(my_stg + row * kStgPitch + 16 * j +
                                     2 * fc) = pack_bf16(v0, v1);
      }
    }
    bar_sync(2 + wg, 128);
    // 16-byte stores: 16 threads per 256-byte row of 128 channels
    for (int i = t; i < 64 * 16; i += 128) {
      const int row = i / 16, c = i % 16, f = tile0 + o0 + row;
      long long dst;
      if (p.crop_h) {
        const int ci = f / G - p.crop_r0, cj = f % G - p.crop_c0;
        if (f >= P || ci < 0 || ci >= p.crop_h || cj < 0 || cj >= p.crop_w)
          continue;
        dst = (static_cast<long long>(n) * p.crop_h + ci) * p.crop_w + cj;
      } else {
        if (f >= P) continue;
        dst = static_cast<long long>(n) * P + f;
      }
      *reinterpret_cast<uint4*>(p.out + dst * OUT + 128 * nc + 8 * c) =
          *reinterpret_cast<const uint4*>(my_stg + row * kStgPitch + 16 * c);
    }
  }
}

// A bf16 [rows, k] K-major weight as a tensor map with 128-byte swizzle,
// box 64 k x box_rows rows.
inline int encode_weight(CUtensorMap* map, const void* w, int rows, int k,
                         int box_rows) {
  const uint64_t dims[2] = {static_cast<uint64_t>(k),
                            static_cast<uint64_t>(rows)};
  const uint64_t strides[1] = {static_cast<uint64_t>(k) * 2};
  const uint32_t box[2] = {64, static_cast<uint32_t>(box_rows)};
  const uint32_t elem[2] = {1, 1};
  const CUresult res = cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : 10000 + static_cast<int>(res);
}

// One launch of the block kernel; the C entry points of layer1_dots.cu and
// layer2_dots.cu forward their arguments here. Weights K-major bf16: w1
// [W, cin], w2 [W, 9 W] (K = (3 dy + dx block) W + c_in), w3 [OUT, W], wd
// [OUT, cin] or null (identity residual: then cin == OUT); biases fp32.
template <int G, int W, int OUT, int P>
int launch(const void* src, const void* w1, const void* w2, const void* w3,
           const void* wd, const void* b1, const void* b2, const void* b3,
           const void* bd, void* out, int N, int cin, int wrap, int seg,
           long long seg_stride, long long frame_stride, int crop_h,
           int crop_w, int crop_r0, int crop_c0, void* stream) {
  using S = Shape<G, W, OUT, P>;
  if (N < 1 || cin % 64 || cin < 64 || cin > 512 || wrap < 1 || seg < 1 ||
      (wd == nullptr && (cin != OUT || bd != nullptr)) || crop_h < 0 ||
      crop_w < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // the box: the largest power of two up to 64 dividing G (the
  // projection's rows start G rows in) and, for a wrapped source, wrap,
  // seg and P
  const bool wrapped = wrap < P;
  int box = 64;
  while (G % box || (wrapped && (wrap % box || seg % box || P % box)))
    box /= 2;
  if (box < 4 || (wrapped && wrap % seg))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  int err;
  {
    const uint64_t segs = wrapped ? wrap / seg : 1;
    const uint64_t dims[4] = {static_cast<uint64_t>(cin),
                              static_cast<uint64_t>(seg), segs,
                              static_cast<uint64_t>(N)};
    const uint64_t strides[3] = {
        static_cast<uint64_t>(cin) * 2,
        static_cast<uint64_t>(segs > 1 ? seg_stride : 1LL * seg * cin) * 2,
        static_cast<uint64_t>(frame_stride) * 2};
    const uint32_t boxdim[4] = {64, static_cast<uint32_t>(box), 1, 1};
    const uint32_t elem[4] = {1, 1, 1, 1};
    const CUresult res = cuTensorMapEncodeTiled(
        &p.x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(src),
        dims, strides, boxdim, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (res != CUDA_SUCCESS) return 10000 + static_cast<int>(res);
  }
  if ((err = encode_weight(&p.w1, w1, W, cin, W))) return err;
  if ((err = encode_weight(&p.w2, w2, W, 9 * W, W))) return err;
  if ((err = encode_weight(&p.w3, w3, OUT, W, 128))) return err;
  if ((err = encode_weight(&p.wd, wd ? wd : w3, OUT, wd ? cin : W, 128)))
    return err;
  p.src = static_cast<const __nv_bfloat16*>(src);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.b1 = static_cast<const float*>(b1);
  p.b2 = static_cast<const float*>(b2);
  p.b3 = static_cast<const float*>(b3);
  p.bd = static_cast<const float*>(bd);
  p.frame_stride = frame_stride;
  p.seg_stride = seg_stride;
  p.wrap = wrap;
  p.seg = seg;
  p.cin = cin;
  p.box = box;
  p.kc1 = cin / 64;
  p.proj = wd != nullptr;
  p.crop_h = crop_h;
  p.crop_w = crop_w;
  p.crop_r0 = crop_r0;
  p.crop_c0 = crop_c0;
  cudaError_t e = cudaFuncSetAttribute(
      dots_block_kernel<G, W, OUT, P>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  dots_block_kernel<G, W, OUT, P>
      <<<N * S::kTiles, kThreads, S::kSmemBytes,
         static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dots
