// ResNet-50 layer2 on Hopper: one launch per BN-folded bottleneck block,
// conv1 -> conv2 -> conv3 (+ block 0's projection) fused in one CTA.
//
// Replaces the TPU kernel layer2_fused (mimamo_tpu/pallas/layer2_kernel.py,
// body _layer2_kernel; operands from pack_layer2_params). layer2_fused in
// mimamo_tpu_torch/kernels/layer2_kernel.py launches this kernel 4 times,
// once per block, keeping the TPU kernel's rounding points: y1 and y2
// rounded to bf16, the projection, the residual add and relu in fp32, the
// residual stream and the output in bf16.
//
// Bound on the H100: operations. layer2 is 1.90 GFLOP per 56x56x256 frame
// against ~1.2 MB of activations in and out (x once, out once).
//
// Design. The TPU kernel's padded grid carries over: a frame's H x W
// output lives on a grid of row stride 32 (column 0 and columns past W are
// zero padding), so a 3x3 tap is a shift of the grid by 32 * dy + dx rows.
// A CTA owns 4 output rows of one frame (128 grid positions, two wgmma
// m64 tiles) and computes, for those rows only:
//   conv1 on 6 grid rows (one halo row above and below): A is the input
//     tile, loaded by a 5-D TMA box that starts at column -1 and row r0 - 1
//     so the hardware's zero fill of out-of-bounds elements produces the
//     padded grid; block 0 views [N, 2H, 2W, 256] as [N, H, 2, W, 512] and
//     takes parity 0 and lanes 0..255, which are exactly the stride-2
//     pixels. y1 = relu(. + b1), zeroed at padding, is stored as bf16 in
//     shared memory only.
//   conv2 as 9 taps x 128 channels: A is y1, kept without swizzle
//     (8-row x 16-byte core matrices), so each tap's row shift is a 16-byte
//     step of the wgmma descriptor. y2 = relu(. + b2) overwrites y1.
//   conv3 in 4 chunks of 128 output channels (fp32 accumulators in
//     registers); block 0 accumulates its projection into the same
//     registers by concatenating K ([y2 | x_even] . [W3 ; Wd]). The
//     epilogue adds the biases and the residual in fp32, applies relu,
//     rounds to bf16, stages the tile in shared memory and writes its
//     valid pixels with 16-byte stores.
// y1, y2 and the projection never reach device memory. Warp
// specialisation: warp 8 issues every TMA load through a 3-slot ring of
// mbarrier-guarded slots; warpgroups 0 and 1 issue wgmma (bf16 operands,
// fp32 accumulators) from shared memory, keeping one group in flight.
// The output width is at most 31 (the grid's row stride less its one
// left padding column).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kG = 32;                       // grid row stride
constexpr int kRowsOut = 4;                  // output rows per CTA
constexpr int kM1 = (kRowsOut + 2) * kG;     // 192 y1 grid positions
constexpr int kWidth = 128, kOut = 512;
constexpr int kStages = 3;
constexpr int kABytes = kM1 * 128;           // x chunk: 192 rows x 64 ch
constexpr int kBBytes = 128 * 128;           // weight chunk: 128 rows x 64 k
constexpr int kSlotBytes = kABytes + kBBytes;
constexpr int kYMargin = 8;                  // zero rows around y1
constexpr int kYRows = kM1 + 2 * kYMargin;
constexpr int kYLbo = kYRows * 16;           // bytes between 8-channel groups
constexpr int kYBytes = (kWidth / 8) * kYLbo;
constexpr int kStgPitch = (128 + 8) * 2;     // output staging row, bytes
constexpr int kStgBytes = 64 * kStgPitch;    // a warpgroup's 64 x 128 bf16
constexpr int kBiasFloats = 2 * kWidth + kOut;  // b1 | b2 | b3 (+ bd)
constexpr int kSmemBytes = 1024 + kStages * kSlotBytes + kYBytes +
                           2 * kStgBytes + 4 * kBiasFloats + 2 * kStages * 8;
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 32;

struct Params {
  CUtensorMap x, w1, w2, w3, wd;
  __nv_bfloat16* out;          // [N, H, W, 512]
  const __nv_bfloat16* xres;   // identity residual [N, H, W, 512], or null
  const float* b1;
  const float* b2;
  const float* b3;
  const float* bd;             // projection bias (block 0), or null
  int H, W, tiles, kc1;        // kc1: conv1's 64-channel K chunks
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

__global__ void __launch_bounds__(kThreads, 1)
block_kernel(const __grid_constant__ Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* ybuf = ring + kStages * kSlotBytes;
  unsigned char* stg = ybuf + kYBytes;
  float* bias = reinterpret_cast<float*>(stg + 2 * kStgBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(bias + kBiasFloats);
  uint64_t* empty = full + kStages;

  const int n = blockIdx.x / p.tiles;
  const int r0 = (blockIdx.x % p.tiles) * kRowsOut;
  const int tid = threadIdx.x;
  const bool proj = p.bd != nullptr;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    fence_mbar_init();
  }
  for (int i = tid; i < (kWidth / 8) * 2 * kYMargin; i += kThreads) {
    const int r = i % (2 * kYMargin);
    const int row = r < kYMargin ? r : kYRows - 2 * kYMargin + r;
    *reinterpret_cast<uint4*>(ybuf + (i / (2 * kYMargin)) * kYLbo + row * 16) =
        make_uint4(0, 0, 0, 0);
  }
  for (int i = tid; i < kBiasFloats; i += kThreads) {
    const int c = i - 2 * kWidth;
    bias[i] = i < kWidth       ? p.b1[i]
              : i < 2 * kWidth ? p.b2[i - kWidth]
                               : p.b3[c] + (proj ? p.bd[c] : 0.f);
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producer: one thread walks the CTA's whole load schedule ----
    if (tid != kConsumers) return;
    Ring r;
    auto load = [&](bool with_x, int xc, const CUtensorMap* wmap, int wk,
                    int wn) {
      mbar_wait(&empty[r.slot], r.phase ^ 1);
      unsigned char* slot = ring + r.slot * kSlotBytes;
      mbar_expect_tx(&full[r.slot], (with_x ? kABytes : 0) + kBBytes);
      if (with_x)
        tma_load_5d(slot, &p.x, &full[r.slot], xc, -1, 0, r0 - 1, n);
      tma_load_2d(slot + kABytes, wmap, &full[r.slot], wk, wn);
      r.next();
    };
    for (int kc = 0; kc < p.kc1; ++kc) load(true, 64 * kc, &p.w1, 64 * kc, 0);
    for (int tap = 0; tap < 9; ++tap)
      for (int h = 0; h < 2; ++h) load(false, 0, &p.w2, 128 * tap + 64 * h, 0);
    for (int nc = 0; nc < kOut / 128; ++nc) {
      for (int kc = 0; kc < 2; ++kc) load(false, 0, &p.w3, 64 * kc, 128 * nc);
      if (proj)
        for (int kc = 0; kc < 4; ++kc)
          load(true, 64 * kc, &p.wd, 64 * kc, 128 * nc);
    }
    return;
  }

  // ---- consumers: warpgroup wg owns output grid rows [64 wg, 64 wg + 64) ----
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
    return ring_a + r.slot * kSlotBytes;
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
  // bias pairs (ch, ch + 1) of this thread's fragment columns, read into
  // registers before the epilogue that adds them
  const float2* bias2 = reinterpret_cast<const float2*>(bias);
  auto y_at = [&](int ch, int row) {   // y1 / y2 element (ch, grid row)
    return reinterpret_cast<uint32_t*>(ybuf + (ch / 8) * kYLbo +
                                       (row + kYMargin) * 16 + (ch % 8) * 2);
  };

  // conv1: y1 grid rows [0, 192) x channels [64 wg, 64 wg + 64)
  {
    float acc[3][32];
    for (int kc = 0; kc < p.kc1; ++kc) {
      const uint32_t a = begin();
      const uint32_t b = a + kABytes + wg * 64 * 128;
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int mt = 0; mt < 3; ++mt)
          wgmma_n64(acc[mt], desc_sw128(a + mt * 8192 + 32 * k),
                    desc_sw128(b + 32 * k), kc | k);
      end();
    }
    float2 bb[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) bb[j] = bias2[(64 * wg + 8 * j + fc) / 2];
    drain();
#pragma unroll
    for (int mt = 0; mt < 3; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int q = 64 * mt + fr + 8 * hh;
        const int gr = r0 - 1 + q / kG, gc = q % kG;
        const bool ok = gr >= 0 && gr < p.H && gc >= 1 && gc <= p.W;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float v0 = fmaxf(acc[mt][4 * j + 2 * hh] + bb[j].x, 0.f);
          const float v1 = fmaxf(acc[mt][4 * j + 2 * hh + 1] + bb[j].y, 0.f);
          *y_at(64 * wg + 8 * j + fc, q) = ok ? pack_bf16(v0, v1) : 0u;
        }
      }
    fence_proxy_async();
    bar_sync(1, kConsumers);
  }

  float acc[64];
  // conv2: 9 taps, each two 64-channel halves of y1 shifted by the tap
  for (int tap = 0; tap < 9; ++tap) {
    const int row = o0 + kG + (tap / 3 - 1) * kG + (tap % 3 - 1);
    for (int h = 0; h < 2; ++h) {
      const uint32_t b = begin() + kABytes;
      const uint32_t a = y_a + 8 * h * kYLbo + (row + kYMargin) * 16;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        wgmma_n128(acc, desc_interleave(a + 2 * k * kYLbo, kYLbo),
                   desc_sw128(b + 32 * k), tap | h | k);
      end();
    }
  }
  float2 bb[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) bb[j] = bias2[kWidth / 2 + (8 * j + fc) / 2];
  drain();
  bar_sync(1, kConsumers);         // both warpgroups are done reading y1
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      *y_at(8 * j + fc, o0 + fr + 8 * hh) =
          pack_bf16(fmaxf(acc[4 * j + 2 * hh] + bb[j].x, 0.f),
                    fmaxf(acc[4 * j + 2 * hh + 1] + bb[j].y, 0.f));
    }
  fence_proxy_async();
  bar_sync(2 + wg, 128);

  // conv3 (+ projection), 128 output channels at a time
  unsigned char* my_stg = stg + wg * kStgBytes;
  for (int nc = 0; nc < kOut / 128; ++nc) {
    const int stages = proj ? 6 : 2;
    for (int s = 0; s < stages; ++s) {
      const uint32_t x = begin();
      const uint32_t b = x + kABytes;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint64_t da =
            s < 2 ? desc_interleave(
                        y_a + (8 * s + 2 * k) * kYLbo + (o0 + kYMargin) * 16,
                        kYLbo)
                  : desc_sw128(x + (kG + o0) * 128 + 32 * k);
        wgmma_n128(acc, da, desc_sw128(b + 32 * k), s | k);
      }
      end();
    }
    uint32_t res[32];              // fetched while the last group runs
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int o = o0 + fr + 8 * hh;
      const int gr = r0 + o / kG, gc = o % kG - 1;
      const bool ok = !proj && gr < p.H && gc >= 0 && gc < p.W;
      const uint32_t* src = reinterpret_cast<const uint32_t*>(
          p.xres + ((static_cast<long long>(n) * p.H + gr) * p.W + gc) * kOut +
          128 * nc + fc);
#pragma unroll
      for (int j = 0; j < 16; ++j) res[2 * j + hh] = ok ? src[4 * j] : 0u;
    }
#pragma unroll
    for (int j = 0; j < 16; ++j)
      bb[j] = bias2[kWidth + (128 * nc + 8 * j + fc) / 2];
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
    // 16-byte stores of the valid pixels: 16 threads per 256-byte pixel row
    for (int i = t; i < 64 * 16; i += 128) {
      const int row = i / 16, c = i % 16, o = o0 + row;
      const int gr = r0 + o / kG, gc = o % kG - 1;
      if (gr >= p.H || gc < 0 || gc >= p.W) continue;
      *reinterpret_cast<uint4*>(
          p.out + ((static_cast<long long>(n) * p.H + gr) * p.W + gc) * kOut +
          128 * nc + 8 * c) =
          *reinterpret_cast<const uint4*>(my_stg + row * kStgPitch + 16 * c);
    }
  }
}

// A bf16 tensor map with 128-byte swizzle. dims/box innermost first;
// strides in bytes for dims 1.. .
int encode(CUtensorMap* map, int rank, const void* ptr, const uint64_t* dims,
           const uint64_t* strides, const uint32_t* box) {
  const uint32_t elem[5] = {1, 1, 1, 1, 1};
  const CUresult res = cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr),
      dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : 10000 + static_cast<int>(res);
}

int encode_weight(CUtensorMap* map, const void* w, int rows, int k) {
  const uint64_t dims[2] = {static_cast<uint64_t>(k),
                            static_cast<uint64_t>(rows)};
  const uint64_t strides[1] = {static_cast<uint64_t>(k) * 2};
  const uint32_t box[2] = {64, 128};
  return encode(map, 2, w, dims, strides, box);
}

}  // namespace

// One bottleneck block. cin == 256: block 0, x is [N, 2H, 2W, 256], conv1
// and the projection (wd, bd) take its stride-2 pixels. cin == 512: x is
// [N, H, W, 512] and the residual is x itself (wd, bd null). Weights are
// OHWI bf16 ([128, cin], [128, 3, 3, 128], [512, 128], [512, 256]), biases
// fp32; out is [N, H, W, 512] bf16. W <= 31. Returns cudaGetLastError(),
// or 10000 + the CUresult when a tensor map cannot be encoded.
extern "C" int mimamo_layer2_block(const void* x, const void* w1,
                                   const void* w2, const void* w3,
                                   const void* wd, const void* b1,
                                   const void* b2, const void* b3,
                                   const void* bd, void* out, int N, int H,
                                   int W, int cin, void* stream) {
  if (W < 1 || W > kG - 1 || H < 1 || (cin != 256 && cin != 512) ||
      (cin == 256) != (wd != nullptr) || (wd != nullptr) != (bd != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  int err;
  {
    // x as [N, H, P, W, 512]: P = 2 row parities for block 0 (even rows
    // and, in lanes 0..255, even columns), 1 otherwise.
    const uint64_t par = cin == 256 ? 2 : 1;
    const uint64_t dims[5] = {kOut, static_cast<uint64_t>(W), par,
                              static_cast<uint64_t>(H),
                              static_cast<uint64_t>(N)};
    const uint64_t row = static_cast<uint64_t>(W) * kOut * 2;
    const uint64_t strides[4] = {kOut * 2, row, row * par, row * par * H};
    const uint32_t box[5] = {64, kG, 1, kRowsOut + 2, 1};
    if ((err = encode(&p.x, 5, x, dims, strides, box))) return err;
  }
  if ((err = encode_weight(&p.w1, w1, kWidth, cin))) return err;
  if ((err = encode_weight(&p.w2, w2, kWidth, 9 * kWidth))) return err;
  if ((err = encode_weight(&p.w3, w3, kOut, kWidth))) return err;
  if ((err = encode_weight(&p.wd, wd ? wd : w3, kOut, wd ? 256 : kWidth)))
    return err;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.xres = wd ? nullptr : static_cast<const __nv_bfloat16*>(x);
  p.b1 = static_cast<const float*>(b1);
  p.b2 = static_cast<const float*>(b2);
  p.b3 = static_cast<const float*>(b3);
  p.bd = static_cast<const float*>(bd);
  p.H = H;
  p.W = W;
  p.tiles = (H + kRowsOut - 1) / kRowsOut;
  p.kc1 = cin / 64;
  cudaError_t e = cudaFuncSetAttribute(
      block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  block_kernel<<<N * p.tiles, kThreads, kSmemBytes,
                 static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
