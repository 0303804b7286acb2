// Fused ResNet stem: mean-sub + exact 2x upscale + conv1 7x7/2 + bias + relu
// + maxpool 3x3/2, from the S x S crop to the [N, S/2, S/2, 64] map: bf16
// (stem_kernel, below) or fp32 (stem_kernel_f32, after it: conv1 in 3xTF32
// on the tensor cores).
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
// the strip's upscaled rows in shared memory from the crop (fp32 mean-sub
// and interleave upscale, rounded to bf16 where conv1 casts, stored as
// bf16; zero outside [0, 2S), which is conv1's zero padding), so the
// 2S x 2S image never reaches device memory. conv1 runs on the tensor cores
// as an implicit GEMM (mma.sync m16n8k16, bf16 operands, fp32
// accumulators): M = conv pixels of a conv row, N = 64, K = 7 ky x 24 where
// 24 = the 21 (kx, ch) taps of one ky padded with zero weights. In the
// strip's [col][ch] layout those 21 taps of conv column c are contiguous
// at element 6c of the upscaled row, so each A fragment register is one
// aligned 4-byte shared-memory load. The weights stay resident in shared
// memory ([168 + 8 zero rows][64], padded pitch) and feed B through
// ldmatrix. conv rows (bias, relu, bf16; rounding commutes with max) go to
// a ring of 3 rows in shared memory, and each pooled row is max-pooled from
// its 3 conv rows as soon as they exist, with 16-byte loads and stores.
// Conv rows outside [0, S) hold zero, the pool's padding since post-relu
// values are >= 0. kRows = 4 pooled rows per block computes 9 conv rows for
// 8 (12% recompute) and keeps shared memory small enough for two blocks per
// SM at S = 112.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 7;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 4;                  // pooled rows per block
constexpr int kURows = 4 * kRows + 7;     // upscaled rows per block
constexpr int kOut = 64;
constexpr int kKy = 24;                   // padded taps per ky
constexpr int kK = 176;                   // 7 * 24 padded to 11 k16 steps
constexpr int kPitch = kOut + 8;          // bf16 pitch of weight / conv rows

// bf16 elements of one upscaled strip row: columns -3 .. 2S+2, 3 channels
__host__ __device__ inline int row_elems(int S) { return 6 * S + 18; }

__host__ __device__ inline int strip_bytes(int S) {
  return (kURows * row_elems(S) * 2 + 15) / 16 * 16;
}

inline int smem_bytes(int S) {
  return strip_bytes(S) + kK * kPitch * 2 + 3 * S * kPitch * 2;
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

// Upscaled, mean-subtracted value at (ur, uc, ch) in fp32; 0 outside
// [0, 2S) (conv1's zero padding).
__device__ __forceinline__ float upscaled_f32(const float* img, int S, int ur,
                                              int uc, int ch, float mean) {
  if (ur < 0 || ur >= 2 * S || uc < 0 || uc >= 2 * S) return 0.f;
  const int j = uc >> 1;
  const int nb = (uc & 1) ? min(j + 1, S - 1) : max(j - 1, 0);
  const float x = row_interp(img, S, ur, j, ch, mean);
  const float y = row_interp(img, S, ur, nb, ch, mean);
  return (uc & 1) ? __fadd_rn(__fmul_rn(0.75f, x), __fmul_rn(0.25f, y))
                  : __fadd_rn(__fmul_rn(0.25f, y), __fmul_rn(0.75f, x));
}

__device__ __forceinline__ __nv_bfloat16 upscaled(const float* img, int S,
                                                  int ur, int uc, int ch,
                                                  float mean) {
  return __float2bfloat16_rn(upscaled_f32(img, S, ur, uc, ch, mean));
}

// Element offset of tap k within the strip, relative to conv row 2*jl's
// first upscaled row and conv column 0. k >= 168 are zero-weight padding
// and read in-row values of ky = 6.
__device__ __forceinline__ int tap_offset(int k, int rowlen) {
  const int ky = k < 7 * kKy ? k / kKy : 6;
  const int jj = k < 7 * kKy ? k - kKy * ky : k - 7 * kKy;
  return ky * rowlen + jj;
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* addr) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(addr));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__global__ void __launch_bounds__(kThreads)
stem_kernel(const float* __restrict__ crops, const __nv_bfloat16* __restrict__ w,
            const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
            int S, float m0, float m1, float m2) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rowlen = row_elems(S);
  __nv_bfloat16* su = reinterpret_cast<__nv_bfloat16*>(smem);  // strip
  __nv_bfloat16* sw =                                           // [kK][kPitch]
      reinterpret_cast<__nv_bfloat16*>(smem + strip_bytes(S));
  __nv_bfloat16* sc = sw + kK * kPitch;                  // [3][S][kPitch]
  const int sp = S / 2;
  const int strips = (sp + kRows - 1) / kRows;
  const int n = blockIdx.x / strips;
  const int pr0 = (blockIdx.x % strips) * kRows;
  const float* img = crops + static_cast<long long>(n) * S * S * 3;
  const float mean[3] = {m0, m1, m2};
  const int tid = threadIdx.x;

  const int ur0 = 4 * pr0 - 5;                 // first upscaled row
  for (int i = tid; i < kURows * rowlen; i += kThreads) {
    const int row = i / rowlen, e = i % rowlen;
    su[i] = upscaled(img, S, ur0 + row, e / 3 - 3, e % 3, mean[e % 3]);
  }
  for (int i = tid; i < kK * kOut; i += kThreads) {
    const int k = i / kOut, o = i % kOut;
    const int ky = k / kKy, jj = k % kKy;
    sw[k * kPitch + o] = (ky < 7 && jj < 21) ? w[(21 * ky + jj) * kOut + o]
                                             : __float2bfloat16_rn(0.f);
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  const int tpr = (S + 15) / 16;               // m16 tiles per conv row
  // ldmatrix row of this lane within a k16 x n16 block of the weights
  const __nv_bfloat16* bsrc =
      sw + ((lane % 8) + 8 * ((lane / 8) % 2)) * kPitch + 8 * (lane / 16);

  // group 0: local conv row 0; group gi >= 1: rows 2gi - 1 and 2gi, then
  // pooled row pr0 + gi - 1 from rows 2gi - 2 .. 2gi.
  for (int gi = 0; gi <= kRows; ++gi) {
    const int first = gi == 0 ? 0 : 2 * gi - 1;
    const int ntiles = (gi == 0 ? 1 : 2) * tpr;
    for (int t0 = warp; t0 < ntiles; t0 += 2 * kWarps) {
      // two m16 tiles: t0 and t0 + kWarps (the second may not exist)
      int jl[2], col0[2], base[2][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int t = min(t0 + i * kWarps, ntiles - 1);
        jl[i] = first + t / tpr;
        col0[i] = (t % tpr) * 16;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          base[i][h] = 2 * jl[i] * rowlen + 6 * min(col0[i] + g + 8 * h, S - 1);
      }
      float acc[2][8][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kK / 16; ++kk) {
        const int off0 = tap_offset(16 * kk + 2 * q, rowlen);
        const int off1 = tap_offset(16 * kk + 2 * q + 8, rowlen);
        uint32_t a[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          a[i][0] = *reinterpret_cast<const uint32_t*>(su + base[i][0] + off0);
          a[i][1] = *reinterpret_cast<const uint32_t*>(su + base[i][1] + off0);
          a[i][2] = *reinterpret_cast<const uint32_t*>(su + base[i][0] + off1);
          a[i][3] = *reinterpret_cast<const uint32_t*>(su + base[i][1] + off1);
        }
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, bsrc + 16 * kk * kPitch + 16 * np);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            mma_bf16(acc[i][2 * np], a[i], b[0], b[1]);
            mma_bf16(acc[i][2 * np + 1], a[i], b[2], b[3]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (t0 + i * kWarps >= ntiles) continue;
        const int cr = 2 * pr0 - 1 + jl[i];      // global conv row
        const bool valid = cr >= 0 && cr < S;
        __nv_bfloat16* dst = sc + (jl[i] % 3) * S * kPitch;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int cc = col0[i] + g + 8 * h;
          if (cc >= S) continue;
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const int o = 8 * nt + 2 * q;
            const float v0 = valid ? fmaxf(acc[i][nt][2 * h] + bias[o], 0.f) : 0.f;
            const float v1 =
                valid ? fmaxf(acc[i][nt][2 * h + 1] + bias[o + 1], 0.f) : 0.f;
            *reinterpret_cast<__nv_bfloat162*>(dst + cc * kPitch + o) =
                __floats2bfloat162_rn(v0, v1);
          }
        }
      }
    }
    __syncthreads();
    const int pr = pr0 + gi - 1;
    if (gi > 0 && pr < sp) {
      // 3x3/2 max pool of local conv rows 2gi - 2 .. 2gi, 8 channels a thread
      for (int i = tid; i < sp * (kOut / 8); i += kThreads) {
        const int c8 = i % (kOut / 8), pc = i / (kOut / 8);
        __nv_bfloat162 best[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) best[e] = __floats2bfloat162_rn(0.f, 0.f);
        for (int dj = 0; dj < 3; ++dj) {
          const __nv_bfloat16* row = sc + ((2 * gi - 2 + dj) % 3) * S * kPitch;
          for (int dc = -1; dc <= 1; ++dc) {
            const int cc = 2 * pc + dc;
            if (cc < 0) continue;
            const uint4 v =
                *reinterpret_cast<const uint4*>(row + cc * kPitch + 8 * c8);
            const __nv_bfloat162* vv = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
            for (int e = 0; e < 4; ++e) best[e] = __hmax2(best[e], vv[e]);
          }
        }
        *reinterpret_cast<uint4*>(
            out + ((static_cast<long long>(n) * sp + pr) * sp + pc) * kOut +
            8 * c8) = *reinterpret_cast<const uint4*>(best);
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// The fp32 form (stem_fused at dtype=float32): the same function, with fp32
// operands and results. conv1 runs on the tensor cores as 3xTF32: each
// operand x splits into hi = tf32(x) and lo = tf32(x - hi) (round to
// nearest, ties away, as cvt.rna.tf32.f32 rounds), and each product is
// a_lo * b_hi + a_hi * b_lo + a_hi * b_hi, three mma.sync m16n8k8 .tf32
// into the same fp32 accumulators. What the split drops (a_lo * b_lo and
// the rounding of lo) is ~2^-22 of a product; the larger error is that of
// the 63 tensor-core accumulations into each fp32 accumulator, ~2e-6 of the
// largest output, under the 1e-5 gate. Plain TF32 (hi * hi alone) keeps ~3
// decimal digits, and stem outputs reach the hundreds.
//
// Same block structure as the bf16 form (one block per crop and strip of
// kRows pooled rows, the strip's upscaled rows in shared memory, a ring of
// 3 conv rows, pooling as soon as a pooled row's 3 conv rows exist) and
// the same implicit GEMM: M = conv pixels of a conv row in m16 tiles, two
// tiles a warp; N = 64 in eight n8 tiles; K = 7 ky x 24 = 168 = 21 k8
// steps, the 21 (kx, ch) taps of one ky contiguous at element 6c of the
// strip row and taps 21-23 of each ky carrying zero weights. An A fragment
// register is one fp32 shared load (stride 6 floats across the 8 rows of a
// fragment: a 2-way bank conflict on three of them); the weights stay
// resident as fp32 [168][72], a pitch that makes the B loads
// conflict-free. A is split once per k8 step and reused by the 8 n tiles,
// B once per load and reused by the 2 m tiles; the split is integer work
// beside the mma (tf32_bits).
//
// Everything is fp32 in shared memory: at S = 112 the strip is 63,488 B,
// the weights 48,384 B and the ring 91,392 B (203,264 B, one block per
// SM); at S = kMaxCrop = 128, 225,152 B of the 232,448 a block may have,
// and the launch refuses larger crops. kWarps = 7: a pass over two conv
// rows at S = 112 is 14 m16 tiles, two for each warp; the pass over the
// strip's first conv row gives each warp one tile.
//
// Bound: operations, 3 x 2 x 147 FLOP per conv pixel and channel on the
// TF32 tensor cores (272 GFLOP at 384 crops of 112^2, 0.549 ms at 495
// TFLOP/s); the kernel also computes the 21 zero-weight taps (168 / 147)
// and one conv row in 9 twice (9 / 8).
namespace f32 {

// kRows, kURows, kOut and row_elems as in the bf16 form
constexpr int kWarps = 7;
constexpr int kThreads = 32 * kWarps;
constexpr int kK = 7 * kKy;               // 168 = 21 k8 steps
constexpr int kWPitch = kOut + 8;         // fp32 pitch of a weight row
constexpr int kPitch = kOut + 4;          // fp32 pitch of a conv ring row
constexpr int kMaxCrop = 128;

__host__ __device__ inline int strip_bytes(int S) {
  return (kURows * row_elems(S) * 4 + 15) / 16 * 16;
}

inline int smem_bytes(int S) {
  return strip_bytes(S) + kK * kWPitch * 4 + 3 * S * kPitch * 4;
}

// x rounded to tf32 (10 explicit mantissa bits, ties away from zero), as
// fp32 bits with the 13 low bits zero. Half an ulp added to the magnitude
// bits, then truncated: for finite x the result of cvt.rna.tf32.f32, in
// two integer operations, where cvt's slow pipe held back the whole split.
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// hi = tf32(x), lo = tf32(x - hi); x - hi is exact in fp32.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_bits(x);
  lo = tf32_bits(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// conv1 + bias + relu of kTiles m16 tiles (tiles t0, t0 + kWarps of the
// pass that starts at local conv row `first`) into the ring.
template <int kTiles>
__device__ __forceinline__ void conv_tiles(
    const float* su, const float* sw, float* sc, const float* bias, int S,
    int rowlen, int pr0, int first, int tpr, int t0, int g, int q) {
  int jl[kTiles], col0[kTiles], base[kTiles][2];
#pragma unroll
  for (int i = 0; i < kTiles; ++i) {
    const int t = t0 + i * kWarps;
    jl[i] = first + t / tpr;
    col0[i] = (t % tpr) * 16;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      base[i][h] = 2 * jl[i] * rowlen + 6 * min(col0[i] + g + 8 * h, S - 1);
  }
  float acc[kTiles][8][4];
#pragma unroll
  for (int i = 0; i < kTiles; ++i)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][nt][e] = 0.f;
  const float* bsrc = sw + q * kWPitch + g;
#pragma unroll
  for (int kk = 0; kk < kK / 8; ++kk) {
    const int off0 = tap_offset(8 * kk + q, rowlen);
    const int off1 = tap_offset(8 * kk + q + 4, rowlen);
    uint32_t ahi[kTiles][4], alo[kTiles][4];
#pragma unroll
    for (int i = 0; i < kTiles; ++i) {
      split(su[base[i][0] + off0], ahi[i][0], alo[i][0]);
      split(su[base[i][1] + off0], ahi[i][1], alo[i][1]);
      split(su[base[i][0] + off1], ahi[i][2], alo[i][2]);
      split(su[base[i][1] + off1], ahi[i][3], alo[i][3]);
    }
    // per n tile: B split once for both m tiles, the small products first
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      uint32_t bhi[2], blo[2];
      split(bsrc[8 * kk * kWPitch + 8 * nt], bhi[0], blo[0]);
      split(bsrc[(8 * kk + 4) * kWPitch + 8 * nt], bhi[1], blo[1]);
#pragma unroll
      for (int i = 0; i < kTiles; ++i) {
        mma_tf32(acc[i][nt], alo[i], bhi[0], bhi[1]);
        mma_tf32(acc[i][nt], ahi[i], blo[0], blo[1]);
        mma_tf32(acc[i][nt], ahi[i], bhi[0], bhi[1]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kTiles; ++i) {
    const int cr = 2 * pr0 - 1 + jl[i];        // global conv row
    const bool valid = cr >= 0 && cr < S;
    float* dst = sc + (jl[i] % 3) * S * kPitch;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int cc = col0[i] + g + 8 * h;
      if (cc >= S) continue;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int o = 8 * nt + 2 * q;
        float2 v;
        v.x = valid ? fmaxf(acc[i][nt][2 * h] + bias[o], 0.f) : 0.f;
        v.y = valid ? fmaxf(acc[i][nt][2 * h + 1] + bias[o + 1], 0.f) : 0.f;
        *reinterpret_cast<float2*>(dst + cc * kPitch + o) = v;
      }
    }
  }
}

}  // namespace f32

__global__ void __launch_bounds__(f32::kThreads, 1)
stem_kernel_f32(const float* __restrict__ crops, const float* __restrict__ w,
                const float* __restrict__ bias, float* __restrict__ out,
                int S, float m0, float m1, float m2) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rowlen = row_elems(S);
  float* su = reinterpret_cast<float*>(smem);                  // strip
  float* sw =                                                  // [kK][kWPitch]
      reinterpret_cast<float*>(smem + f32::strip_bytes(S));
  float* sc = sw + f32::kK * f32::kWPitch;       // [3][S][kPitch] conv ring
  const int sp = S / 2;
  const int strips = (sp + kRows - 1) / kRows;
  const int n = blockIdx.x / strips;
  const int pr0 = (blockIdx.x % strips) * kRows;
  const float* img = crops + static_cast<long long>(n) * S * S * 3;
  const float mean[3] = {m0, m1, m2};
  const int tid = threadIdx.x;

  const int ur0 = 4 * pr0 - 5;                 // first upscaled row
#pragma unroll 4
  for (int i = tid; i < kURows * rowlen; i += f32::kThreads) {
    const int row = i / rowlen, e = i % rowlen;
    su[i] = upscaled_f32(img, S, ur0 + row, e / 3 - 3, e % 3, mean[e % 3]);
  }
  for (int i = tid; i < f32::kK * kOut / 4; i += f32::kThreads) {
    const int k = i / (kOut / 4), o4 = i % (kOut / 4);
    const int ky = k / kKy, jj = k % kKy;
    *reinterpret_cast<float4*>(sw + k * f32::kWPitch + 4 * o4) =
        jj < 21 ? reinterpret_cast<const float4*>(w)[(21 * ky + jj) * 16 + o4]
                : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  const int tpr = (S + 15) / 16;               // m16 tiles per conv row

  // group 0: local conv row 0; group gi >= 1: rows 2gi - 1 and 2gi, then
  // pooled row pr0 + gi - 1 from rows 2gi - 2 .. 2gi.
  for (int gi = 0; gi <= kRows; ++gi) {
    const int first = gi == 0 ? 0 : 2 * gi - 1;
    const int ntiles = (gi == 0 ? 1 : 2) * tpr;
    for (int t0 = warp; t0 < ntiles; t0 += 2 * f32::kWarps) {
      if (t0 + f32::kWarps < ntiles)
        f32::conv_tiles<2>(su, sw, sc, bias, S, rowlen, pr0, first, tpr, t0,
                           g, q);
      else
        f32::conv_tiles<1>(su, sw, sc, bias, S, rowlen, pr0, first, tpr, t0,
                           g, q);
    }
    __syncthreads();
    const int pr = pr0 + gi - 1;
    if (gi > 0 && pr < sp) {
      // 3x3/2 max pool of local conv rows 2gi - 2 .. 2gi, 4 channels a thread
      for (int i = tid; i < sp * (kOut / 4); i += f32::kThreads) {
        const int c4 = i % (kOut / 4), pc = i / (kOut / 4);
        float4 best = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int dj = 0; dj < 3; ++dj) {
          const float* row = sc + ((2 * gi - 2 + dj) % 3) * S * f32::kPitch;
          for (int dc = -1; dc <= 1; ++dc) {
            const int cc = 2 * pc + dc;
            if (cc < 0) continue;
            const float4 v = *reinterpret_cast<const float4*>(
                row + cc * f32::kPitch + 4 * c4);
            best.x = fmaxf(best.x, v.x);
            best.y = fmaxf(best.y, v.y);
            best.z = fmaxf(best.z, v.z);
            best.w = fmaxf(best.w, v.w);
          }
        }
        const long long pix = (static_cast<long long>(n) * sp + pr) * sp + pc;
        *reinterpret_cast<float4*>(out + pix * kOut + 4 * c4) = best;
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int mimamo_stem_f32(const void* crops, const void* w,
                               const void* bias, void* out, int N, int S,
                               float m0, float m1, float m2, void* stream) {
  if (S > f32::kMaxCrop || S < 8 || S % 2) return cudaErrorInvalidValue;
  const int smem = f32::smem_bytes(S);
  cudaError_t err = cudaFuncSetAttribute(
      stem_kernel_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int strips = (S / 2 + kRows - 1) / kRows;
  stem_kernel_f32<<<N * strips, f32::kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(crops), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(out), S, m0, m1,
      m2);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mimamo_stem(const void* crops, const void* w, const void* bias,
                           void* out, int N, int S, float m0, float m1,
                           float m2, void* stream) {
  const int smem = smem_bytes(S);
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
