// The dot sequence of one bottleneck block of the two floor probes, on
// Hopper: one launch per block, conv1 -> conv2 -> conv3 (+ projection),
// with no tap shifts and no pad masks.
//
// Replaces the dots-only Pallas kernels of the probes: `make_kernel_dots`
// of bench/layer1_probe.py (called by layer1_dots) and of
// bench/layer2_probe.py (layer2_fused_g4(dots_only=True)). layer1_dots.cu
// and layer2_dots.cu instantiate it; the wrappers are
// kernels/layer1_dots_kernel.py and kernels/layer2_dots_kernel.py.
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
// What bounds it on the H100. Operations: the products the output needs
// (the wrappers' needed_work: 0.471 ms for layer1_dots, 1.286 ms for the
// layer2 dots at 384 frames at 989 TFLOP/s). A chain of one launch a block
// also has a byte floor: every launch but the last writes the state the
// next one reads, 3.69 GB at 384 frames for layer1_dots (1.10 ms at 3.35
// TB/s), 2.88 GB for the layer2 dots (0.86 ms).
//
// What held the first version back (bench/dots_variants.py, cut-down
// variants at 384 frames on an H100 SXM at 700 W): a CTA a tile, not
// persistent, whose phases ran one after another. The layer2 dots took
// 5.54 ms, 3.10 without loads and 4.39 without products: every CTA
// streamed about 1.8 MB from L2 (the block's weights, the projection's
// source once per 128 output channels) and the loads were not hidden.
// layer1_dots took 3.44 ms, 2.17 with neither loads nor products: the
// prologue, the drains, the residual's global loads and the stores.
//
// Design (each point timed against its variant by the same script; now
// 1.9 and 3.1 ms):
// - A persistent grid: one CTA an SM walks tiles blockIdx.x, + gridDim.x,
//   ... The producer warp runs ahead into the next tile's loads while the
//   consumers finish a tile's epilogue; barriers and biases are set up once
//   a CTA.
// - A tile's source boxes come from a table the host plans once per row
//   map (kernels/dots_block.py, box_table: per tile of a frame, the boxes of
//   conv1's window and of the projection's) and are issued for every
//   64-channel chunk; planned per chunk on the device, the producer's
//   arithmetic held every layer2 dots block back.
// - No clusters. Clusters of 2 and 4 CTAs on neighbouring tiles, each
//   loading a row slice of every weight chunk by TMA multicast into the
//   whole cluster, were timed and dropped: 4 cost 8-12% in both kernels, 2
//   up to 4% in the layer2 dots and, in layer1_dots, less than the spread
//   between runs of one build. A cluster's CTAs wait for the slowest of them
//   at every stage of a ring of 3 or 4 slots, and what bounds the loads is
//   what one SM takes in, not what L2 serves.
// - The output leaves by TMA stores of each staged 64 x 64 tile (the whole
//   state, or a crop whose 64-position grid rows start at its column 0);
//   the warpgroup goes on while the copy engine writes (16-byte stores from
//   every thread: +15% in layer1_dots). Other crops: 16-byte stores.
// - layer1_dots' identity residual is read into registers from conv1's
//   source chunks (their rows G .. G + 127), so conv3 loads only weights.
// - conv3 and the projection take N3 channels a pass: 256 in the layer2
//   dots (m64n256 wgmma; the projection's source is read twice a tile, not
//   four times: 128 costs 27%).
// - conv2 takes 3 of W2's 64-deep K chunks a stage (one: +9%); a ring slot
//   holds the largest stage and the ring as many slots as shared memory
//   allows (4 in layer1_dots, 3 in the layer2 dots).
// - The layer2 plane's whole 28-pixel segments come as one box each.
// - What kept ptxas from a good schedule: the biases live in shared memory
//   and pointers into it keep its address space (through an integer they
//   became generic loads and stores); every accumulator starts zeroed and
//   the thread index is re-derived each phase, or values stay live around
//   the persistent loop (spills, serialized wgmma); the two conv1 paths
//   each drain before they join (joined with a wgmma in flight, every wgmma
//   of the kernel was serialized); the producer warpgroup hands registers
//   to the consumers (setmaxnreg).
// What holds it now: the epilogues. Without them (no y1, y2 or output
// work) the kernels take 1.03 and 1.75 ms: the tensor cores wait while a
// tile's y1, y2 and outputs are written.
//
// Kept from the first version: a CTA owns 128 output positions (two wgmma
// m64 tiles, one per consumer warpgroup) of one frame and computes y1 on
// them and on one grid row above and below. The source is a 4-D tensor map
// [N, segments, seg, cin] read in boxes of R rows, R the largest of 64,
// 32, ... that divides G and, for a wrapped source, seg, wrap and P, so
// that no box crosses a segment, the wrap or the grid's end; a box's rows
// land where a single box would put them, in the 128-byte swizzle, which
// TMA applies by shared-memory address. y1 is kept without swizzle (8-row x
// 16-byte core matrices), so a dy tap is a step of the descriptor; y2
// overwrites y1.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace dots {

using namespace hopper;

// Cut-down variants for timing (bench/dots_variants.py): DOTS_NO_LOAD (no
// TMA load: the producer arrives on each slot), DOTS_NO_MMA (no wgmma),
// DOTS_NO_STORE (no output store), DOTS_NO_EPI (no y1, y2 or output
// work).
#ifdef DOTS_NO_MMA
constexpr bool kMma = false;
#else
constexpr bool kMma = true;
#endif
#ifdef DOTS_NO_STORE
constexpr bool kStore = false;
#else
constexpr bool kStore = true;
#endif
#ifdef DOTS_NO_EPI
constexpr bool kEpi = false;       // no y1, y2 or output work
#else
constexpr bool kEpi = true;
#endif

// The producer warpgroup's registers a thread; the consumers take the
// rest of the CTA's 384 x 168 (56 and 40 timed the same; 40 spilled).
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = (384 * 168 - 128 * kProducerRegs) / 256 / 8 * 8;

constexpr int kConsumers = 256;
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kThreads = kConsumers + 128;   // + a producer warpgroup
constexpr int kM = 128;                      // output positions a tile
constexpr int kSmemMax = 232448;             // a block's shared memory
constexpr int kK2 = 3;                       // W2's K chunks a conv2 stage

struct Params {
  // the source in boxes of box rows (x) and of a whole segment (xs); the
  // weights; the output in boxes of 64 positions x 64 channels (yo: the
  // whole state [N, P, OUT], or a crop whose rows are whole grid rows of 64
  // positions, [N, crop_h, crop_w, OUT])
  CUtensorMap x, xs, w1, w2, w3, wd, yo;
  // the boxes of each tile of a frame (kernels/dots_block.py, box_table):
  // [tiles][conv1's window, the projection's][64] of {row in segment,
  // segment, kind (0: none, 1: a box of x, 2: a whole segment of xs), 0}
  const int4* boxes;
  __nv_bfloat16* out;
  const float* b1;
  const float* b2;
  const float* b3;
  const float* bd;          // projection bias, or null
  int wrap, seg;
  int box;                  // source rows a TMA box
  int tma_out;              // stores through yo: 1 the state, 2 a crop
  int kc1;                  // 64-channel K chunks of conv1 and the projection
  int proj;                 // projection (else identity residual)
  int tiles;                // N x tiles a frame
  int crop_h, crop_w, crop_r0, crop_c0;  // crop_h == 0: whole state out
};

constexpr int cmax(int a, int b) { return a > b ? a : b; }

// G: grid row stride; W: bottleneck width; OUT: output channels; P: grid
// positions a frame; N3: output channels a conv3 pass.
template <int G, int W, int OUT, int P, int N3>
struct Shape {
  static constexpr int kM1 = kM + 2 * G;            // y1 rows
  static constexpr int kX1 = kM1 * 128;             // conv1 source chunk
  static constexpr int kXP = kM * 128;              // projection source chunk
  static constexpr int kW12 = W * 128;              // W1 / W2 chunk
  static constexpr int kW3 = N3 * 128;              // W3 / Wd chunk
  // an identity residual (layer1_dots: cin == OUT == 256) is taken from
  // conv1's source chunks into registers; a block with a projection has
  // none
  static constexpr bool kIdentity = OUT <= 256;
  static constexpr int kC2 = 9 * W / 64;            // W2's K chunks
  // a ring slot holds the largest stage: conv1, conv2, conv3, projection
  static constexpr int kSlot = cmax(
      cmax(kX1 + kW12, kK2 * kW12),
      cmax(kW3, kXP + kW3));
  static constexpr int kYLbo = kM1 * 16;            // bytes between 8-ch groups
  static constexpr int kYBytes = (W / 8) * kYLbo;
  static constexpr int kBias = 2 * W + OUT;         // b1 | b2 | b3 (+ bd)
  // conv3's epilogue: 64 channels a round, staged in a warpgroup's tile
  // of 64 rows x 128 bytes (the TMA store's 128-byte swizzle)
  static constexpr int kSC = 64;
  static constexpr int kStg = 64 * 128;
  static constexpr int kFixed = 1024 + kYBytes + 2 * kStg + 4 * kBias;
  // as many slots as shared memory holds, at most 6
  static constexpr int kStages =
      (kSmemMax - kFixed - 6 * 16) / kSlot < 6
          ? (kSmemMax - kFixed - 6 * 16) / kSlot : 6;
  static constexpr int kSmemBytes = kFixed + kStages * kSlot + 2 * kStages * 8;
  static constexpr int kTiles = (P + kM - 1) / kM;
  // (kM1 <= 256: at most 64 source boxes of 4 rows a window, two a lane)
  static_assert(kM % G == 0 && (W == 64 || W == 128) && OUT % N3 == 0 &&
                    kM1 <= 64 * 4 &&
                    (N3 == 128 || N3 == 256) && kC2 % kK2 == 0 &&
                    kSlot % 1024 == 0 && kStages >= 2 &&
                    kSmemBytes <= kSmemMax,
                "");
};

// 16-byte chunk `c` of staging row `row` (128 bytes a row), XOR-swizzled
// as TMA's 128-byte swizzle is: the rows a warp writes or reads together
// fall on distinct banks
__device__ __forceinline__ int stg_at(int row, int c) {
  return row * 128 + ((c ^ (row & 7)) * 16);
}

template <int kStages>
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

// Tile `tile` of N x per_frame: frame n, tile `index` of the frame, whose
// first output position is tile0.
struct Tile {
  int n, index, tile0;
  __device__ Tile(int tile, int per_frame)
      : n(tile / per_frame), index(tile % per_frame), tile0(index * kM) {}
};

// mbar_wait with a watchdog: a wait of more than 2^35 cycles (over 15 s)
// traps, so a broken barrier protocol ends the launch with an error
// instead of holding the card.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  long long t0 = 0;
  uint32_t spins = 0;
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if ((++spins & 1023) == 1) {
      if (!t0)
        t0 = clock64();
      else if (clock64() - t0 > (1LL << 35))
        __trap();
    }
  }
}

// `v`, hidden from the optimizer: values derived from it inside the
// persistent loop are not hoisted out of it (kept live across tiles, they
// spilled).
__device__ __forceinline__ uint32_t opaque(uint32_t v) {
  uint32_t r;
  asm volatile("mov.b32 %0, %1;\n" : "=r"(r) : "r"(v));
  return r;
}

__device__ __forceinline__ void zero(float* a, int n) {
#pragma unroll
  for (int i = 0; i < n; ++i) a[i] = 0.f;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int N>
__device__ __forceinline__ void wgmma_n(float* d, uint64_t da, uint64_t db,
                                        int scale_d) {
  if constexpr (N == 64)
    wgmma_n64(d, da, db, scale_d);
  else if constexpr (N == 128)
    wgmma_n128(d, da, db, scale_d);
  else
    wgmma_n256(d, da, db, scale_d);
}

template <int G, int W, int OUT, int P, int N3>
__global__ void __launch_bounds__(kThreads, 1)
dots_block_kernel(const __grid_constant__ Params p) {
  using S = Shape<G, W, OUT, P, N3>;
  extern __shared__ unsigned char smem_raw[];
  // aligned by pointer arithmetic, not through an integer: the compiler
  // then knows every pointer below is shared memory (LDS / STS; through an
  // integer they became generic loads and stores)
  unsigned char* ring =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* ybuf = ring + S::kStages * S::kSlot;
  unsigned char* stg = ybuf + S::kYBytes;
  float* bias = reinterpret_cast<float*>(stg + 2 * S::kStg);
  uint64_t* full = reinterpret_cast<uint64_t*>(bias + S::kBias);
  uint64_t* empty = full + S::kStages;

  const int tid = threadIdx.x, lane = tid % 32;

  if (tid == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    fence_mbar_init();
  }
  // the biases, once a CTA (read from global memory in the epilogues, their
  // latency stalled every tile)
  for (int i = tid; i < S::kBias; i += kThreads) {
    const int c = i - 2 * W;
    bias[i] = i < W       ? p.b1[i]
              : i < 2 * W ? p.b2[i - W]
                          : p.b3[c] + (p.bd ? p.bd[c] : 0.f);
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producer warpgroup: its first warp issues every load by TMA;
    // its registers go to the consumers ----
    setmaxnreg_dec<kProducerRegs>();
    if (tid >= kConsumers + 32) return;
    Ring<S::kStages> r;
    // a slot of `bytes` (the producer's expect-tx), once it is free
    auto stage = [&](uint32_t bytes) -> unsigned char* {
      bar_wait(&empty[r.slot], r.phase ^ 1);
#ifdef DOTS_NO_LOAD
      if (lane == 0) mbar_arrive(&full[r.slot]);
#else
      if (lane == 0) mbar_expect_tx(&full[r.slot], bytes);
#endif
      __syncwarp();
      return ring + r.slot * S::kSlot;
    };
    // a box of a weight: its map's box rows from row0, k [k, k + 64)
    auto weights = [&](unsigned char* dst, const CUtensorMap* map, int k,
                       int row0) {
#ifndef DOTS_NO_LOAD
      if (lane == 0) tma_load_2d(dst, map, &full[r.slot], k, row0);
#endif
    };
    // The boxes of window w (0: conv1's rows, 1: the projection's) of tile
    // `index` of a frame, from the host's table, read once a tile and issued
    // for every 64-channel chunk: lane l takes the boxes that start at box
    // rows l and l + 32 of the window.
    struct Boxes {
      int4 e[2];
    };
    auto boxes_of = [&](int index, int w) {
      Boxes bx;
#pragma unroll
      for (int i = 0; i < 2; ++i)
        bx.e[i] = __ldg(p.boxes + (2 * index + w) * 64 + lane + 32 * i);
      return bx;
    };
    // channels [c0, c0 + 64) of a planned window of frame n
    auto source = [&](unsigned char* dst, int n, const Boxes& bx, int c0) {
#ifndef DOTS_NO_LOAD
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (bx.e[i].z)
          tma_load_4d(dst + (lane + 32 * i) * p.box * 128,
                      bx.e[i].z == 2 ? &p.xs : &p.x, &full[r.slot], c0,
                      bx.e[i].x, bx.e[i].y, n);
#endif
    };
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const Tile tl(tile, S::kTiles);
      const Boxes window = boxes_of(tl.index, 0);   // conv1's rows
      const Boxes center = boxes_of(tl.index, 1);   // the projection's
      for (int kc = 0; kc < p.kc1; ++kc) {
        unsigned char* s = stage(S::kX1 + S::kW12);
        source(s, tl.n, window, 64 * kc);
        weights(s + S::kX1, &p.w1, 64 * kc, 0);
        r.next();
      }
      for (int c = 0; c < S::kC2; c += kK2) {  // kK2 K chunks of W2
        unsigned char* s = stage(kK2 * S::kW12);
        for (int i = 0; i < kK2; ++i)
          weights(s + i * S::kW12, &p.w2, 64 * (c + i), 0);
        r.next();
      }
      for (int nc = 0; nc < OUT / N3; ++nc) {
        for (int kc = 0; kc < W / 64; ++kc) {
          weights(stage(S::kW3), &p.w3, 64 * kc, N3 * nc);
          r.next();
        }
        if (p.proj)
          for (int kc = 0; kc < p.kc1; ++kc) {
            unsigned char* s = stage(S::kXP + S::kW3);
            source(s, tl.n, center, 64 * kc);
            weights(s + S::kXP, &p.wd, 64 * kc, N3 * nc);
            r.next();
          }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns output positions [64 wg, 64 wg + 64)
    setmaxnreg_inc<kConsumerRegs>();
    // The thread's indices and the addresses made from them, re-derived
    // at the start of every phase from an opaque thread index: hoisted out
    // of the persistent loop and kept live across phases, they spilled.
    int wg = tid / 128, t = tid % 128, fr = 0, fc = 0, o0 = 0;
    unsigned char* yb = ybuf;
    unsigned char* my_stg = stg;   // the warpgroup's staging tile
    uint32_t y_a = 0;
    auto refresh = [&]() {
      const int tt = static_cast<int>(opaque(static_cast<uint32_t>(tid)));
      wg = tt >> 7;
      t = tt & 127;
      fr = ((t >> 5) << 4) + ((t & 31) >> 2);    // fragment row (and +8)
      fc = (t & 3) << 1;                         // fragment column in an n8
      o0 = wg << 6;
      yb = ybuf;
      y_a = opaque(smem_u32(ybuf));
      my_stg = stg + wg * S::kStg;
    };
    Ring<S::kStages> r;
    int prev = -1;
    // this warp's reads of a slot are done: one arrive on its empty
    // barrier
    auto release = [&](int slot) {
      __syncwarp();
      mbar_arrive_if(&empty[slot], lane == 0);
    };
    auto begin = [&]() -> uint32_t {
      bar_wait(&full[r.slot], r.phase);
      wgmma_fence();
      return smem_u32(ring) + r.slot * S::kSlot;
    };
    auto end = [&]() {               // keep one wgmma group in flight
      wgmma_commit();
      wgmma_wait<1>();
      if (prev >= 0) release(prev);
      prev = r.slot;
      r.next();
    };
    auto drain = [&]() {
      wgmma_wait<0>();
      release(prev);
      prev = -1;
    };
    auto bias2 = [&](int i) {      // bias[i], bias[i + 1]
      return *reinterpret_cast<const float2*>(bias + i);
    };
    // y1 / y2 elements (8 g + fc, +1) of y1 row `row`
    auto y_at = [&](int g, int row) {
      return reinterpret_cast<uint32_t*>(yb + g * S::kYLbo + row * 16 +
                                         fc * 2);
    };

    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const Tile tl(tile, S::kTiles);
      const int f0 = tl.tile0 - G;                   // first y1 position
      refresh();

      // identity residual (layer1_dots' blocks 1-2), taken during conv1
      uint32_t res[S::kIdentity ? OUT / 4 : 1];

      // conv1: y1 rows [0, kM1). Width 64: warpgroup wg takes m tiles 2 wg
      // and 2 wg + 1, all channels; width 128: all three m tiles, channels
      // [64 wg, 64 wg + 64).
      {
        constexpr int kMT = W == 64 ? 2 : 3;
        static_assert(kMT * 64 * (W == 64 ? 2 : 1) == S::kM1, "");
        const int mt0 = W == 64 ? 2 * wg : 0;
        const int cb = W == 64 ? 0 : 64 * wg;
        // every accumulator starts zeroed: left undefined, its last value
        // is taken as live around the persistent loop, and the phases'
        // accumulators could not share registers (wgmma serialized, spills)
        float acc[kMT][32];
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) zero(acc[mt], 32);
        auto stage1 = [&](int kc, bool capture) {
          const uint32_t a = begin();
          const uint32_t b = a + S::kX1 + cb * 128;
#pragma unroll
          for (int k = 0; k < 4; ++k)
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt)
              if (kMma)
                wgmma_n64(acc[mt], desc_sw128(a + (mt0 + mt) * 8192 + 32 * k),
                          desc_sw128(b + 32 * k), kc | k);
          if constexpr (S::kIdentity) {
            // the identity residual of the thread's conv3 fragments (rows
            // o0 + fr (+8), channels 64 kc + 8 j + fc (+1)) from the source
            // chunk's swizzled rows G + o0 + ...: conv3 loads none
            if (capture) {
              const unsigned char* x = ring + r.slot * S::kSlot;
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) {
                const int q = G + o0 + fr + 8 * hh;
#pragma unroll
                for (int j = 0; j < 8; ++j)
                  res[2 * (8 * kc + j) + hh] =
                      *reinterpret_cast<const uint32_t*>(
                          x + q * 128 + ((j ^ (fr & 7)) * 16) + fc * 2);
              }
            }
          }
          end();
        };
        // each path drains its own products: paths that joined with a
        // wgmma in flight made ptxas serialize every wgmma of the kernel
        if (S::kIdentity && !p.proj) {
#pragma unroll
          for (int kc = 0; kc < OUT / 64; ++kc) stage1(kc, true);
          drain();
        } else {
          for (int kc = 0; kc < p.kc1; ++kc) stage1(kc, false);
          drain();
        }
        float2 bb[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) bb[j] = bias2(cb + 8 * j + fc);
        bar_sync(1, kConsumers);   // both warpgroups are done with y2
#pragma unroll
        for (int mt = 0; mt < (kEpi ? kMT : 0); ++mt)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int q = 64 * (mt0 + mt) + fr + 8 * hh;
            const bool ok = f0 + q >= 0 && f0 + q < P;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const float v0 = fmaxf(acc[mt][4 * j + 2 * hh] + bb[j].x, 0.f);
              const float v1 =
                  fmaxf(acc[mt][4 * j + 2 * hh + 1] + bb[j].y, 0.f);
              *y_at(cb / 8 + j, q) = ok ? pack_bf16(v0, v1) : 0u;
            }
          }
        fence_proxy_async();
        bar_sync(1, kConsumers);
      }

      // conv2: for each dy, three K blocks of W channels, all on y1
      // shifted by dy grid rows
      refresh();
      {
        float acc[W / 2];
        zero(acc, W / 2);
        // K chunk c of W2: K block t9 = c / (W / 64) (dy = t9 / 3), its
        // 64 channels h = c % (W / 64), on y1 shifted by dy grid rows
        for (int c0 = 0; c0 < S::kC2; c0 += kK2) {
          const uint32_t b = begin();
#pragma unroll
          for (int i = 0; i < kK2; ++i) {
            const int c = c0 + i, t9 = c / (W / 64), h = c % (W / 64);
            const uint32_t a =
                y_a + 8 * h * S::kYLbo + (o0 + (t9 / 3) * G) * 16;
#pragma unroll
            for (int k = 0; k < 4; ++k)
              if (kMma)
                wgmma_n<W>(acc,
                           desc_interleave(a + 2 * k * S::kYLbo, S::kYLbo),
                           desc_sw128(b + i * S::kW12 + 32 * k), c | k);
          }
          end();
        }
        float2 bb[W / 8];
#pragma unroll
        for (int j = 0; j < W / 8; ++j) bb[j] = bias2(W + 8 * j + fc);
        drain();
        bar_sync(1, kConsumers);       // both warpgroups are done reading y1
#pragma unroll
        for (int hh = 0; hh < (kEpi ? 2 : 0); ++hh)
#pragma unroll
          for (int j = 0; j < W / 8; ++j)
            *y_at(j, o0 + fr + 8 * hh) =
                pack_bf16(fmaxf(acc[4 * j + 2 * hh] + bb[j].x, 0.f),
                          fmaxf(acc[4 * j + 2 * hh + 1] + bb[j].y, 0.f));
        fence_proxy_async();
        bar_sync(2 + wg, 128);
      }

      // conv3 (+ projection), N3 output channels a pass
#pragma unroll
      for (int nc = 0; nc < OUT / N3; ++nc) {
        refresh();
        float acc[N3 / 2];
        zero(acc, N3 / 2);
        const int stages = W / 64 + (p.proj ? p.kc1 : 0);
        // stage s: W3's K chunk s on y2, then the projection's on the
        // source
        auto products = [&](int s, uint32_t x) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const uint64_t da =
                s < W / 64 ? desc_interleave(
                                 y_a + (8 * s + 2 * k) * S::kYLbo + o0 * 16,
                                 S::kYLbo)
                           : desc_sw128(x + o0 * 128 + 32 * k);
            const uint32_t b = s < W / 64 ? x : x + S::kXP;
            if (kMma) wgmma_n<N3>(acc, da, desc_sw128(b + 32 * k), s | k);
          }
        };
        products(0, begin());
        end();
        for (int s = 1; s < stages; ++s) {
          products(s, begin());
          end();
        }
        drain();
        // 64 channels a round: staged, then a TMA store or 16-byte stores
        constexpr int kCh = S::kSC / 8;            // 16-byte chunks a row
#pragma unroll
        for (int h2 = 0; h2 < (kEpi ? N3 / S::kSC : 0); ++h2) {
          if (p.tma_out && t == 0) bulk_wait_read<0>();
          bar_sync(2 + wg, 128);     // the previous stores have read stg
#pragma unroll
          for (int j = 0; j < kCh; ++j) {
            const int jj = kCh * h2 + j, c = N3 * nc + 8 * jj + fc;
            const float2 bb = bias2(2 * W + c);
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              float r0 = 0.f, r1 = 0.f;
              if constexpr (S::kIdentity) {
                const __nv_bfloat162 rv = *reinterpret_cast<const __nv_bfloat162*>(
                    &res[2 * (N3 / 8 * nc + jj) + hh]);
                r0 = p.proj ? 0.f : __low2float(rv);
                r1 = p.proj ? 0.f : __high2float(rv);
              }
              const float v0 = fmaxf(acc[4 * jj + 2 * hh] + bb.x + r0, 0.f);
              const float v1 =
                  fmaxf(acc[4 * jj + 2 * hh + 1] + bb.y + r1, 0.f);
              *reinterpret_cast<uint32_t*>(
                  my_stg + stg_at(fr + 8 * hh, j) + fc * 2) =
                  pack_bf16(v0, v1);
            }
          }
          if (p.tma_out) {
            // one TMA store of the staged tile: the warpgroup goes on
            // while the copy engine writes it (rows past P are clipped)
            fence_proxy_async();
            bar_sync(2 + wg, 128);
            const int ch = N3 * nc + S::kSC * h2;
            const int cr = (tl.tile0 + o0) / G - p.crop_r0;   // crop row
            if (t == 0 && kStore) {
              if (p.tma_out == 1) {
                tma_store_3d(&p.yo, my_stg, ch, tl.tile0 + o0, tl.n);
                bulk_commit();
              } else if (cr >= 0 && cr < p.crop_h) {
                tma_store_4d(&p.yo, my_stg, ch, 0, cr, tl.n);
                bulk_commit();
              }
            }
            continue;
          }
          bar_sync(2 + wg, 128);
#pragma unroll 1
          for (unsigned i = t; i < 64 * kCh; i += 128) {
            const int row = i / kCh, c = i % kCh;
            const int f = tl.tile0 + o0 + row;
            long long dst;
            if (p.crop_h) {
              const int ci = static_cast<int>(static_cast<unsigned>(f) / G) -
                             p.crop_r0;
              const int cj = static_cast<int>(static_cast<unsigned>(f) % G) -
                             p.crop_c0;
              if (f >= P || ci < 0 || ci >= p.crop_h || cj < 0 ||
                  cj >= p.crop_w)
                continue;
              dst = (static_cast<long long>(tl.n) * p.crop_h + ci) *
                        p.crop_w + cj;
            } else {
              if (f >= P) continue;
              dst = static_cast<long long>(tl.n) * P + f;
            }
            const uint4 v =
                *reinterpret_cast<const uint4*>(my_stg + stg_at(row, c));
            if (kStore)
              *reinterpret_cast<uint4*>(p.out + dst * OUT + N3 * nc +
                                        S::kSC * h2 + 8 * c) = v;
          }
        }
      }
    }
    if (t == 0) bulk_wait<0>();    // the last stores have left shared memory
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

// CTAs of the persistent grid on N frames: one a tile, at most as many as
// the card holds at once.
template <int G, int W, int OUT, int P, int N3>
int plan(int N, int* ctas) {
  using S = Shape<G, W, OUT, P, N3>;
  auto kernel = dots_block_kernel<G, W, OUT, P, N3>;
  static int fits[64] = {};                // CTAs at once, per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!fits[dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             S::kSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, S::kSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    fits[dev] = per_sm * sms;
  }
  const int tiles = N * S::kTiles;
  *ctas = tiles < fits[dev] ? tiles : fits[dev];
  return 0;
}

// One launch of the block kernel; the C entry points of layer1_dots.cu and
// layer2_dots.cu forward their arguments here. Weights K-major bf16: w1
// [W, cin], w2 [W, 9 W] (K = (3 dy + dx block) W + c_in), w3 [OUT, W], wd
// [OUT, cin] or null (identity residual: then cin == OUT); biases fp32.
// `boxes` and `box`: the host's box table and the source rows a box
// (kernels/dots_block.py: box_table, box_rows).
template <int G, int W, int OUT, int P, int N3>
int launch(const void* src, const void* w1, const void* w2, const void* w3,
           const void* wd, const void* b1, const void* b2, const void* b3,
           const void* bd, void* out, const void* boxes, int N, int cin,
           int wrap, int seg, int box, long long seg_stride,
           long long frame_stride, int crop_h, int crop_w, int crop_r0,
           int crop_c0, void* stream) {
  using S = Shape<G, W, OUT, P, N3>;
  // a box is a power of two from 4 to 64 rows that divides G (the
  // projection's rows start G rows in) and, for a wrapped source, wrap,
  // seg and P: no box crosses a segment, the wrap or the grid's end
  const bool wrapped = wrap < P;
  if (N < 1 || cin % 64 || cin < 64 || cin > 512 || wrap < 1 || seg < 1 ||
      (wd == nullptr && (cin != OUT || bd != nullptr || !S::kIdentity)) ||
      crop_h < 0 || crop_w < 0 || boxes == nullptr || box < 4 || box > 64 ||
      (box & (box - 1)) || G % box ||
      (wrapped && (wrap % box || seg % box || P % box || wrap % seg)))
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
    const uint32_t elem[4] = {1, 1, 1, 1};
    // x in boxes of box rows; xs, for a wrapped source with segments of
    // at most 256 rows, in boxes of a whole segment
    for (int m = 0; m < (wrapped && seg <= 256 ? 2 : 1); ++m) {
      const uint32_t boxdim[4] = {
          64, static_cast<uint32_t>(m ? seg : box), 1, 1};
      const CUresult res = cuTensorMapEncodeTiled(
          m ? &p.xs : &p.x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
          const_cast<void*>(src), dims, strides, boxdim, elem,
          CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
          CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
      if (res != CUDA_SUCCESS) return 10000 + static_cast<int>(res);
    }
  }
  p.tma_out = 0;
  if (crop_h && G == 64 && crop_c0 == 0 && crop_w <= 64) {
    // a crop of whole grid rows from column 0: a warpgroup's 64 positions
    // are one grid row, its columns past crop_w clipped
    const uint64_t dims[4] = {
        static_cast<uint64_t>(OUT), static_cast<uint64_t>(crop_w),
        static_cast<uint64_t>(crop_h), static_cast<uint64_t>(N)};
    const uint64_t strides[3] = {
        static_cast<uint64_t>(OUT) * 2,
        static_cast<uint64_t>(crop_w) * OUT * 2,
        static_cast<uint64_t>(crop_h) * crop_w * OUT * 2};
    const uint32_t boxdim[4] = {64, 64, 1, 1};
    const uint32_t elem[4] = {1, 1, 1, 1};
    const CUresult res = cuTensorMapEncodeTiled(
        &p.yo, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, out, dims, strides,
        boxdim, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_NONE,
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (res != CUDA_SUCCESS) return 10000 + static_cast<int>(res);
    p.tma_out = 2;
  }
  if (!crop_h) {
    const uint64_t dims[3] = {static_cast<uint64_t>(OUT),
                              static_cast<uint64_t>(P),
                              static_cast<uint64_t>(N)};
    const uint64_t strides[2] = {static_cast<uint64_t>(OUT) * 2,
                                 static_cast<uint64_t>(P) * OUT * 2};
    const uint32_t boxdim[3] = {64, 64, 1};
    const uint32_t elem[3] = {1, 1, 1};
    const CUresult res = cuTensorMapEncodeTiled(
        &p.yo, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, out, dims, strides,
        boxdim, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_NONE,
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (res != CUDA_SUCCESS) return 10000 + static_cast<int>(res);
    p.tma_out = 1;
  }
  if ((err = encode_weight(&p.w1, w1, W, cin, W))) return err;
  if ((err = encode_weight(&p.w2, w2, W, 9 * W, W))) return err;
  if ((err = encode_weight(&p.w3, w3, OUT, W, N3))) return err;
  if ((err = encode_weight(&p.wd, wd ? wd : w3, OUT, wd ? cin : W, N3)))
    return err;
  p.boxes = static_cast<const int4*>(boxes);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.b1 = static_cast<const float*>(b1);
  p.b2 = static_cast<const float*>(b2);
  p.b3 = static_cast<const float*>(b3);
  p.bd = static_cast<const float*>(bd);
  p.wrap = wrap;
  p.seg = seg;
  p.box = box;
  p.kc1 = cin / 64;
  p.proj = wd != nullptr;
  p.tiles = N * S::kTiles;
  p.crop_h = crop_h;
  p.crop_w = crop_w;
  p.crop_r0 = crop_r0;
  p.crop_c0 = crop_c0;
  int ctas = 0;
  if ((err = plan<G, W, OUT, P, N3>(N, &ctas))) return err;
  dots_block_kernel<G, W, OUT, P, N3>
      <<<ctas, kThreads, S::kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
          p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dots
