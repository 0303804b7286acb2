// The layer2 probe's dots-only block on Hopper (layer2_fused_g4 with
// dots_only=True): 4 blocks at width 128 on the padded 30 x 32 grid (P =
// 960 positions a frame), every block with conv1 at K = 512, conv2 as
// three dots of K = 384 at dy offsets of 32 positions and no dx shift,
// conv3, and block 0's projection (K = 512). One launch per block of the
// kernel in dots_block.cuh; layer2.cu's production block_kernel is not
// touched.
//
// Replaces the TPU kernel layer2_fused_g4(dots_only=True)
// (bench/layer2_probe.py, body make_kernel_dots); wrapper:
// kernels/layer2_dots_kernel.py. Block 0 reads the even-row plane of the
// [N, 28, 2, 28, 512] input, all 512 lanes, through the row map (rows of
// 28 pixels 2 x 28 pixels apart, repeated after 784 positions); blocks
// 1-3 read the stored [N, 960, 512] state. One repair against the probe:
// y1 is zero outside the grid (the probe leaves its conv2 halo unwritten,
// so its rows 0-2 and 25-27 are undefined). The last block writes grid
// rows 1..28, columns 1..28.
//
// Bound on the H100: operations. The output needs 3.313 GFLOP a frame
// (1.286 ms at 384 frames at 989 TFLOP/s); the kernel executes the
// probe's 4.152 (1.612 ms), with grid columns 0 and 29..31, which never
// reach the output, and the products of the repeated plane positions
// (layer2_dots_kernel.needed_work). Executed, that is 2.18x layer2's own
// 1.90 GFLOP: the padded grid, K = 512 in block 0 and the projection in
// every block.
#include "dots_block.cuh"

extern "C" int mimamo_layer2_dots_block(
    const void* src, const void* w1, const void* w2, const void* w3,
    const void* wd, const void* b1, const void* b2, const void* b3,
    const void* bd, void* out, int N, int cin, int wrap, int seg,
    long long seg_stride, long long frame_stride, int crop_h, int crop_w,
    int crop_r0, int crop_c0, void* stream) {
  return dots::launch<32, 128, 512, 30 * 32>(
      src, w1, w2, w3, wd, b1, b2, b3, bd, out, N, cin, wrap, seg, seg_stride,
      frame_stride, crop_h, crop_w, crop_r0, crop_c0, stream);
}
