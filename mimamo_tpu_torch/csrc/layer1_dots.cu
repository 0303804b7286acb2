// layer1_dots on Hopper: the dot sequence of a fused ResNet-50 layer1 (3
// bottleneck blocks at width 64 on the padded 58 x 64 grid, P = 3,712
// positions a frame, conv2's dx taps packed into K = 192 and not shifted),
// one launch per block of the kernel in dots_block.cuh.
//
// Replaces the TPU kernel layer1_dots (bench/layer1_probe.py, body
// make_kernel_dots); wrapper: kernels/layer1_dots_kernel.py. Block 0 reads
// the [N, 56, 56, 64] input through the row map (wrap = 3,136: positions
// past the image repeat its first 576 pixels), projects it with Wd and
// has K = 64; blocks 1-2 read the stored [N, 3712, 256] state, K = 256,
// identity residual. The last block writes grid rows 1..56, columns
// 0..55.
//
// Bound on the H100: operations. The output needs 1.212 GFLOP a frame
// (0.471 ms at 384 frames at 989 TFLOP/s) against 135 MB in and 617 MB
// out; the kernel executes the probe's 1.581 (0.614 ms): it also computes
// grid columns 56..63, which never reach the output, and the products of
// the repeated rows (layer1_dots_kernel.needed_work). Three launches write
// and re-read the [N, 3712, 256] state: 3.69 GB at 384 frames, a floor of
// 1.10 ms at 3.35 TB/s that no one-launch-a-block design passes.
//
// Design: dots_block.cuh's persistent kernel with N3 = 128 (two conv3
// passes), a 4-slot ring of 40 KB, the identity residual taken from
// conv1's source chunks, TMA stores (block 2's crop is one 64-position grid
// row a warpgroup). Clusters of 2 with the weights multicast timed within
// the spread between runs of one build, clusters of 4 slower: none. On an
// H100 SXM at 700 W, 384 frames: 1.9 ms against 3.4 for the first version;
// without its epilogues 1.0 ms (bench/dots_variants.py).
#include "dots_block.cuh"

extern "C" int mimamo_layer1_dots_block(
    const void* src, const void* w1, const void* w2, const void* w3,
    const void* wd, const void* b1, const void* b2, const void* b3,
    const void* bd, void* out, const void* boxes, int N, int cin, int wrap,
    int seg, int box, long long seg_stride, long long frame_stride,
    int crop_h, int crop_w, int crop_r0, int crop_c0, void* stream) {
  return dots::launch<64, 64, 256, 58 * 64, 128>(
      src, w1, w2, w3, wd, b1, b2, b3, bd, out, boxes, N, cin, wrap, seg, box,
      seg_stride, frame_stride, crop_h, crop_w, crop_r0, crop_c0, stream);
}

// CTAs of the persistent grid a launch on N frames takes.
extern "C" int mimamo_layer1_dots_plan(int N, int* ctas) {
  return dots::plan<64, 64, 256, 58 * 64, 128>(N, ctas);
}
