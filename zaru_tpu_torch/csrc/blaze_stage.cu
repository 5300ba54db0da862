// The fused BlazeBlock stage on NCHW-contiguous [B, C, H, W] f32: the kernel
// is blaze_stage.cuh's (its NHWC variant is blaze_stage_nhwc.cu).

#include "blaze_stage.cuh"

// Launches on `stream`; allocates nothing and does not synchronise. C must
// be one of 16, 24, 32, 64, 96, 128 (ops/cnn_stage.py KERNEL_CHANNELS), else
// cudaErrorInvalidValue; `smem_bytes` is the dynamic shared memory of the
// largest region, (C*(RH+1)*(RW+1) + ((RW+5) & ~3) + C*RH*RW + C*C + 12*C)*4,
// without the C*RH*RW where the depthwise stays in registers
// (ops/cnn_stage.py _smem_bytes). Returns the CUDA error code (0 when the
// launch was accepted).
extern "C" int zaru_blaze_stage(
    const void* x, const void* params, void* out, int batch, int C, int H, int W,
    int nb, int tile_h, int tile_w, int smem_bytes, void* stream) {
  return launch_for<false>(x, params, out, batch, C, H, W, nb, tile_h, tile_w, smem_bytes,
                           static_cast<cudaStream_t>(stream));
}
