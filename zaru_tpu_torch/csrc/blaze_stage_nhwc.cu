// The fused BlazeBlock stage on channels_last [B, C, H, W] f32 (stored
// [B, H, W, C]): blaze_stage.cuh's kernel with its NHWC index maps, bit-equal
// to blaze_stage.cu's on the same values.

#include "blaze_stage.cuh"

// As zaru_blaze_stage (blaze_stage.cu), on channels_last x and out.
extern "C" int zaru_blaze_stage_nhwc(
    const void* x, const void* params, void* out, int batch, int C, int H, int W,
    int nb, int tile_h, int tile_w, int smem_bytes, void* stream) {
  return launch_for<true>(x, params, out, batch, C, H, W, nb, tile_h, tile_w, smem_bytes,
                          static_cast<cudaStream_t>(stream));
}
