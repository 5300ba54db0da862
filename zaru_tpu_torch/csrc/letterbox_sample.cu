// Axis-aligned letterbox nearest-neighbour sampler with colour map, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel of zaru_tpu/ops/pallas_kernels.py
// `letterbox_sample_pallas` (:44, inner `kernel` :102, launched at :112),
// whose function the JAX detect path computes with XLA
// `letterbox_sample_core` (zaru_tpu/ops/sampling.py:120). Unlike the Pallas
// kernel, whose geometry is fixed at trace time for one frame, this one is
// batched: frames [B,H,W,4] u8 and one rect per stream [B,5] f32 held on the
// device, output [B,out_h,out_w,3] f32 NHWC or planar [B,3,out_h,out_w], the
// layout the detectors read. The result is bit-equal to both JAX functions:
//   - the separable index vectors are computed per stream in the f32 op
//     order of sampling.py:135-146 (each multiply, add and divide an
//     explicitly rounded intrinsic; the file is built with --fmad=false);
//   - rounding is round-half-away;
//   - samples outside the frame read black, which maps to `lo`.
//
// Bound: bytes. One launch per detect step; each output pixel reads 4 bytes
// and writes 12, so batch 512 at 128x128 moves about 134 MB, about 0.04 ms at
// 3.35 TB/s. At 1080p the letterbox reads every 15th pixel of every 15th
// row, so each read is a 32-byte sector of its own: counted in sectors, the
// floor is about 0.075 ms. One thread per output pixel; a warp's 32
// neighbouring output columns read from one source row and write 128
// contiguous bytes per channel (planar) or 384 (NHWC). Two other designs
// measured slower than this map on an H100 at 512x128^2 and 128x192^2:
// 4 neighbouring pixels a thread with float4 stores (a warp's loads then
// span four times as many bytes of the source row), and the source indices
// computed once per column and row into shared memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float round_half_away(float x) {
  return copysignf(floorf(__fadd_rn(fabsf(x), 0.5f)), x);
}

// Source index along one axis for output index i of n (sampling.py:135-146):
// v = rha(i/n * size); f = ((v + 0.5) - c) + c + (center - c); rha(f - 0.5).
// i/n is i * f32(1/n), as XLA compiles it (one ulp off the quotient for some
// i when n is not a power of two).
__device__ __forceinline__ float source_index(int i, int n, float size, float center) {
  const float v = round_half_away(__fmul_rn(__fmul_rn((float)i, __frcp_rn((float)n)), size));
  const float c = __fmul_rn(size, 0.5f);
  const float f = __fadd_rn(
      __fadd_rn(__fsub_rn(__fadd_rn(v, 0.5f), c), c), __fsub_rn(center, c));
  return round_half_away(__fsub_rn(f, 0.5f));
}

__global__ void letterbox_sample_kernel(
    const uint32_t* __restrict__ frames,  // [B, H, W] RGBA pixels
    const float* __restrict__ rects,      // [B, 5] cx, cy, w, h, angle (unused)
    float* __restrict__ out,              // [B, 3, out_h, out_w] or [B, out_h, out_w, 3]
    int height, int width, int out_w, int out_h, float adjust, float lo, int planar) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int k = blockIdx.y * blockDim.y + threadIdx.y;
  const int b = blockIdx.z;
  if (j >= out_w || k >= out_h) return;

  const float* r = rects + 5 * b;
  const float xr = source_index(j, out_w, r[2], r[0]);
  const float yr = source_index(k, out_h, r[3], r[1]);

  uint32_t pixel = 0u;  // black
  if (xr >= 0.0f && xr < (float)width && yr >= 0.0f && yr < (float)height) {
    pixel = __ldg(frames + ((size_t)b * height + (int)yr) * width + (int)xr);
  }
  // The colour map rounds once, as XLA's contracted multiply-add does.
  const float red = __fmaf_rn((float)(pixel & 0xFFu), adjust, lo);
  const float green = __fmaf_rn((float)((pixel >> 8) & 0xFFu), adjust, lo);
  const float blue = __fmaf_rn((float)((pixel >> 16) & 0xFFu), adjust, lo);
  const size_t plane = (size_t)out_h * out_w;
  if (planar) {
    float* o = out + (size_t)b * 3 * plane + (size_t)k * out_w + j;
    o[0] = red;
    o[plane] = green;
    o[2 * plane] = blue;
  } else {
    float* o = out + ((size_t)b * plane + (size_t)k * out_w + j) * 3;
    o[0] = red;
    o[1] = green;
    o[2] = blue;
  }
}

}  // namespace

// Launches on `stream`; allocates nothing and does not synchronise. Returns
// cudaGetLastError() (0 when the launch was accepted).
extern "C" int zaru_letterbox_sample(
    const void* frames, const void* rects, void* out, int batch, int height,
    int width, int out_w, int out_h, float adjust, float lo, int planar, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((out_w + 31) / 32, (out_h + 7) / 8, batch);
  letterbox_sample_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(frames), static_cast<const float*>(rects),
      static_cast<float*>(out), height, width, out_w, out_h, adjust, lo, planar);
  return static_cast<int>(cudaGetLastError());
}
