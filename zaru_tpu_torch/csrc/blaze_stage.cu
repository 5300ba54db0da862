// Fused BlazeBlock stage for Hopper (sm_90a): nb consecutive blocks
//
//     x <- PReLU_i(x + pw1x1_i(dw3x3_i(x) + b_dw) + b_pw)
//
// on [B, C, H, W] f32, in one launch, with the stage's activations kept in
// shared memory: device memory sees one read of x and one write of the
// result.
//
// Replaces the TPU kernel of zaru_tpu/ops/cnn_stage.py: `_stage_kernel`
// (:79), launched by `fused_blocks` (:148). It computes its function, not
// its mechanism: the [G*C, H*W] packing, the block-diagonal weights that
// fill the MXU, and the masked lane rolls have no counterpart here.
//
// Design. A thread block takes one (image, spatial tile). It loads the tile
// plus an nb-pixel halo (clipped to the image) into shared memory once, then
// runs every block of the stage there: the depthwise 3x3 into a second
// buffer, then the pointwise 1x1 with the residual and the PReLU back into
// the first. Each block computes one pixel less on every side that is not
// the image's border, so the halo is recomputed rather than exchanged
// between thread blocks; at the image border the 3x3 reads zeros (the
// convolution's padding). The result's tile is written once. The wrapper
// picks the tile (ops/cnn_stage.py `_tiling`): the whole image where it
// fits (12x12x128 and below), else square-ish tiles.
//
// Arithmetic: f32 FMAs on the CUDA cores (no TF32, no tensor cores). The
// depthwise taps are summed in the TPU kernel's order: bias, then the nine
// taps row-major. The pointwise sum runs over input channels in order, then
// adds its bias and the residual. Built with FMA contraction on: the kernel
// is compared with its plain version at a tolerance (rtol = atol = 1e-4).
//
// Bound. At batch 512, Face Mesh's stages move 2*B*C*H*W*4 bytes each
// (one read, one write) and do 2*B*H*W*C*(9 + C) operations per block plus
// the elementwise ones; the large early stages (96x96x16) are bound by
// bytes, the 128-channel ones by operations. This first design keeps the
// pointwise weights in shared memory and gives each thread 8 output
// channels of one pixel; it does not use the tensor cores, and its large
// tiles run one or two thread blocks per SM.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kOuts = 8;  // output channels per pointwise work item

__global__ void __launch_bounds__(kThreads) blaze_stage_kernel(
    const float* __restrict__ x,       // [B, C, H, W]
    const float* __restrict__ params,  // [nb, C*C + 12*C], see cnn_stage.pack_blocks
    float* __restrict__ out,           // [B, C, H, W]
    int C, int H, int W, int nb, int tile_h, int tile_w, int tiles_w) {
  extern __shared__ float smem[];
  const int b = blockIdx.y;
  const int y0 = (blockIdx.x / tiles_w) * tile_h, x0 = (blockIdx.x % tiles_w) * tile_w;
  const int y1 = min(H, y0 + tile_h), x1 = min(W, x0 + tile_w);
  // The region held in shared memory: the tile and its halo, clipped.
  const int ry0 = max(0, y0 - nb), rx0 = max(0, x0 - nb);
  const int ry1 = min(H, y1 + nb), rx1 = min(W, x1 + nb);
  const int RH = ry1 - ry0, RW = rx1 - rx0, R = RH * RW;
  const int P = C * C + 12 * C;

  float* xs = smem;       // [C, RH, RW] the activation
  float* ds = xs + C * R;  // [C, RH, RW] the depthwise result
  float* wp = ds + C * R;  // one block's packed parameters
  const float* wt = wp;                // [C_in, C_out] pointwise weights
  const float* taps = wt + C * C;      // [9, C] depthwise taps, row-major
  const float* dwb = taps + 9 * C;
  const float* pwb = dwb + C;
  const float* alpha = pwb + C;

  const size_t plane = (size_t)H * W;
  const float* xb = x + (size_t)b * C * plane;
  for (int i = threadIdx.x; i < C * R; i += kThreads) {
    const int c = i / R, r = (i % R) / RW, q = i % RW;
    xs[i] = __ldg(xb + c * plane + (size_t)(ry0 + r) * W + rx0 + q);
  }

  for (int blk = 0; blk < nb; ++blk) {
    __syncthreads();  // the previous block is done with wp and ds
    const float* pb = params + (size_t)blk * P;
    for (int i = threadIdx.x; i < P; i += kThreads) wp[i] = __ldg(pb + i);
    __syncthreads();

    // Block blk computes the pixels at least blk+1 from each region edge
    // that is not the image's border.
    const int m = blk + 1;
    const int r0 = ry0 > 0 ? m : 0, r1 = ry1 < H ? RH - m : RH;
    const int q0 = rx0 > 0 ? m : 0, q1 = rx1 < W ? RW - m : RW;
    const int cw = q1 - q0, np = (r1 - r0) * cw;

    for (int i = threadIdx.x; i < C * np; i += kThreads) {
      const int c = i / np, p = i % np;
      const int r = r0 + p / cw, q = q0 + p % cw;
      const float* xc = xs + c * R;
      float acc = dwb[c];
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const int rr = r + k / 3 - 1, qq = q + k % 3 - 1;
        const float v = (rr >= 0 && rr < RH && qq >= 0 && qq < RW) ? xc[rr * RW + qq] : 0.0f;
        acc += taps[k * C + c] * v;
      }
      ds[c * R + r * RW + q] = acc;
    }
    __syncthreads();

    const int items = (C / kOuts) * np;
    for (int i = threadIdx.x; i < items; i += kThreads) {
      const int o0 = (i / np) * kOuts, p = i % np;
      const int idx = (r0 + p / cw) * RW + q0 + p % cw;
      float acc[kOuts];
#pragma unroll
      for (int j = 0; j < kOuts; ++j) acc[j] = 0.0f;
      for (int ci = 0; ci < C; ++ci) {
        const float d = ds[ci * R + idx];
        const float4 w0 = *reinterpret_cast<const float4*>(wt + ci * C + o0);
        const float4 w1 = *reinterpret_cast<const float4*>(wt + ci * C + o0 + 4);
        acc[0] += w0.x * d;
        acc[1] += w0.y * d;
        acc[2] += w0.z * d;
        acc[3] += w0.w * d;
        acc[4] += w1.x * d;
        acc[5] += w1.y * d;
        acc[6] += w1.z * d;
        acc[7] += w1.w * d;
      }
#pragma unroll
      for (int j = 0; j < kOuts; ++j) {
        const int o = o0 + j;
        const float y = (acc[j] + pwb[o]) + xs[o * R + idx];
        xs[o * R + idx] = y > 0.0f ? y : alpha[o] * y;
      }
    }
  }
  __syncthreads();

  const int th = y1 - y0, tw = x1 - x0, tp = th * tw;
  float* ob = out + (size_t)b * C * plane;
  for (int i = threadIdx.x; i < C * tp; i += kThreads) {
    const int c = i / tp, r = (i % tp) / tw, q = i % tw;
    ob[c * plane + (size_t)(y0 + r) * W + x0 + q] =
        xs[c * R + (y0 - ry0 + r) * RW + (x0 - rx0 + q)];
  }
}

}  // namespace

// Launches on `stream`; allocates nothing and does not synchronise. C must
// be a multiple of 8; `smem_bytes` is the dynamic shared memory of the
// largest region, (2*C*RH*RW + C*C + 12*C)*4. Returns the CUDA error code
// (0 when the launch was accepted).
extern "C" int zaru_blaze_stage(
    const void* x, const void* params, void* out, int batch, int C, int H, int W,
    int nb, int tile_h, int tile_w, int smem_bytes, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      blaze_stage_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_w = (W + tile_w - 1) / tile_w;
  const int tiles_h = (H + tile_h - 1) / tile_h;
  const dim3 grid(tiles_h * tiles_w, batch);
  blaze_stage_kernel<<<grid, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(params),
      static_cast<float*>(out), C, H, W, nb, tile_h, tile_w, tiles_w);
  return static_cast<int>(cudaGetLastError());
}
