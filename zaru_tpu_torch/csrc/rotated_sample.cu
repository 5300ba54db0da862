// Rotated-ROI nearest-neighbour sampler with colour map, for Hopper (sm_90a).
//
// Replaces the TPU kernels of zaru_tpu/ops/rotated_fast.py: the fused
// prescale+rotate kernel `_fused_kernel` (:840, launched by
// `fused_call_for.call` :1481), the standalone rotate kernel `_rotate_kernel`
// (:583, launched by `rotate_call` :1395) and the standalone prescale kernel
// `_prescale_pallas_kernel` (:174, launched by `_prescale_pallas` :457).
// It computes their function, not their mechanism: the one-hot MXU
// selections, crop-class DMAs, lane rolls and view packing exist because
// gathers are slow on the TPU and have no counterpart here.
//
// Output pixel (k, j) of view n:
//   1. q_of (rotated_fast.py:641-654) in f32, in exactly that op order, from
//      the 12 per-view coefficients of `_sampler_coefs` (:539-570);
//   2. jq = floor(qx + 0.5), kq = floor(qy + 0.5) (:725-726);
//   3. black unless 0 <= jq, kq < M (the prescale grid);
//   4. source x = lx + sx*jq, y = ly + sy*kq (`_prescale_coefs` :366-371);
//   5. black unless the source lies inside the frame;
//   6. one 4-byte load of the RGBA pixel, c*adjust + lo for its 3 channels
//      (:1530-1531).
// Every multiply and add of the index map is written as an explicitly
// rounded intrinsic, and the file is built with --fmad=false: the JAX index
// map is tuned to an exact f32 op order, and a contracted FMA moves pixels.
// Two steps follow what XLA compiles rather than the JAX source: `j / out_w`
// is `j * f32(1/out_w)` (the reciprocal comes from the host), and
// `cth*px - sth*py` is one FMA, `fma(cth, px, -(sth*py))`.
//
// Bound: bytes. Each output pixel does one 4-byte read and writes 12 bytes;
// at batch 512 of 192x192 views that is about 302 MB per step, about
// 0.09 ms at 3.35 TB/s. This first design (one thread per output pixel, a
// 32x8 block over one view's columns and rows) does nothing about that bound
// yet: for a rotated view the reads of a warp are scattered over source rows
// and are not coalesced. A later version tiles the view's source window
// through shared memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void rotated_sample_kernel(
    const uint32_t* __restrict__ frames,  // [B, H, W] RGBA pixels
    const float* __restrict__ coefs,      // [N, 12] per-view index-map coefficients
    const int* __restrict__ icoefs,       // [N, 4] lx, ly, sx, sy
    float* __restrict__ out,              // [N, out_h, out_w, 3]
    int slots, int height, int width, int m, int out_w, int out_h,
    float inv_w, float inv_h, float adjust, float lo) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int k = blockIdx.y * blockDim.y + threadIdx.y;
  const int n = blockIdx.z;
  if (j >= out_w || k >= out_h) return;

  const float* c = coefs + 12 * n;
  const float w = c[0], h = c[1], cth = c[2], sth = c[3];
  const float whalf = c[4], hhalf = c[5], tlx = c[6], tly = c[7];
  const float qx0 = c[8], qy0 = c[9], inv_sx = c[10], inv_sy = c[11];

  // q_of(jf, kf, rounded=True): the exact sampler's two-stage rounding,
  // then the map into the prescale grid.
  float xv = __fmul_rn(__fmul_rn((float)j, inv_w), w);
  float yv = __fmul_rn(__fmul_rn((float)k, inv_h), h);
  xv = floorf(__fadd_rn(xv, 0.5f));
  yv = floorf(__fadd_rn(yv, 0.5f));
  const float px = __fsub_rn(__fadd_rn(xv, 0.5f), whalf);
  const float py = __fsub_rn(__fadd_rn(yv, 0.5f), hhalf);
  const float fx = __fadd_rn(
      __fadd_rn(__fmaf_rn(cth, px, -__fmul_rn(sth, py)), whalf), tlx);
  const float fy = __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(sth, px), __fmul_rn(cth, py)), hhalf), tly);
  const float qx = __fadd_rn(__fmul_rn(fx, inv_sx), qx0);
  const float qy = __fadd_rn(__fmul_rn(fy, inv_sy), qy0);
  const float jq = floorf(__fadd_rn(qx, 0.5f));
  const float kq = floorf(__fadd_rn(qy, 0.5f));

  uint32_t pixel = 0u;  // black
  if (jq >= 0.0f && jq < (float)m && kq >= 0.0f && kq < (float)m) {
    const int* ic = icoefs + 4 * n;
    const int x = ic[0] + ic[2] * (int)jq;
    const int y = ic[1] + ic[3] * (int)kq;
    if (x >= 0 && x < width && y >= 0 && y < height) {
      const size_t frame = (size_t)(n / slots);
      pixel = __ldg(frames + (frame * height + y) * width + x);
    }
  }

  float* o = out + (((size_t)n * out_h + k) * out_w + j) * 3;
  // The colour map rounds once, as XLA's contracted multiply-add does.
  o[0] = __fmaf_rn((float)(pixel & 0xFFu), adjust, lo);
  o[1] = __fmaf_rn((float)((pixel >> 8) & 0xFFu), adjust, lo);
  o[2] = __fmaf_rn((float)((pixel >> 16) & 0xFFu), adjust, lo);
}

}  // namespace

// Launches on `stream`; allocates nothing and does not synchronise. Returns
// cudaGetLastError() (0 when the launch was accepted).
extern "C" int zaru_rotated_sample(
    const void* frames, const void* coefs, const void* icoefs, void* out,
    int n_views, int slots, int height, int width, int m, int out_w, int out_h,
    float inv_w, float inv_h, float adjust, float lo, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((out_w + 31) / 32, (out_h + 7) / 8, n_views);
  rotated_sample_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(frames), static_cast<const float*>(coefs),
      static_cast<const int*>(icoefs), static_cast<float*>(out), slots, height,
      width, m, out_w, out_h, inv_w, inv_h, adjust, lo);
  return static_cast<int>(cudaGetLastError());
}
