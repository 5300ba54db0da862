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
// One launch does the whole call. Each thread block takes a band of rows of
// one view; its first thread computes the view's coefficients from the raw
// rect [cx, cy, w, h, theta] (`view_coefs`, the op order of
// `_prescale_geometry` :118, `_prescale_coefs` :366-371 and `_sampler_coefs`
// :539-570 as ops/rotated_fast.py::sampler_coefs writes them in torch) into
// shared memory. Output pixel (k, j) of view n is then:
//   1. q_of (rotated_fast.py:641-654) in f32, in exactly that op order;
//   2. jq = floor(qx + 0.5), kq = floor(qy + 0.5) (:725-726);
//   3. black unless 0 <= jq, kq < M (the prescale grid);
//   4. source x = lx + sx*jq, y = ly + sy*kq;
//   5. black unless the source lies inside the frame;
//   6. one 4-byte load of the RGBA pixel, c*adjust + lo for its 3 channels
//      (:1530-1531).
// A thread makes 4 neighbouring pixels of a row (out_w is a multiple of 4):
// their 4 source indices first, then the 4 loads together, then one float4
// store per channel in the planar [N,3,h,w] layout the CNNs read, or three
// float4s in NHWC [N,h,w,3]. A block takes about 512 such groups (two
// rounds of its threads); 256 and 1024 measured slower at one of the face
// (512x192^2) and hand (512x224^2) shapes. Slots whose bit is set in
// `mirror` are written mirrored left to right (the iris path's right eyes).
//
// Every multiply, add and divide of the coefficients and the index map is
// an explicitly rounded intrinsic, and the file is built with --fmad=false:
// the JAX index map is tuned to an exact f32 op order, and a contracted FMA
// moves pixels. Four steps follow what XLA compiles rather than the JAX
// source: `j / out_w` is `j * f32(1/out_w)` (the reciprocal comes from the
// host), `cth*px - sth*py` is one FMA, `fma(cth, px, -(sth*py))`,
// `sth*px + cth*py` is one too, `fma(sth, px, cth*py)` (two views of the
// 256x256 crops on the 512-pixel grid read the neighbouring prescale row
// without it), and the map into the prescale grid, `fx * inv_sx + qx0`, is
// `fma(fx, inv_sx, qx0)` (likewise y; a 900 px body view on the 256-pixel
// grid read the neighbouring prescale row without it).
//
// Bound: bytes. Each output pixel does one 4-byte read and writes 12 bytes;
// at batch 512 of 192x192 views that is about 302 MB, about 0.09 ms at
// 3.35 TB/s. The reads of a rotated view are scattered over source rows and
// are not coalesced: at the face path's stride of 3-4 source pixels per
// output pixel a 32-byte sector serves about two output pixels.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItemsPerBlock = 512;  // 4-pixel groups a block aims for

struct ViewCoefs {
  float w, h, cth, sth, whalf, hhalf, tlx, tly, qx0, qy0, inv_sx, inv_sy;
  int lx, ly, sx, sy;
};

// torch.clamp_min(x, 1.0): NaN stays NaN.
__device__ __forceinline__ float clamp_min1(float x) { return x < 1.0f ? 1.0f : x; }

// The coefficients of one view on a prescale grid of side m
// (ops/rotated_fast.py::sampler_coefs, op for op).
__device__ ViewCoefs view_coefs(const float* __restrict__ r, float m) {
  const float cx = r[0], cy = r[1], w = r[2], h = r[3], th = r[4];
  const float cth = cosf(th), sth = sinf(th);
  const float c = fabsf(cth), s = fabsf(sth);
  const float bw = __fadd_rn(__fadd_rn(__fmul_rn(w, c), __fmul_rn(h, s)), 2.0f);
  const float bh = __fadd_rn(__fadd_rn(__fmul_rn(w, s), __fmul_rn(h, c)), 2.0f);
  const float sx = ceilf(clamp_min1(__fdiv_rn(bw, m)));
  const float sy = ceilf(clamp_min1(__fdiv_rn(bh, m)));
  float left = __fsub_rn(cx, __fmul_rn(__fmul_rn(sx, m), 0.5f));
  float top = __fsub_rn(cy, __fmul_rn(__fmul_rn(sy, m), 0.5f));
  left = __fsub_rn(floorf(__fadd_rn(left, 0.5f)), 0.5f);
  top = __fsub_rn(floorf(__fadd_rn(top, 0.5f)), 0.5f);
  ViewCoefs v;
  v.w = w;
  v.h = h;
  v.cth = cth;
  v.sth = sth;
  v.whalf = __fmul_rn(w, 0.5f);
  v.hhalf = __fmul_rn(h, 0.5f);
  v.tlx = __fsub_rn(cx, v.whalf);
  v.tly = __fsub_rn(cy, v.hhalf);
  v.qx0 = __fsub_rn(__fdiv_rn(__fsub_rn(-0.5f, left), sx), 0.5f);
  v.qy0 = __fsub_rn(__fdiv_rn(__fsub_rn(-0.5f, top), sy), 0.5f);
  v.inv_sx = __frcp_rn(sx);
  v.inv_sy = __frcp_rn(sy);
  v.sx = __float2int_rz(sx);
  v.sy = __float2int_rz(sy);
  v.lx = __float2int_rz(__fadd_rn(left, 0.5f)) + (v.sx - 1) / 2;
  v.ly = __float2int_rz(__fadd_rn(top, 0.5f)) + (v.sy - 1) / 2;
  return v;
}

__global__ void __launch_bounds__(kThreads) rotated_sample_kernel(
    const uint32_t* __restrict__ frames,  // [B, H, W] RGBA pixels
    const float* __restrict__ rects,      // [N, 5] cx, cy, w, h, theta
    float* __restrict__ out,              // [N, 3, out_h, out_w] or [N, out_h, out_w, 3]
    int slots, int height, int width, int m, int out_w, int out_h, int rows,
    int bands, float inv_w, float inv_h, float adjust, float lo, int planar,
    unsigned mirror) {
  const int n = blockIdx.x / bands;
  const int k0 = (blockIdx.x - n * bands) * rows;
  const int k1 = min(k0 + rows, out_h);

  __shared__ ViewCoefs shared;
  if (threadIdx.x == 0) shared = view_coefs(rects + 5 * n, (float)m);
  __syncthreads();
  const ViewCoefs v = shared;

  const uint32_t* frame = frames + (size_t)(n / slots) * height * width;
  const bool flip = mirror != 0u && ((mirror >> (n % slots)) & 1u);  // slots <= 32 then
  const int groups = out_w >> 2;  // 4-pixel groups per row
  // Division-free walk over (row, group) with a stride of kThreads items.
  int k = k0 + threadIdx.x / groups;
  int g = threadIdx.x % groups;
  const int dk = kThreads / groups, dg = kThreads % groups;
  const size_t plane = (size_t)out_h * out_w;
  for (; k < k1; k += dk, g += dg) {
    if (g >= groups) {
      g -= groups;
      if (++k >= k1) break;
    }
    // q_of(jf, kf, rounded=True): the exact sampler's two-stage rounding,
    // then the map into the prescale grid.
    const float yv = floorf(__fadd_rn(__fmul_rn(__fmul_rn((float)k, inv_h), v.h), 0.5f));
    const float py = __fsub_rn(__fadd_rn(yv, 0.5f), v.hhalf);
    const float sth_py = __fmul_rn(v.sth, py);
    const float cth_py = __fmul_rn(v.cth, py);
    int idx[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int jo = 4 * g + i;
      const int j = flip ? out_w - 1 - jo : jo;
      const float xv = floorf(__fadd_rn(__fmul_rn(__fmul_rn((float)j, inv_w), v.w), 0.5f));
      const float px = __fsub_rn(__fadd_rn(xv, 0.5f), v.whalf);
      const float fx = __fadd_rn(__fadd_rn(__fmaf_rn(v.cth, px, -sth_py), v.whalf), v.tlx);
      const float fy = __fadd_rn(__fadd_rn(__fmaf_rn(v.sth, px, cth_py), v.hhalf), v.tly);
      const float jq = floorf(__fadd_rn(__fmaf_rn(fx, v.inv_sx, v.qx0), 0.5f));
      const float kq = floorf(__fadd_rn(__fmaf_rn(fy, v.inv_sy, v.qy0), 0.5f));
      idx[i] = -1;
      if (jq >= 0.0f && jq < (float)m && kq >= 0.0f && kq < (float)m) {
        const int x = v.lx + v.sx * (int)jq;
        const int y = v.ly + v.sy * (int)kq;
        if (x >= 0 && x < width && y >= 0 && y < height) idx[i] = y * width + x;
      }
    }
    uint32_t px4[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) px4[i] = idx[i] >= 0 ? __ldg(frame + idx[i]) : 0u;
    float rgb[3][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t pixel = px4[i];
      rgb[0][i] = __fmaf_rn((float)(pixel & 0xFFu), adjust, lo);
      rgb[1][i] = __fmaf_rn((float)((pixel >> 8) & 0xFFu), adjust, lo);
      rgb[2][i] = __fmaf_rn((float)((pixel >> 16) & 0xFFu), adjust, lo);
    }
    if (planar) {
      float* o = out + (size_t)n * 3 * plane + (size_t)k * out_w + 4 * g;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        *reinterpret_cast<float4*>(o + c * plane) =
            make_float4(rgb[c][0], rgb[c][1], rgb[c][2], rgb[c][3]);
      }
    } else {
      float4* o = reinterpret_cast<float4*>(
          out + ((size_t)n * plane + (size_t)k * out_w + 4 * g) * 3);
      o[0] = make_float4(rgb[0][0], rgb[1][0], rgb[2][0], rgb[0][1]);
      o[1] = make_float4(rgb[1][1], rgb[2][1], rgb[0][2], rgb[1][2]);
      o[2] = make_float4(rgb[2][2], rgb[0][3], rgb[1][3], rgb[2][3]);
    }
  }
}

// The coefficients alone, one thread per view, for checking `view_coefs`
// against the plain version's torch ops.
__global__ void view_coefs_kernel(const float* __restrict__ rects, float* __restrict__ coefs,
                                  int* __restrict__ icoefs, int n_views, float m) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_views) return;
  const ViewCoefs v = view_coefs(rects + 5 * n, m);
  const float f[12] = {v.w,   v.h,   v.cth, v.sth, v.whalf,  v.hhalf,
                       v.tlx, v.tly, v.qx0, v.qy0, v.inv_sx, v.inv_sy};
  for (int i = 0; i < 12; ++i) coefs[12 * n + i] = f[i];
  icoefs[4 * n + 0] = v.lx;
  icoefs[4 * n + 1] = v.ly;
  icoefs[4 * n + 2] = v.sx;
  icoefs[4 * n + 3] = v.sy;
}

}  // namespace

// Launches on `stream`; allocates nothing and does not synchronise. Returns
// cudaGetLastError() (0 when the launch was accepted), or
// cudaErrorInvalidValue for a width that is not a positive multiple of 4 or
// a grid that does not fit.
extern "C" int zaru_rotated_sample(
    const void* frames, const void* rects, void* out, int n_views, int slots,
    int height, int width, int m, int out_w, int out_h, float inv_w, float inv_h,
    float adjust, float lo, int planar, unsigned mirror, void* stream) {
  if (out_w <= 0 || out_w % 4 || out_h <= 0 || n_views <= 0 || slots <= 0 || n_views % slots) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // Bands of about kItemsPerBlock groups, of nearly equal height.
  const long long items = (long long)out_h * (out_w / 4);
  const int want = (int)max(1LL, min((long long)out_h, (items + kItemsPerBlock / 2) / kItemsPerBlock));
  const int rows = (out_h + want - 1) / want;
  const int bands = (out_h + rows - 1) / rows;
  if ((long long)n_views * bands > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  rotated_sample_kernel<<<n_views * bands, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(frames), static_cast<const float*>(rects),
      static_cast<float*>(out), slots, height, width, m, out_w, out_h, rows, bands,
      inv_w, inv_h, adjust, lo, planar, mirror);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int zaru_rotated_coefs(const void* rects, void* coefs, void* icoefs, int n_views,
                                  int m, void* stream) {
  if (n_views <= 0) return static_cast<int>(cudaErrorInvalidValue);
  view_coefs_kernel<<<(n_views + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rects), static_cast<float*>(coefs), static_cast<int*>(icoefs),
      n_views, (float)m);
  return static_cast<int>(cudaGetLastError());
}
