// Fused BlazeBlock stage for Hopper (sm_90a): nb consecutive blocks
//
//     x <- PReLU_i(x + pw1x1_i(dw3x3_i(x) + b_dw) + b_pw)
//
// on [B, C, H, W] f32, in one launch, with the stage's activations kept in
// shared memory: device memory sees one read of x and one write of the
// result. x and the result are NCHW-contiguous or, with the template flag
// NHWC, channels_last (the logical [B, C, H, W] stored [B, H, W, C], as an
// NHWC module of the ONNX executor keeps its activations). The flag changes
// only the index maps of the global load and store; the shared-memory tile,
// its ring of zeros and the arithmetic are the same, so the two variants
// are bit-equal on the same values. The NHWC load and store keep the NCHW
// variant's work split (lanes along a row, a slice of channels a thread),
// so a thread reads its slice as consecutive floats; lanes along the
// channels, for coalesced rows, are later work. The two variants are built
// as two libraries (blaze_stage.cu, blaze_stage_nhwc.cu), whose nvcc runs
// side by side.
//
// Replaces the TPU kernel of zaru_tpu/ops/cnn_stage.py: `_stage_kernel`
// (:79), launched by `fused_blocks` (:148). It computes its function, not
// its mechanism: the [G*C, H*W] packing, the block-diagonal weights that
// fill the MXU, and the masked lane rolls have no counterpart here.
//
// Design. A thread block takes one (image, spatial tile). It loads the tile
// plus an nb-pixel halo (clipped to the image) into shared memory once, then
// runs every block of the stage there, the result back into the same place.
// Each block computes one pixel less on every side that is not the image's
// border, so the halo is recomputed rather than exchanged between thread
// blocks. The result's tile is written once. The wrapper picks the tile
// (ops/cnn_stage.py `_tiling`): the whole image where it fits (12x12x128 and
// below), else square-ish tiles.
//
// The narrow chains do few operations per byte, and the first version of
// this kernel was held back by its integer index arithmetic, not by memory
// or FMAs: runtime divisions and modulos for every element and four compares
// per depthwise tap. This version takes that out:
//
// - C is a template parameter, instantiated for the channel counts of the
//   face CNNs' chains (16, 24, 32, 64, 96, 128), so the channel loops unroll
//   and their offsets are constants;
// - each channel's region sits in a ring of zeros, written once by the
//   load: a channel is RH+1 rows of RW+1 floats, a zero row and then RH rows
//   that each start with a zero. The next row's zero (or the next channel's
//   zero row, or a zero tail after the last channel) closes the ring on the
//   right and below, so a channel takes (RH+1)*(RW+1) floats, not
//   (RH+2)*(RW+2), and the 12x12x128 chain still fits one tile. At the
//   image border the ring is the convolution's padding; at an interior tile
//   edge no computed pixel reads it (block blk computes only pixels at least
//   blk+1 from such an edge); the pointwise writes only computed pixels, so
//   the ring stays zero. The depthwise reads its nine taps with no compare;
// - load and store run lanes along a row (a narrow row takes a group of
//   lanes, so a warp holds several) and warps over rows, with an unrolled
//   loop over a slice of 8 or 16 channels, coalesced along W. Work items
//   find their (slice, row) or pixel with exact float reciprocal products
//   (`div_small`), once per row or item.
//
// Two ways to run a block. At 16 and 24 channels (and regions of more than
// 128 pixels) a thread holds up to 4 or 3 pixels, computes all C depthwise
// values of each into registers, and after a barrier runs the pointwise from
// them, four outputs at a time, each float4 of weights serving all its
// pixels; no depthwise buffer, half the shared memory. Otherwise the
// depthwise goes into a second buffer in shared memory, 8 channels of one
// pixel a work item, then the pointwise, 8 outputs of one pixel an item.
//
// Arithmetic: f32 FMAs on the CUDA cores (no TF32, no tensor cores). The
// depthwise taps are summed in the TPU kernel's order: bias, then the nine
// taps row-major. The pointwise sum runs over input channels in order, then
// adds its bias and the residual. Built with FMA contraction on: the kernel
// is compared with its plain version at a tolerance (rtol = atol = 1e-4).
//
// Bound. At batch 512, Face Mesh's stages move 2*B*C*H*W*4 bytes each
// (one read, one write) and do 2*B*H*W*C*(9 + C) operations per block plus
// the elementwise ones; the 96x96x16 and 64x64x24 stages are bound by bytes,
// the others by operations. Times on the card are in PERF.md section 6
// (chip_smoke.py phase 6). What still holds the kernel back: two thread
// blocks an SM at most (registers or shared memory), whose load, compute and
// store do not overlap; shared-memory reads for every FMA of the depthwise;
// no tensor cores for the 1x1.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kOuts = 8;               // channels per depthwise and pointwise work item
constexpr int kRegisterChannels = 24;  // C up to this keeps the depthwise in registers
// Pixels a thread holds on that path, all C depthwise values of each
// (ops/cnn_stage.py PIXELS_PER_THREAD): a region has at most kPixels *
// kThreads pixels.
template <int C>
constexpr int kPixels = C <= 16 ? 4 : 3;
// Thread blocks an SM must hold, which caps a thread's registers (65536 /
// (256 * n)): 2 (128 registers) lets the register path run two blocks an SM
// and made the 64- and 128-channel chains faster on the card; the 32- and
// 96-channel ones were faster held to 64 and 80 registers, as ptxas chose
// before the register path existed (PERF.md, section 6).
template <int C>
constexpr int kMinBlocks = C == 32 ? 4 : C == 96 ? 3 : 2;

// floor(n / d) for 0 <= n < 2^22, given inv = 1.0f / d (d >= 1): exact,
// because (n + 0.5) / d lies at least 0.5 / d from an integer, and the two
// roundings (of inv and of the product) move it by less than
// (n + 0.5) / d * 2^-23 < 0.5 / d.
__device__ __forceinline__ int div_small(int n, float inv) {
  return __float2int_rz((static_cast<float>(n) + 0.5f) * inv);
}

// Calls f(c0, r, q) for channels [c0, c0 + CS) of every row r < rows and
// column q < width of a plane: the load's and the store's map. A row goes to
// a group of lw lanes, the least power of two >= width (at most 32), so a
// warp takes 32/lw rows, and a narrow plane still fills the block; the
// (channel slice, row) pairs are dealt to the groups in turn.
template <int C, int CS, class F>
__device__ __forceinline__ void for_rows(int rows, int width, F f) {
  int lws = 5;
  while (lws > 0 && (1 << (lws - 1)) >= width) --lws;
  const int lw = 1 << lws;
  const float inv_rows = 1.0f / rows;
  for (int u = threadIdx.x >> lws; u < (C / CS) * rows; u += kThreads >> lws) {
    const int s = div_small(u, inv_rows);
    for (int q = threadIdx.x & (lw - 1); q < width; q += lw) f(s * CS, u - s * rows, q);
  }
}

// One BlazeBlock on the window for C <= kRegisterChannels, with K rounds of
// pixels: thread t takes window pixels p = t + k*kThreads (k < K), computes
// all C depthwise values of each into registers, waits for the block, then
// runs the pointwise from registers and writes its pixels in place. A thread
// past the window's end in the last round computes its last pixel again and
// writes nothing. `at` is the top-left tap of a pixel, region pixel
// (r-1, q-1): r*PW + q.
template <int C, int K>
__device__ __forceinline__ void block_in_registers(float* xs, const float* wp, int PW, int PP,
                                                   int r0, int q0, int cw, int np) {
  const float* wt = wp;
  const float* taps = wt + C * C;
  const float* dwb = taps + 9 * C;
  const float* pwb = dwb + C;
  const float* alpha = pwb + C;
  const float inv_cw = 1.0f / cw;
  int at[K];
  bool own[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = threadIdx.x + k * kThreads;
    own[k] = i < np;
    const int p = own[k] ? i : np - 1;
    const int pr = div_small(p, inv_cw);
    at[k] = (r0 + pr) * PW + q0 + p - pr * cw;
  }

  float d[K][C];
#pragma unroll
  for (int c = 0; c < C; c += 4) {
    const float4 b = *reinterpret_cast<const float4*>(dwb + c);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      d[k][c] = b.x;
      d[k][c + 1] = b.y;
      d[k][c + 2] = b.z;
      d[k][c + 3] = b.w;
    }
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const float4 w = *reinterpret_cast<const float4*>(taps + t * C + c);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float* xk = xs + c * PP + at[k] + (t / 3) * PW + t % 3;
        d[k][c] += w.x * xk[0];
        d[k][c + 1] += w.y * xk[PP];
        d[k][c + 2] += w.z * xk[2 * PP];
        d[k][c + 3] += w.w * xk[3 * PP];
      }
    }
  }
  __syncthreads();  // every thread has read xs for this block

  // Four outputs at a time, so that the sums take few registers beside d.
#pragma unroll
  for (int o0 = 0; o0 < C; o0 += 4) {
    float acc[K][4];
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[k][j] = 0.0f;
    }
#pragma unroll
    for (int ci = 0; ci < C; ++ci) {
      const float4 w = *reinterpret_cast<const float4*>(wt + ci * C + o0);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        acc[k][0] += w.x * d[k][ci];
        acc[k][1] += w.y * d[k][ci];
        acc[k][2] += w.z * d[k][ci];
        acc[k][3] += w.w * d[k][ci];
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (!own[k]) continue;
      float* xp = xs + at[k] + PW + 1;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int o = o0 + j;
        const float y = (acc[k][j] + pwb[o]) + xp[o * PP];
        xp[o * PP] = y > 0.0f ? y : alpha[o] * y;
      }
    }
  }
}

// block_in_registers with the fewest rounds that cover np pixels.
template <int C, int K>
__device__ __forceinline__ void block_in_registers_for(float* xs, const float* wp, int PW, int PP,
                                                       int r0, int q0, int cw, int np) {
  if constexpr (K > 1) {
    if (np <= (K - 1) * kThreads) {
      block_in_registers_for<C, K - 1>(xs, wp, PW, PP, r0, q0, cw, np);
      return;
    }
  }
  block_in_registers<C, K>(xs, wp, PW, PP, r0, q0, cw, np);
}

template <int C, bool NHWC>
__global__ void __launch_bounds__(kThreads, kMinBlocks<C>) blaze_stage_kernel(
    const float* __restrict__ x,       // [B, C, H, W], or [B, H, W, C] if NHWC
    const float* __restrict__ params,  // [nb, C*C + 12*C], see cnn_stage.pack_blocks
    float* __restrict__ out,           // as x
    int H, int W, int nb, int tile_h, int tile_w, int tiles_w) {
  static_assert(C % kOuts == 0, "C must be a multiple of kOuts");
  constexpr int P = C * C + 12 * C;
  constexpr int G = C / kOuts;                  // work items per pixel
  constexpr int CS = C % 16 == 0 ? 16 : kOuts;  // channels per load and store row
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.y;
  const int ty = blockIdx.x / tiles_w;
  const int y0 = ty * tile_h, x0 = (blockIdx.x - ty * tiles_w) * tile_w;
  const int y1 = min(H, y0 + tile_h), x1 = min(W, x0 + tile_w);
  // The region: the tile and its halo, clipped to the image.
  const int ry0 = max(0, y0 - nb), rx0 = max(0, x0 - nb);
  const int ry1 = min(H, y1 + nb), rx1 = min(W, x1 + nb);
  const int RH = ry1 - ry0, RW = rx1 - rx0, R = RH * RW;
  // Region pixel (r, q) of channel c is xs[c*PP + (r+1)*PW + q+1].
  const int PW = RW + 1, PP = (RH + 1) * PW;
  const int tail = (RW + 5) & ~3;  // the PW+1 zeros after the last channel, to 4 floats

  // Every offset below is a multiple of 4 floats (C is one of 8, the tail
  // one of 4), so the float4 reads of the parameters are aligned.
  float* xs = smem;                // [C, RH+1, RW+1] + tail: the activation in its ring
  // Up to kRegisterChannels the depthwise stays in registers, unless the
  // launch's regions (the unclipped one, so every block of the launch
  // agrees; ops/cnn_stage.py _in_registers) are so small, as in the 3x3
  // heads, that a thread a pixel would leave most of the block idle.
  const bool in_registers = C <= kRegisterChannels &&
                            min(H, tile_h + 2 * nb) * min(W, tile_w + 2 * nb) > kThreads / 2;
  float* ds = xs + C * PP + tail;               // [C, RH, RW] the depthwise result, if not
  float* wp = ds + (in_registers ? 0 : C * R);  // one block's packed parameters
  const float* wt = wp;            // [C_in, C_out] pointwise weights
  const float* taps = wt + C * C;  // [9, C] depthwise taps, row-major
  const float* dwb = taps + 9 * C;
  const float* pwb = dwb + C;
  const float* alpha = pwb + C;

  const size_t plane = (size_t)H * W;
  // Global element (c, pixel) of an image: c * cs + pixel * ps.
  const size_t cs = NHWC ? 1 : plane, ps = NHWC ? C : 1;
  const float* xb = x + (size_t)b * C * plane;
  for (int i = threadIdx.x; i < tail; i += kThreads) xs[C * PP + i] = 0.0f;
  for_rows<C, CS>(RH + 1, PW, [&](int c0, int r, int q) {
    const bool in = r > 0 && q > 0;
    const float* src = xb + c0 * cs + (in ? ((size_t)(ry0 + r - 1) * W + rx0 + q - 1) * ps : 0);
    float* dst = xs + c0 * PP + r * PW + q;
#pragma unroll
    for (int j = 0; j < CS; ++j) dst[j * PP] = in ? __ldg(src + j * cs) : 0.0f;
  });

  for (int blk = 0; blk < nb; ++blk) {
    __syncthreads();  // the previous block is done with wp and ds
    const float* pb = params + (size_t)blk * P;
    for (int i = threadIdx.x; i < P; i += kThreads) wp[i] = __ldg(pb + i);
    __syncthreads();

    // Block blk computes the pixels at least blk+1 from each region edge
    // that is not the image's border: the window [r0, r1) x [q0, q1).
    const int m = blk + 1;
    const int r0 = ry0 > 0 ? m : 0, r1 = ry1 < H ? RH - m : RH;
    const int q0 = rx0 > 0 ? m : 0, q1 = rx1 < W ? RW - m : RW;
    const int cw = q1 - q0, np = (r1 - r0) * cw;
    if constexpr (C <= kRegisterChannels) {
      if (in_registers) {
        block_in_registers_for<C, kPixels<C>>(xs, wp, PW, PP, r0, q0, cw, np);
        continue;
      }
    }
    const float inv_cw = 1.0f / cw, inv_np = 1.0f / np;

    // Work item i: channels [8g, 8g+8) of window pixel p, i = g*np + p, so
    // the lanes of a warp take neighbouring pixels of the same channels.
    for (int i = threadIdx.x; i < G * np; i += kThreads) {
      const int g = div_small(i, inv_np), p = i - g * np;
      const int pr = div_small(p, inv_cw);
      const int r = r0 + pr, q = q0 + p - pr * cw, c0 = g * kOuts;
      // The top-left tap of region pixel (r, q).
      const float* xc = xs + c0 * PP + r * PW + q;
      const float4 b0 = *reinterpret_cast<const float4*>(dwb + c0);
      const float4 b1 = *reinterpret_cast<const float4*>(dwb + c0 + 4);
      float acc[kOuts] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const float4 t0 = *reinterpret_cast<const float4*>(taps + k * C + c0);
        const float4 t1 = *reinterpret_cast<const float4*>(taps + k * C + c0 + 4);
        const float* xk = xc + (k / 3) * PW + k % 3;
        acc[0] += t0.x * xk[0];
        acc[1] += t0.y * xk[PP];
        acc[2] += t0.z * xk[2 * PP];
        acc[3] += t0.w * xk[3 * PP];
        acc[4] += t1.x * xk[4 * PP];
        acc[5] += t1.y * xk[5 * PP];
        acc[6] += t1.z * xk[6 * PP];
        acc[7] += t1.w * xk[7 * PP];
      }
      float* dc = ds + c0 * R + r * RW + q;
#pragma unroll
      for (int j = 0; j < kOuts; ++j) dc[j * R] = acc[j];
    }
    __syncthreads();

    // Work item i: output channels [8g, 8g+8) of window pixel p.
    for (int i = threadIdx.x; i < G * np; i += kThreads) {
      const int g = div_small(i, inv_np), p = i - g * np;
      const int pr = div_small(p, inv_cw);
      const int r = r0 + pr, q = q0 + p - pr * cw, o0 = g * kOuts;
      const float* dp = ds + r * RW + q;
      float acc[kOuts];
#pragma unroll
      for (int j = 0; j < kOuts; ++j) acc[j] = 0.0f;
#pragma unroll
      for (int ci = 0; ci < C; ++ci) {
        const float d = dp[ci * R];
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
      float* xp = xs + (r + 1) * PW + q + 1;
#pragma unroll
      for (int j = 0; j < kOuts; ++j) {
        const int o = o0 + j;
        const float y = (acc[j] + pwb[o]) + xp[o * PP];
        xp[o * PP] = y > 0.0f ? y : alpha[o] * y;
      }
    }
  }
  __syncthreads();

  const int th = y1 - y0, tw = x1 - x0;
  float* ob = out + (size_t)b * C * plane;
  const float* xt = xs + (y0 - ry0 + 1) * PW + (x0 - rx0 + 1);
  for_rows<C, CS>(th, tw, [&](int c0, int r, int q) {
    float* dst = ob + c0 * cs + ((size_t)(y0 + r) * W + x0 + q) * ps;
    const float* src = xt + c0 * PP + r * PW + q;
#pragma unroll
    for (int j = 0; j < CS; ++j) dst[j * cs] = src[j * PP];
  });
}

template <int C, bool NHWC>
int launch(const void* x, const void* params, void* out, int batch, int H, int W, int nb,
           int tile_h, int tile_w, int smem_bytes, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      blaze_stage_kernel<C, NHWC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_w = (W + tile_w - 1) / tile_w;
  const int tiles_h = (H + tile_h - 1) / tile_h;
  const dim3 grid(tiles_h * tiles_w, batch);
  blaze_stage_kernel<C, NHWC><<<grid, kThreads, smem_bytes, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(params), static_cast<float*>(out),
      H, W, nb, tile_h, tile_w, tiles_w);
  return static_cast<int>(cudaGetLastError());
}

template <bool NHWC>
int launch_for(const void* x, const void* params, void* out, int batch, int C, int H, int W, int nb,
               int tile_h, int tile_w, int smem_bytes, cudaStream_t s) {
  switch (C) {
    case 16: return launch<16, NHWC>(x, params, out, batch, H, W, nb, tile_h, tile_w, smem_bytes, s);
    case 24: return launch<24, NHWC>(x, params, out, batch, H, W, nb, tile_h, tile_w, smem_bytes, s);
    case 32: return launch<32, NHWC>(x, params, out, batch, H, W, nb, tile_h, tile_w, smem_bytes, s);
    case 64: return launch<64, NHWC>(x, params, out, batch, H, W, nb, tile_h, tile_w, smem_bytes, s);
    case 96: return launch<96, NHWC>(x, params, out, batch, H, W, nb, tile_h, tile_w, smem_bytes, s);
    case 128: return launch<128, NHWC>(x, params, out, batch, H, W, nb, tile_h, tile_w, smem_bytes, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
