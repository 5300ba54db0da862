// Fused residual bottleneck blocks for Hopper (sm_90a): nb consecutive
// stride-1 blocks
//
//     t = PReLU_1(W1 x + b1)          1x1 convolution, C -> C/2
//     u = dw3x3(t) + b_dw             depthwise 3x3, zero padding 1, C/2 channels
//     x <- PReLU_2(W2 u + b2 + x)     1x1 convolution, C/2 -> C, residual Add
//
// on NCHW-contiguous [B, C, H, W] f32, in one launch: device memory sees one
// read of the first block's input and one write of the last block's output;
// t, u and the activations between the blocks stay in shared memory. Face
// Mesh V2 (face_landmarks_detector.onnx) has 28 such blocks, in chains of
// four at 16x128x128, 32x64x64, 64x32x32 and 128 channels at 16, 8, 4 and 2
// pixels; the iris model 20 at 64 and 128 channels.
//
// This kernel replaces no TPU kernel: the JAX package runs these blocks op
// by op in XLA. It was added because op by op on the card each block is six
// passes over device memory (the two cuDNN 1x1s, the depthwise, the Add and
// two PReLUs, each PReLU three elementwise kernels), about 16.75*C*H*W
// floats an image where the block needs 2*C*H*W.
//
// Design. A thread block takes one output tile of one image, or `images`
// whole images where an image is small (the 4x4 and 2x2 blocks at batch
// 512), so that its threads have work. The wrapper cuts a chain into
// launches of one block or more and picks each launch's tile
// (ops/bottleneck.py `plan`, a cost model fitted to this kernel's times).
// Per thread block:
//
// 1. load the blocks' packed parameters and the region (the tile and an
//    nb-pixel halo, clipped to the image) of all C channels into shared
//    memory, by asynchronous copies (cp.async), all in flight at once;
//    lanes run along a row, so the loads are coalesced;
// 2. per block, t on the block's input window (the region less blk pixels
//    on each interior side): a small matrix product [C/2, C] x [C, window],
//    then PReLU, into a buffer where each image's region sits in a ring of
//    zeros. The depthwise conv pads t with zeros, not x (PReLU(b1) is not
//    0), so t is computed only on pixels inside the image and the ring, on
//    the sides where the region meets the image border, is that padding;
//    on an interior side no output pixel reads past the window;
// 3. u on the block's output window (one pixel less on each interior
//    side): bias, then the nine taps row-major, 8 channels of a column of
//    four pixels a work item, each t read once;
// 4. y on the output window: [C, C/2] x [C/2, window], plus bias, plus x
//    read from shared memory, PReLU, written back in place of x or, by the
//    last block, whose output window is the tile, stored straight from
//    registers, lanes along a row.
//
// The two matrix products share one scheme: a warp's unit of work is
// kOuts = 8 output channels of up to kGroups groups of 32 pixels, a lane
// one pixel of each group, so every lane of a warp reads the same weights
// (a broadcast from shared memory) and neighbouring activations (no bank
// conflicts). Units are dealt out so that the sixteen warps share the
// work even where the outputs are few (C = 16: 8 outputs, one channel
// group).
//
// Arithmetic: f32 FMAs on the CUDA cores (no TF32, no tensor cores); the
// matrix products sum over input channels in order, then add the bias
// (and the residual); PReLU is `v < 0 ? a * v : v`, as the executor's
// `torch.where`. Built with FMA contraction on (ops/_build.py FMAD_ON):
// the kernel is compared with its plain version at the CNN bar.
//
// Bound. A block does B*H*W*C*(2*C + 13.5) operations and moves 2*B*C*H*W*4
// bytes: at C = 16 and 32 it is bound by bytes, at 64 about even, at 128 by
// operations. On the card it runs at about a fifth of that bound (PERF.md
// section 6, chip_smoke.py phase 6): a thread block's phases follow each
// other behind barriers, and one thread block an SM hides only part of
// their latency.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

// 16 warps a thread block, one thread block an SM (at most 128 registers a
// thread): on the card this ran V2's chains 13% faster than 8 warps with
// up to three thread blocks an SM (PERF.md section 6), the phases' latency
// hidden by more warps rather than by more thread blocks.
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kOuts = 8;    // output channels of a matrix-product unit; channels of a depthwise item
constexpr int kGroups = 4;  // 32-pixel groups of a matrix-product unit, at most

// One block's parameters as ops/bottleneck.py `pack_bottlenecks` lays them
// out: every offset a multiple of 4 floats (C is a multiple of 16).
template <int C>
struct Packed {
  static constexpr int M = C / 2;
  static constexpr int W1 = 0;              // [C][M]: the first 1x1, input-major
  static constexpr int B1 = W1 + C * M;     // [M]
  static constexpr int A1 = B1 + M;         // [M] slopes of the first PReLU
  static constexpr int TAPS = A1 + M;       // [9][M] depthwise taps, row-major
  static constexpr int BDW = TAPS + 9 * M;  // [M]
  static constexpr int W2 = BDW + M;        // [M][C]: the second 1x1, input-major
  static constexpr int B2 = W2 + M * C;     // [C]
  static constexpr int A2 = B2 + C;         // [C] slopes of the second PReLU
  static constexpr int P = A2 + C;          // C*C + 8*C
};

// floor(n / d) for 0 <= n < 2^22, given inv = 1.0f / d (d >= 1): exact,
// because (n + 0.5) / d lies at least 0.5 / d from an integer, and the two
// roundings (of inv and of the product) move it by less than
// (n + 0.5) / d * 2^-23 < 0.5 / d.
__device__ __forceinline__ int div_small(int n, float inv) {
  return __float2int_rz((static_cast<float>(n) + 0.5f) * inv);
}

// The geometry of one thread block: `ni` images, each a region of RH x RW
// pixels (the output tile of th x tw at (y0, x0) and an nb-pixel halo,
// clipped to the image) at (ry0, rx0). The padded intermediate holds each
// image's region in a ring of zeros: rows of PW = RW + 2 floats, PI floats
// an image, TS floats a channel. A side of the region is interior where it
// does not lie on the image's border.
struct Geometry {
  int b0, ni;
  int ry0, rx0, RH, RW, RP, PW, PI, TS, NP1;
  bool top, bottom, left, right;

  // The thread block's tile: tile blockIdx.x of image group blockIdx.y.
  __device__ Geometry(int B, int H, int W, int tile_h, int tile_w, int tiles_w, int images, int nb) {
    b0 = blockIdx.y * images;
    ni = min(images, B - b0);
    const int ty = blockIdx.x / tiles_w;
    const int y0 = ty * tile_h, x0 = (blockIdx.x - ty * tiles_w) * tile_w;
    const int y1 = min(H, y0 + tile_h), x1 = min(W, x0 + tile_w);
    ry0 = max(0, y0 - nb);
    rx0 = max(0, x0 - nb);
    const int ry1 = min(H, y1 + nb), rx1 = min(W, x1 + nb);
    RH = ry1 - ry0;
    RW = rx1 - rx0;
    RP = RH * RW;
    PW = RW + 2;
    PI = (RH + 2) * PW;
    TS = ni * PI;
    NP1 = ni * RP;
    top = ry0 > 0;
    bottom = ry1 < H;
    left = rx0 > 0;
    right = rx1 < W;
  }
};

// The pixels a block reads or writes: each image's region less m pixels on
// every interior side, n pixels in all; pixel p is image i, region row r,
// region column q.
struct Window {
  int r0, q0, h, w, n;
  float inv_hw, inv_w;

  __device__ Window(const Geometry& g, int m) {
    r0 = g.top ? m : 0;
    q0 = g.left ? m : 0;
    h = (g.bottom ? g.RH - m : g.RH) - r0;
    w = (g.right ? g.RW - m : g.RW) - q0;
    n = g.ni * h * w;
    inv_hw = 1.0f / (h * w);
    inv_w = 1.0f / w;
  }

  __device__ __forceinline__ void at(int p, int& i, int& r, int& q) const {
    i = div_small(p, inv_hw);
    const int rem = p - i * h * w;
    r = div_small(rem, inv_w);
    q = rem - r * w + q0;
    r += r0;
  }
};

// Pixel groups a unit of a matrix product with NOG groups of kOuts outputs
// takes, of `groups` 32-pixel groups: kGroups, or fewer where the output
// groups are fewer than the warps, so that every warp has work.
template <int NOG>
__device__ __forceinline__ int groups_per_unit(int groups) {
  if constexpr (NOG >= kWarps) {
    return kGroups;
  } else {
    constexpr int split = (kWarps + NOG - 1) / NOG;
    return min(kGroups, max(1, (groups + split - 1) / split));
  }
}

// acc[k][j] = sum over ci < KIN of w[ci * ROW + j] * a[ci * stride + p[k]],
// in the order of ci.
template <int KIN, int ROW, int K>
__device__ __forceinline__ void product(const float* w, const float* a, int stride, const int (&p)[K],
                                        float (&acc)[K][kOuts]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int j = 0; j < kOuts; ++j) acc[k][j] = 0.0f;
  }
#pragma unroll 8
  for (int ci = 0; ci < KIN; ++ci) {
    const float4 w0 = *reinterpret_cast<const float4*>(w + ci * ROW);
    const float4 w1 = *reinterpret_cast<const float4*>(w + ci * ROW + 4);
    const float* ac = a + ci * stride;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float v = ac[p[k]];
      acc[k][0] += w0.x * v;
      acc[k][1] += w0.y * v;
      acc[k][2] += w0.z * v;
      acc[k][3] += w0.w * v;
      acc[k][4] += w1.x * v;
      acc[k][5] += w1.y * v;
      acc[k][6] += w1.z * v;
      acc[k][7] += w1.w * v;
    }
  }
}

// One unit of the first 1x1: outputs [8og, 8og+8) of the K pixel groups of
// window `in` from g0 (lane l: pixel 32*(g0+k) + l), then bias and
// PReLU_1, into the padded buffer.
template <int C, int K>
__device__ __forceinline__ void down_unit(const Geometry& g, const Window& in, const float* wp, const float* xs,
                                          float* ts, int og, int g0) {
  using L = Packed<C>;
  const int lane = threadIdx.x & 31;
  int at[K], pad[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    int i, r, q;
    in.at(min((g0 + k) * 32 + lane, in.n - 1), i, r, q);
    at[k] = i * g.RP + r * g.RW + q;
    pad[k] = i * g.PI + (r + 1) * g.PW + q + 1;
  }
  float acc[K][kOuts];
  product<C, L::M, K>(wp + L::W1 + og * kOuts, xs, g.NP1, at, acc);
  const float4 b0 = *reinterpret_cast<const float4*>(wp + L::B1 + og * kOuts);
  const float4 b1 = *reinterpret_cast<const float4*>(wp + L::B1 + og * kOuts + 4);
  const float4 a0 = *reinterpret_cast<const float4*>(wp + L::A1 + og * kOuts);
  const float4 a1 = *reinterpret_cast<const float4*>(wp + L::A1 + og * kOuts + 4);
  const float bias[kOuts] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
  const float slope[kOuts] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if ((g0 + k) * 32 + lane >= in.n) continue;
    float* dst = ts + og * kOuts * g.TS + pad[k];
#pragma unroll
    for (int j = 0; j < kOuts; ++j) {
      const float t = acc[k][j] + bias[j];
      dst[j * g.TS] = t < 0.0f ? slope[j] * t : t;
    }
  }
}

// One unit of the second 1x1: outputs [8og, 8og+8) of the K pixel groups
// of window `out` from g0, then bias, the residual x and PReLU_2: written
// back into x in shared memory, or, for the launch's last block, stored to
// `ob` (the thread block's first image of the output).
template <int C, int K>
__device__ __forceinline__ void up_unit(const Geometry& g, const Window& out, const float* wp, const float* us,
                                        float* xs, float* ob, size_t plane, int W, bool last, int og, int g0) {
  using L = Packed<C>;
  const int lane = threadIdx.x & 31;
  int p[K], at[K];
  size_t to[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    int i, r, q;
    p[k] = min((g0 + k) * 32 + lane, out.n - 1);
    out.at(p[k], i, r, q);
    at[k] = i * g.RP + r * g.RW + q;
    to[k] = (static_cast<size_t>(i) * C + og * kOuts) * plane + static_cast<size_t>(g.ry0 + r) * W + g.rx0 + q;
  }
  float acc[K][kOuts];
  product<L::M, C, K>(wp + L::W2 + og * kOuts, us, out.n, p, acc);
  const float4 b0 = *reinterpret_cast<const float4*>(wp + L::B2 + og * kOuts);
  const float4 b1 = *reinterpret_cast<const float4*>(wp + L::B2 + og * kOuts + 4);
  const float4 a0 = *reinterpret_cast<const float4*>(wp + L::A2 + og * kOuts);
  const float4 a1 = *reinterpret_cast<const float4*>(wp + L::A2 + og * kOuts + 4);
  const float bias[kOuts] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
  const float slope[kOuts] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if ((g0 + k) * 32 + lane >= out.n) continue;
    float* xr = xs + og * kOuts * g.NP1 + at[k];
#pragma unroll
    for (int j = 0; j < kOuts; ++j) {
      float y = (acc[k][j] + bias[j]) + xr[j * g.NP1];
      y = y < 0.0f ? slope[j] * y : y;
      if (last) {
        ob[to[k] + j * plane] = y;
      } else {
        xr[j * g.NP1] = y;
      }
    }
  }
}

// Starts the asynchronous copies (cp.async) of x on the regions of g into
// xs, one commit group: a row (image i, channel c, region row r) goes to a group of lw lanes,
// the least power of two >= RW (at most 32), rows in the order of device
// memory for whole images, so the loads are coalesced.
template <int C>
__device__ __forceinline__ void load_regions(const Geometry& g, const float* x, float* xs, size_t plane, int W) {
  int lws = 5;
  while (lws > 0 && (1 << (lws - 1)) >= g.RW) --lws;
  const int lw = 1 << lws;
  const float inv_rh = 1.0f / g.RH;
  for (int u = threadIdx.x >> lws; u < g.ni * C * g.RH; u += kThreads >> lws) {
    const int ic = div_small(u, inv_rh), r = u - ic * g.RH;
    const int i = ic / C, c = ic - i * C;
    const float* src =
        x + (static_cast<size_t>(g.b0 + i) * C + c) * plane + static_cast<size_t>(g.ry0 + r) * W + g.rx0;
    float* dst = xs + c * g.NP1 + i * g.RP + r * g.RW;
    for (int q = threadIdx.x & (lw - 1); q < g.RW; q += lw) __pipeline_memcpy_async(dst + q, src + q, 4);
  }
  __pipeline_commit();
}

template <int C>
__global__ void __launch_bounds__(kThreads, 1) bottleneck_block_kernel(
    const float* __restrict__ x,       // [B, C, H, W]
    const float* __restrict__ params,  // [nb][C*C + 8*C], see Packed
    float* __restrict__ out,           // [B, C, H, W]
    int B, int H, int W, int tile_h, int tile_w, int tiles_w, int images, int nb) {
  using L = Packed<C>;
  constexpr int M = L::M;
  static_assert(M % kOuts == 0, "C must be a multiple of 16");
  extern __shared__ float4 smem4[];
  const Geometry g(B, H, W, tile_h, tile_w, tiles_w, images, nb);
  float* wps = reinterpret_cast<float*>(smem4);  // [nb][P] the packed parameters
  float* xs = wps + nb * L::P;                   // [C][NP1] x on the regions, then each block's output
  float* ts = xs + C * g.NP1;                    // [M][TS] t, padded
  float* us = ts + M * g.TS;                     // [M][n] u on a block's output window
  const size_t plane = static_cast<size_t>(H) * W;

  // 1. The parameters and x, copied asynchronously (cp.async), so that a
  //    thread's loads are all in flight at once, and the zeros of the
  //    padded intermediate meanwhile.
  for (int i = threadIdx.x; i < nb * L::P / 4; i += kThreads) {
    __pipeline_memcpy_async(smem4 + i, reinterpret_cast<const float4*>(params) + i, 16);
  }
  load_regions<C>(g, x, xs, plane, W);
  for (int i = threadIdx.x; i < M * g.TS; i += kThreads) ts[i] = 0.0f;
  __pipeline_wait_prior(0);
  __syncthreads();

  float* ob = out + static_cast<size_t>(g.b0) * C * plane;
  for (int blk = 0; blk < nb; ++blk) {
    const float* wp = wps + blk * L::P;
    // Block blk reads the region less blk pixels on each interior side
    // and writes it less blk + 1: the last block writes the tile.
    const Window in(g, blk), wout(g, blk + 1);
    const bool last = blk == nb - 1;

    // 2. t = PReLU_1(W1 x + b1) on the input window, into the padded buffer.
    {
      constexpr int NOG = M / kOuts;
      const int groups = (in.n + 31) >> 5, per = groups_per_unit<NOG>(groups);
      for (int u = threadIdx.x >> 5; u < NOG * ((groups + per - 1) / per); u += kWarps) {
        const int chunk = u / NOG, og = u - chunk * NOG, g0 = chunk * per;
        switch (min(per, groups - g0)) {
          case 4: down_unit<C, 4>(g, in, wp, xs, ts, og, g0); break;
          case 3: down_unit<C, 3>(g, in, wp, xs, ts, og, g0); break;
          case 2: down_unit<C, 2>(g, in, wp, xs, ts, og, g0); break;
          default: down_unit<C, 1>(g, in, wp, xs, ts, og, g0); break;
        }
      }
    }
    __syncthreads();

    // 3. u = dw3x3(t) + b_dw on the output window. Item e: channels
    //    [8h, 8h+8) of a column of up to four pixels (window rows 4b..4b+3 at
    //    column q of image i), e = h * nq + (i * bands + b) * w + q, so a
    //    warp's lanes take neighbouring columns, and a thread reads each t of
    //    its column's six rows once for its four pixels.
    {
      const int bands = (wout.h + 3) >> 2, nq = g.ni * bands * wout.w;
      const float inv_nq = 1.0f / nq, inv_w = 1.0f / wout.w, inv_bands = 1.0f / bands;
      for (int e = threadIdx.x; e < (M / kOuts) * nq; e += kThreads) {
        const int h = div_small(e, inv_nq), rest = e - h * nq;
        const int ib = div_small(rest, inv_w), q = rest - ib * wout.w;
        const int i = div_small(ib, inv_bands), b = ib - i * bands;
        const int rows = min(4, wout.h - 4 * b);
        // The top-left tap of the column's first pixel in the padded buffer,
        // its rows clamped to those the column reads.
        const float* tc = ts + h * kOuts * g.TS + i * g.PI + (wout.r0 + 4 * b) * g.PW + wout.q0 + q;
        int row[6];
#pragma unroll
        for (int d = 0; d < 6; ++d) row[d] = min(d, rows + 1) * g.PW;
        float* uc = us + h * kOuts * wout.n + (i * wout.h + 4 * b) * wout.w + q;
#pragma unroll
        for (int half = 0; half < kOuts; half += 4) {
          const int c0 = h * kOuts + half;
          float4 tap[9];
#pragma unroll
          for (int k = 0; k < 9; ++k) tap[k] = *reinterpret_cast<const float4*>(wp + L::TAPS + k * M + c0);
          const float4 bias = *reinterpret_cast<const float4*>(wp + L::BDW + c0);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float* tj = tc + (half + j) * g.TS;
            float v[6][3];
#pragma unroll
            for (int d = 0; d < 6; ++d) {
#pragma unroll
              for (int dx = 0; dx < 3; ++dx) v[d][dx] = tj[row[d] + dx];
            }
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              float acc = (&bias.x)[j];
#pragma unroll
              for (int t = 0; t < 9; ++t) acc += (&tap[t].x)[j] * v[k + t / 3][t % 3];
              if (k < rows) uc[(half + j) * wout.n + k * wout.w] = acc;
            }
          }
        }
      }
    }
    __syncthreads();

    // 4. y = PReLU_2(W2 u + b2 + x) on the output window: into x's place,
    //    or stored by the last block.
    {
      constexpr int NOG = C / kOuts;
      const int groups = (wout.n + 31) >> 5, per = groups_per_unit<NOG>(groups);
      for (int u = threadIdx.x >> 5; u < NOG * ((groups + per - 1) / per); u += kWarps) {
        const int chunk = u / NOG, og = u - chunk * NOG, g0 = chunk * per;
        switch (min(per, groups - g0)) {
          case 4: up_unit<C, 4>(g, wout, wp, us, xs, ob, plane, W, last, og, g0); break;
          case 3: up_unit<C, 3>(g, wout, wp, us, xs, ob, plane, W, last, og, g0); break;
          case 2: up_unit<C, 2>(g, wout, wp, us, xs, ob, plane, W, last, og, g0); break;
          default: up_unit<C, 1>(g, wout, wp, us, xs, ob, plane, W, last, og, g0); break;
        }
      }
    }
    if (!last) __syncthreads();
  }
}

template <int C>
int launch(const void* x, const void* params, void* out, int batch, int H, int W, int nb, int tile_h, int tile_w,
           int images, int smem_bytes, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(bottleneck_block_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_w = (W + tile_w - 1) / tile_w;
  const dim3 grid((H + tile_h - 1) / tile_h * tiles_w, (batch + images - 1) / images);
  bottleneck_block_kernel<C><<<grid, kThreads, smem_bytes, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(params), static_cast<float*>(out), batch, H, W,
      tile_h, tile_w, tiles_w, images, nb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// nb consecutive bottleneck blocks on `stream`; allocates nothing and does
// not synchronise. C must be one of 16, 32, 64, 128 (ops/bottleneck.py
// KERNEL_CHANNELS), else cudaErrorInvalidValue; `params` is nb rows of the
// packed layout, 16-byte aligned; `smem_bytes` is the dynamic shared memory
// of the largest tile (ops/bottleneck.py _smem_bytes). Returns the CUDA
// error code (0 when the launch was accepted).
extern "C" int zaru_bottleneck_stage(const void* x, const void* params, void* out, int batch, int C, int H, int W,
                                     int nb, int tile_h, int tile_w, int images, int smem_bytes, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 16: return launch<16>(x, params, out, batch, H, W, nb, tile_h, tile_w, images, smem_bytes, s);
    case 32: return launch<32>(x, params, out, batch, H, W, nb, tile_h, tile_w, images, smem_bytes, s);
    case 64: return launch<64>(x, params, out, batch, H, W, nb, tile_h, tile_w, images, smem_bytes, s);
    case 128: return launch<128>(x, params, out, batch, H, W, nb, tile_h, tile_w, images, smem_bytes, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
