// The stride-2 residual bottleneck ("entry") block for Hopper (sm_90a):
//
//     t = PReLU_1(W1 s2d(x) + b1)                       2x2 stride-2 convolution, C_in -> M
//     u = dw3x3(t) + b_dw                               depthwise 3x3, zero padding 1, M channels
//     y = PReLU_2(W2 u + b2 + pad_C(MaxPool2x2,s2(x)))  1x1 convolution, M -> C_out = 2M
//
// on NCHW-contiguous [B, C_in, H, W] f32 (H, W even) -> [B, C_out, H/2, W/2],
// in one launch: s2d(x) is the space-to-depth view of x's 2x2 windows, the
// same windows the max pool reads, and pad_C appends zero channels from
// C_in to C_out. Face Mesh V2 (face_landmarks_detector.onnx) has six such
// blocks, (C_in, M) = (16, 16) at 128x128, (32, 32) at 64x64, (64, 64) at
// 32x32 and (128, 64) at 16, 8 and 4 pixels; the iris model six at 64 and
// 128 channels.
//
// This kernel replaces no TPU kernel: the JAX package runs these blocks op
// by op in XLA. It was added because op by op on the card each block is
// some ten passes over device memory (the MaxPool, the channel Pad, the 2x2
// convolution, the depthwise, the 1x1, the Add and two PReLUs, each PReLU
// three elementwise kernels), where the block needs one read of x and one
// write of y. A block does Ho*Wo*(M*(8*C_in + 2) + 19*M + C_out*(2*M + 3))
// operations and moves 4*(C_in*H*W + C_out*Ho*Wo) bytes a frame: the
// 16-channel block is bound by bytes on this card (67 TFLOP/s f32, 3.35
// TB/s), the 64- and 128-channel blocks by operations.
//
// Design. A thread block takes a band of tile_h output rows of one image
// (full width), or `images` whole images, and all C_out channels;
// ops/entry_block.py `tiling` picks the tile and the channel chunk `cc`.
// t is computed on the band and a halo of one output row above and below
// (the "region", clipped to the image); where the region meets the image
// border, t sits in a ring of zeros, which is the depthwise's padding
// (PReLU_1(b1) is not 0, so the padding is of t, not of x). Per thread
// block:
//
// 1. the biases, slopes, taps and W2 once, then for each chunk of cc input
//    channels in turn the region's input rows (full width: one contiguous
//    run of device memory an image and channel) and the chunk's rows of W1,
//    by asynchronous 16-byte copies (cp.async) into a ring of two stages, so
//    the next chunk loads while this one is used. From each chunk:
//    - the max pool of the band's 2x2 windows, kept in shared memory as the
//      residual (one read of x feeds both the pool and the convolution);
//    - the 2x2 convolution's partial sums, kept in registers across the
//      chunks: a warp owns 8 of the M outputs for up to kDownGroups groups
//      of 32 region pixels, a lane one pixel of each group; per input
//      channel and kernel row every lane reads the same 2x8 weights (a
//      broadcast) and its pixel's two inputs (kx = 0, 1) as one float2;
// 2. t = PReLU_1(sum + b1) into the padded buffer (in the ring's place);
// 3. u on the band: bias, then the nine taps row-major, one pixel and
//    channel a thread;
// 4. y on the band: [C_out, M] x [M, band], plus bias, plus the pooled
//    residual on the first C_in channels, PReLU_2, stored straight from
//    registers, lanes along a row (the same warp scheme, 8 outputs by up to
//    kUpGroups groups of 32 pixels).
//
// t and u never reach device memory; y is stored once.
//
// Arithmetic: f32 FMAs on the CUDA cores (no TF32, no tensor cores); the
// matrix products sum over input channels in order (the 2x2 taps of a
// channel row-major), then add the bias (and the residual); the depthwise
// starts from its bias; PReLU is `v < 0 ? a * v : v`, as the executor's
// `torch.where`. Built with FMA contraction on (ops/_build.py FMAD_ON):
// the kernel is compared with its plain version at the CNN bar.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kOuts = 8;         // output channels of a matrix-product unit
constexpr int kDownGroups = 8;   // 32-pixel groups of a 2x2-convolution unit, at most
constexpr int kUpGroups = 4;     // 32-pixel groups of a 1x1 unit, at most

// One block's parameters as ops/entry_block.py `layout` lays them out, in
// floats: W1 [4*C_in][M] with k = 4*ci + 2*ky + kx (input-major), then the
// part copied to shared memory once: b1, a1, b_dw [M], the taps [M][9],
// W2 [M][C_out] (input-major), b2, a2 [C_out]. Every offset is a multiple
// of 4 floats (M is a multiple of 8).
template <int CIN, int M>
struct Packed {
  static constexpr int COUT = 2 * M;
  static constexpr int SMALL0 = 4 * CIN * M;  // where the shared part starts
  // Offsets inside the shared part.
  static constexpr int B1 = 0;
  static constexpr int A1 = B1 + M;
  static constexpr int BDW = A1 + M;
  static constexpr int TAPS = BDW + M;
  static constexpr int W2 = TAPS + 9 * M;
  static constexpr int B2 = W2 + M * COUT;
  static constexpr int A2 = B2 + COUT;
  static constexpr int SMALL = A2 + COUT;
};

// floor(n / d) for 0 <= n < 2^22, given inv = 1.0f / d (d >= 1): exact,
// because (n + 0.5) / d lies at least 0.5 / d from an integer, and the two
// roundings (of inv and of the product) move it by less than
// (n + 0.5) / d * 2^-23 < 0.5 / d.
__device__ __forceinline__ int div_small(int n, float inv) {
  return __float2int_rz((static_cast<float>(n) + 0.5f) * inv);
}

// max of two values, NaN-propagating as the max pool is.
__device__ __forceinline__ float max2(float u, float v) { return (u != u || u > v) ? u : v; }

// The thread block's tile and the shared-memory strides of the launch.
// Region pixel p (of NT) is image i, region row r, column q; band pixel p
// (of NO) is image i, band row ro (output row oy0 + ro, region row
// ro + oy0 - ry0), column ox.
struct Geometry {
  int H, W, Ho, Wo;
  int b0, ni, oy0, th, ry0, rows;  // images b0.., output rows oy0.., region rows ry0..ry0+rows-1
  int XR, XC, XCmax;               // x rows a region holds; floats an input channel of the chunk
  int PW, TI, TS, TSmax;           // padded t: row, image and channel strides
  int NT, NO, NOmax;               // region and band pixels
  float inv_trow, inv_timg, inv_orow, inv_oimg, inv_no, inv_ti, inv_pw;

  __device__ Geometry(int B, int H_, int W_, int tile_h, int images) {
    H = H_;
    W = W_;
    Ho = H / 2;
    Wo = W / 2;
    const bool whole = tile_h >= Ho;
    const int TR = whole ? Ho : min(Ho, tile_h + 2);  // region rows at most
    b0 = blockIdx.y * images;
    ni = min(images, B - b0);
    oy0 = whole ? 0 : blockIdx.x * tile_h;
    th = whole ? Ho : min(tile_h, Ho - oy0);
    ry0 = whole ? 0 : max(0, oy0 - 1);
    rows = (whole ? Ho : min(Ho, oy0 + th + 1)) - ry0;
    XR = 2 * TR;
    XC = ni * XR * W;
    XCmax = images * XR * W;
    PW = Wo + 2;
    TI = (TR + 2) * PW;
    TS = ni * TI;
    TSmax = images * TI;
    NT = ni * rows * Wo;
    NO = ni * th * Wo;
    NOmax = images * (whole ? Ho : tile_h) * Wo;
    inv_trow = 1.0f / Wo;
    inv_timg = 1.0f / (rows * Wo);
    inv_orow = 1.0f / Wo;
    inv_oimg = 1.0f / (th * Wo);
    inv_no = 1.0f / NO;
    inv_ti = 1.0f / TI;
    inv_pw = 1.0f / PW;
  }

  // Region pixel p: image i, region row r, column q.
  __device__ __forceinline__ void region_at(int p, int& i, int& r, int& q) const {
    i = div_small(p, inv_timg);
    const int rem = p - i * rows * Wo;
    r = div_small(rem, inv_trow);
    q = rem - r * Wo;
  }

  // Band pixel p: image i, band row ro, column ox.
  __device__ __forceinline__ void band_at(int p, int& i, int& ro, int& ox) const {
    i = div_small(p, inv_oimg);
    const int rem = p - i * th * Wo;
    ro = div_small(rem, inv_orow);
    ox = rem - ro * Wo;
  }
};

// Starts the asynchronous copies of chunk c (input channels c*cc ..
// c*cc + cc - 1) into a stage: the region's input rows of each image and
// channel ([cc][ni][XR][W], one run of 2*rows*W floats each) and the
// chunk's 4*cc rows of W1 ([4*cc][M]).
template <int CIN, int M>
__device__ __forceinline__ void load_chunk(const float* x, const float* params, const Geometry& g, float* xs,
                                           float* ws, int c, int cc) {
  const int len4 = (2 * g.rows * g.W) >> 2;  // float4s of a run (W is even)
  const int runs = g.ni * cc;
  const float inv = 1.0f / len4, inv_cc = 1.0f / cc;
  const size_t plane = static_cast<size_t>(g.H) * g.W;
  for (int e = threadIdx.x; e < runs * len4; e += kThreads) {
    const int run = div_small(e, inv), k = e - run * len4;
    const int i = div_small(run, inv_cc), ci = run - i * cc;
    const float* src = x + (static_cast<size_t>(g.b0 + i) * CIN + c * cc + ci) * plane +
                       static_cast<size_t>(2 * g.ry0) * g.W + 4 * k;
    __pipeline_memcpy_async(xs + ci * g.XC + i * g.XR * g.W + 4 * k, src, 16);
  }
  const float* w = params + static_cast<size_t>(c) * 4 * cc * M;
  for (int e = threadIdx.x; e < cc * M; e += kThreads) __pipeline_memcpy_async(ws + 4 * e, w + 4 * e, 16);
}

// Phases 1 and 2 for a warp unit of G pixel groups: the chunks in turn (the
// pool into rs, the 2x2 convolution into registers), then t, padded, into
// ts (in the ring's place).
template <int CIN, int M, int G>
__device__ __forceinline__ void down_phase(const float* x, const float* params, const Geometry& g, const float* sp,
                                           float* rs, float* region, int stage, int cc) {
  using L = Packed<CIN, M>;
  constexpr int NOG = M / kOuts;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int og = warp % NOG, g0 = (warp / NOG) * G;
  const int groups = (g.NT + 31) >> 5;
  const bool active = g0 < groups;  // warp-uniform
  int off[G];
#pragma unroll
  for (int k = 0; k < G; ++k) {
    int i, r, q;
    g.region_at(min((g0 + k) * 32 + lane, g.NT - 1), i, r, q);
    off[k] = i * g.XR * g.W + 2 * r * g.W + 2 * q;  // the pixel's window's top left in a chunk channel
  }
  float acc[G][kOuts];
#pragma unroll
  for (int k = 0; k < G; ++k) {
#pragma unroll
    for (int j = 0; j < kOuts; ++j) acc[k][j] = 0.0f;
  }
  const int nc = CIN / cc;
  const int band_row = g.oy0 - g.ry0;  // the band's first row in the region
  for (int c = 0; c < nc; ++c) {
    float* xs = region + (c & 1) * stage;
    const float* ws = xs + cc * g.XCmax;
    if (c + 1 < nc) {
      float* nxt = region + ((c + 1) & 1) * stage;
      load_chunk<CIN, M>(x, params, g, nxt, nxt + cc * g.XCmax, c + 1, cc);
      __pipeline_commit();
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();

    // The max pool of the band's windows, channel-major.
    for (int e = threadIdx.x; e < cc * g.NO; e += kThreads) {
      const int ci = div_small(e, g.inv_no), p = e - ci * g.NO;
      int i, ro, ox;
      g.band_at(p, i, ro, ox);
      const float* xc = xs + ci * g.XC + i * g.XR * g.W + 2 * (band_row + ro) * g.W + 2 * ox;
      const float2 top = *reinterpret_cast<const float2*>(xc);
      const float2 bot = *reinterpret_cast<const float2*>(xc + g.W);
      rs[(c * cc + ci) * g.NO + p] = max2(max2(top.x, top.y), max2(bot.x, bot.y));
    }

    // The 2x2 convolution's sums over the chunk's channels.
    if (active) {
      const float* wo = ws + og * kOuts;
#pragma unroll 2
      for (int ci = 0; ci < cc; ++ci) {
        const float* xc = xs + ci * g.XC;
#pragma unroll
        for (int ky = 0; ky < 2; ++ky) {
          const float* w = wo + (4 * ci + 2 * ky) * M;
          const float4 a0 = *reinterpret_cast<const float4*>(w);
          const float4 a1 = *reinterpret_cast<const float4*>(w + 4);
          const float4 b0 = *reinterpret_cast<const float4*>(w + M);
          const float4 b1 = *reinterpret_cast<const float4*>(w + M + 4);
#pragma unroll
          for (int k = 0; k < G; ++k) {
            const float2 v = *reinterpret_cast<const float2*>(xc + off[k] + ky * g.W);
            acc[k][0] += a0.x * v.x;
            acc[k][0] += b0.x * v.y;
            acc[k][1] += a0.y * v.x;
            acc[k][1] += b0.y * v.y;
            acc[k][2] += a0.z * v.x;
            acc[k][2] += b0.z * v.y;
            acc[k][3] += a0.w * v.x;
            acc[k][3] += b0.w * v.y;
            acc[k][4] += a1.x * v.x;
            acc[k][4] += b1.x * v.y;
            acc[k][5] += a1.y * v.x;
            acc[k][5] += b1.y * v.y;
            acc[k][6] += a1.z * v.x;
            acc[k][6] += b1.z * v.y;
            acc[k][7] += a1.w * v.x;
            acc[k][7] += b1.w * v.y;
          }
        }
      }
    }
    __syncthreads();  // the stage is free for chunk c + 2
  }

  // t = PReLU_1(sum + b1) on the region, in a ring of zeros: each image's
  // region at padded row r + 1, column q + 1; the ring cells (and the rows
  // of a clipped region) zero.
  float* ts = region;
  for (int e = threadIdx.x; e < M * g.TS; e += kThreads) {
    const int rem = e - div_small(e, g.inv_ti) * g.TI;
    const int k = div_small(rem, g.inv_pw), j = rem - k * g.PW;
    if (k == 0 || k > g.rows || j == 0 || j > g.Wo) ts[e] = 0.0f;
  }
  if (active) {
#pragma unroll
    for (int j = 0; j < kOuts; ++j) {
      const int m = og * kOuts + j;
      const float bias = sp[L::B1 + m], slope = sp[L::A1 + m];
#pragma unroll
      for (int k = 0; k < G; ++k) {
        const int p = (g0 + k) * 32 + lane;
        if (p >= g.NT) continue;
        int i, r, q;
        g.region_at(p, i, r, q);
        const float t = acc[k][j] + bias;
        ts[m * g.TS + i * g.TI + (r + 1) * g.PW + q + 1] = t < 0.0f ? slope * t : t;
      }
    }
  }
}

// Pixel groups a 1x1 unit with NOG groups of kOuts outputs takes, of
// `groups` 32-pixel groups: kUpGroups, or fewer where the output groups are
// fewer than the warps, so that every warp has work.
template <int NOG>
__device__ __forceinline__ int groups_per_unit(int groups) {
  if constexpr (NOG >= kWarps) {
    return kUpGroups;
  } else {
    constexpr int split = (kWarps + NOG - 1) / NOG;
    return min(kUpGroups, max(1, (groups + split - 1) / split));
  }
}

// One unit of the 1x1: outputs [8og, 8og+8) of the K band-pixel groups from
// g0 (lane l: pixel 32*(g0+k) + l), then bias, the pooled residual on the
// first C_in channels and PReLU_2, stored.
template <int CIN, int M, int K>
__device__ __forceinline__ void up_unit(const Geometry& g, const float* sp, const float* us, const float* rs,
                                        float* out, int og, int g0) {
  using L = Packed<CIN, M>;
  constexpr int COUT = L::COUT;
  const int lane = threadIdx.x & 31;
  int p[K];
#pragma unroll
  for (int k = 0; k < K; ++k) p[k] = min((g0 + k) * 32 + lane, g.NO - 1);
  float acc[K][kOuts];
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int j = 0; j < kOuts; ++j) acc[k][j] = 0.0f;
  }
  const float* w = sp + L::W2 + og * kOuts;
#pragma unroll 8
  for (int m = 0; m < M; ++m) {
    const float4 w0 = *reinterpret_cast<const float4*>(w + m * COUT);
    const float4 w1 = *reinterpret_cast<const float4*>(w + m * COUT + 4);
    const float* um = us + m * g.NO;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float v = um[p[k]];
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
  const size_t oplane = static_cast<size_t>(g.Ho) * g.Wo;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if ((g0 + k) * 32 + lane >= g.NO) continue;
    int i, ro, ox;
    g.band_at(p[k], i, ro, ox);
    float* o = out + (static_cast<size_t>(g.b0 + i) * COUT + og * kOuts) * oplane +
               static_cast<size_t>(g.oy0 + ro) * g.Wo + ox;
#pragma unroll
    for (int j = 0; j < kOuts; ++j) {
      const int co = og * kOuts + j;
      float y = acc[k][j] + sp[L::B2 + co];
      if (co < CIN) y += rs[co * g.NO + p[k]];
      o[j * oplane] = y < 0.0f ? sp[L::A2 + co] * y : y;
    }
  }
}

// Two thread blocks an SM where the tile's shared memory allows (at most
// 128 registers a thread): on the card 16 warps a thread block, one an SM,
// ran the three largest of Face Mesh V2's blocks 4-5% faster and the small
// ones slower (PERF.md section 6).
template <int CIN, int M>
__global__ void __launch_bounds__(kThreads, 2) entry_block_kernel(
    const float* __restrict__ x,       // [B, CIN, H, W]
    const float* __restrict__ params,  // the packed row, see Packed
    float* __restrict__ out,           // [B, 2M, H/2, W/2]
    int B, int H, int W, int tile_h, int images, int cc) {
  using L = Packed<CIN, M>;
  constexpr int COUT = L::COUT;
  extern __shared__ float4 smem4[];
  const Geometry g(B, H, W, tile_h, images);
  float* sp = reinterpret_cast<float*>(smem4);             // the biases, slopes, taps and W2
  float* rs = sp + L::SMALL;                               // [CIN][NO] the pooled residual
  float* region = rs + ((CIN * g.NOmax + 3) & ~3);         // the chunk ring; then t and u
  const int stage = cc * g.XCmax + 4 * cc * M;             // floats of a ring stage

  // 1-2. The shared parameters and chunk 0 (one commit group), then every
  //      chunk and t.
  for (int e = threadIdx.x; e < L::SMALL / 4; e += kThreads) {
    __pipeline_memcpy_async(smem4 + e, reinterpret_cast<const float4*>(params + L::SMALL0) + e, 16);
  }
  load_chunk<CIN, M>(x, params, g, region, region + cc * g.XCmax, 0, cc);
  __pipeline_commit();
  {
    constexpr int WPO = kWarps / (M / kOuts);  // warps for each group of 8 outputs
    const int groups = (g.NT + 31) >> 5;
    switch ((groups + WPO - 1) / WPO) {
      case 1: down_phase<CIN, M, 1>(x, params, g, sp, rs, region, stage, cc); break;
      case 2: down_phase<CIN, M, 2>(x, params, g, sp, rs, region, stage, cc); break;
      case 3: down_phase<CIN, M, 3>(x, params, g, sp, rs, region, stage, cc); break;
      case 4: down_phase<CIN, M, 4>(x, params, g, sp, rs, region, stage, cc); break;
      case 5: down_phase<CIN, M, 5>(x, params, g, sp, rs, region, stage, cc); break;
      case 6: down_phase<CIN, M, 6>(x, params, g, sp, rs, region, stage, cc); break;
      case 7: down_phase<CIN, M, 7>(x, params, g, sp, rs, region, stage, cc); break;
      default: down_phase<CIN, M, kDownGroups>(x, params, g, sp, rs, region, stage, cc); break;
    }
  }
  __syncthreads();

  // 3. u = dw3x3(t) + b_dw on the band: item e is channel m, band pixel p.
  const float* ts = region;
  float* us = region + M * g.TSmax;  // [M][NO]
  {
    const int band_row = g.oy0 - g.ry0;
    for (int e = threadIdx.x; e < M * g.NO; e += kThreads) {
      const int m = div_small(e, g.inv_no), p = e - m * g.NO;
      int i, ro, ox;
      g.band_at(p, i, ro, ox);
      // The top-left tap: padded row (region row - 1) + 1, column ox - 1 + 1.
      const float* tc = ts + m * g.TS + i * g.TI + (band_row + ro) * g.PW + ox;
      const float* tap = sp + L::TAPS + m * 9;
      float u = sp[L::BDW + m];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) u += tap[dy * 3 + dx] * tc[dy * g.PW + dx];
      }
      us[m * g.NO + p] = u;
    }
  }
  __syncthreads();

  // 4. y = PReLU_2(W2 u + b2 + residual) on the band, stored.
  {
    constexpr int NOG = COUT / kOuts;
    const int groups = (g.NO + 31) >> 5, per = groups_per_unit<NOG>(groups);
    for (int u = threadIdx.x >> 5; u < NOG * ((groups + per - 1) / per); u += kWarps) {
      const int chunk = u / NOG, og = u - chunk * NOG, g0 = chunk * per;
      switch (min(per, groups - g0)) {
        case 4: up_unit<CIN, M, 4>(g, sp, us, rs, out, og, g0); break;
        case 3: up_unit<CIN, M, 3>(g, sp, us, rs, out, og, g0); break;
        case 2: up_unit<CIN, M, 2>(g, sp, us, rs, out, og, g0); break;
        default: up_unit<CIN, M, 1>(g, sp, us, rs, out, og, g0); break;
      }
    }
  }
}

template <int CIN, int M>
int launch(const void* x, const void* params, void* out, int batch, int H, int W, int tile_h, int images, int cc,
           int smem_bytes, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(entry_block_kernel<CIN, M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int Ho = H / 2;
  const dim3 grid(tile_h >= Ho ? 1 : (Ho + tile_h - 1) / tile_h, (batch + images - 1) / images);
  entry_block_kernel<CIN, M><<<grid, kThreads, smem_bytes, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(params), static_cast<float*>(out), batch, H, W,
      tile_h, images, cc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One entry block on `stream`; allocates nothing and does not synchronise.
// (cin, m) must be one of (16, 16), (32, 32), (64, 64), (128, 64)
// (ops/entry_block.py KERNEL_WIDTHS), H and W even, cc a divisor of cin,
// else cudaErrorInvalidValue; `x` and `params` (the packed row,
// ops/entry_block.py `pack_entry_block`) 16-byte aligned; `tile_h`,
// `images` and `cc` as ops/entry_block.py `tiling` gives them, `smem_bytes`
// its `_smem_bytes`. Returns the CUDA error code (0 when the launch was
// accepted).
extern "C" int zaru_entry_block(const void* x, const void* params, void* out, int batch, int cin, int m, int H,
                                int W, int tile_h, int images, int cc, int smem_bytes, void* stream) {
  if (H < 2 || W < 2 || H % 2 || W % 2 || tile_h < 1 || images < 1 || cc < 1 || cin % cc) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cin == 16 && m == 16) return launch<16, 16>(x, params, out, batch, H, W, tile_h, images, cc, smem_bytes, s);
  if (cin == 32 && m == 32) return launch<32, 32>(x, params, out, batch, H, W, tile_h, images, cc, smem_bytes, s);
  if (cin == 64 && m == 64) return launch<64, 64>(x, params, out, batch, H, W, tile_h, images, cc, smem_bytes, s);
  if (cin == 128 && m == 64) return launch<128, 64>(x, params, out, batch, H, W, tile_h, images, cc, smem_bytes, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
