// One BlazeBlock whose residual is not its plain input, for Hopper (sm_90a):
//
//     y = act(W_pw (dw3x3_s(x) + b_dw) + b_pw + pad_C(pool_s(x)))
//
// on NCHW-contiguous [B, C_in, H, W] f32 -> [B, C_out, Ho, Wo], in one launch:
// s is 1 or 2, pool_2 the 2x2 stride-2 max pool (pool_1 the identity), pad_C
// zero channels from C_in up to C_out, act ReLU or PReLU (C_out slopes). The
// depthwise pads are (1, 1, 1, 1) at stride 1 and one pixel an axis at
// stride 2, (pt, pl) before. BlazeFace short range has 11 such blocks
// (24->28 ... 80->88 at stride 1, 28->32, 42->48, 88->96 at stride 2), Face
// Mesh V1 6 (16->32, 32->64, 64->128 and three 128->128, all stride 2).
//
// This kernel replaces no TPU kernel: the JAX package runs these blocks op
// by op in XLA. It was added because op by op on the card each block is 5-8
// passes over device memory (the channels' Pad, the stride-2 depthwise's
// spatial Pad, the depthwise, the 1x1 in cuDNN, the MaxPool, the Add and the
// activation, PReLU as three elementwise kernels), where the block needs one
// read of its input and one write of its output. At the face models' widths
// (16-128 channels) a block does 2*C_in*C_out + 19*C_in + 3*C_out operations
// an output pixel and moves (C_in*s*s + C_out)*4 bytes: every block of the
// two models is bound by bytes on this card (67 TFLOP/s f32, 3.35 TB/s).
//
// Design. A thread block takes a band of tile_h output rows of one image
// (full width), or `images` whole images where an image is small (6x6, 3x3),
// and all C_out channels; ops/blaze_block.py `tiling` picks the band. Per
// thread block:
//
// 1. copy the packed parameters and the input rows the band reads, of every
//    input channel, into shared memory by asynchronous 16-byte copies
//    (cp.async; 4-byte ones where a row is not a multiple of four floats):
//    full-width rows, so each channel's rows are one contiguous run of device
//    memory, and a whole image's C_in planes are one run too;
// 2. the depthwise on the band: a thread takes a pixel (lanes along a row)
//    and a share of the channels; bias, then the nine taps row-major (taps
//    outside the image are the zero padding and are skipped), into shared
//    memory;
// 3. the 1x1 as a register tile: a warp's unit is 8 output channels of up to
//    4 groups of 32 pixels, a lane one pixel of each group, so every lane
//    reads the same weights (a broadcast) and neighbouring depthwise outputs
//    (no bank conflicts); then the bias, the residual taken from the input
//    rows already in shared memory (the 2x2 max at stride 2, nothing for the
//    padded channels), the activation, and a store whose lanes run along a
//    row of the output plane.
//
// Channels are run-time values: the 17 blocks of the face models have 14
// (C_in, C_out) pairs, several of them no multiple of 8 (28, 36, 42), so a
// template over the pairs would build 14 kernels for a loop whose trip count
// is the only difference; the outputs are padded to a multiple of 8 in the
// packed weights instead (zeros), and the padded outputs are not stored.
//
// Arithmetic: f32 FMAs on the CUDA cores (no TF32, no tensor cores); the 1x1
// sums over input channels in order, then adds its bias, then the residual;
// PReLU is `v < 0 ? a * v : v`, as the executor's `torch.where`. Built with
// FMA contraction on (ops/_build.py FMAD_ON): the kernel is compared with its
// plain version at the CNN bar.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kOuts = 8;    // output channels of a 1x1 unit
constexpr int kGroups = 4;  // 32-pixel groups of a 1x1 unit, at most

// The packed row as ops/blaze_block.py `layout` lays it out, in floats:
// the 1x1 weights [C_in][cp] input-major (cp: C_out rounded up to 8, zeros
// beyond C_out), its bias [cp], the slopes [cp], the taps [C_in][9], the
// depthwise bias [C_in], zeros to a multiple of 4.
struct Layout {
  int cp, bpw, alpha, taps, bdw, floats;

  __host__ __device__ Layout(int cin, int cout) {
    cp = (cout + 7) / 8 * 8;
    bpw = cin * cp;
    alpha = bpw + cp;
    taps = alpha + cp;
    bdw = taps + 9 * cin;
    floats = (bdw + cin + 3) / 4 * 4;
  }
};

struct Args {
  const float* x;       // [B, cin, H, W]
  const float* params;  // the packed row, 16-byte aligned
  float* out;           // [B, cout, Ho, Wo]
  int B, cin, cout, H, W, Ho, Wo, stride, pt, pl, relu, tile_h, images;
  int rows;  // input rows a band holds in shared memory: H for whole images
};

// floor(n / d) for 0 <= n < 2^22, given inv = 1.0f / d (d >= 1): exact,
// because (n + 0.5) / d lies at least 0.5 / d from an integer, and the two
// roundings (of inv and of the product) move it by less than
// (n + 0.5) / d * 2^-23 < 0.5 / d.
__device__ __forceinline__ int div_small(int n, float inv) {
  return __float2int_rz((static_cast<float>(n) + 0.5f) * inv);
}

// The thread block's band: images b0 .. b0 + ni - 1, output rows oy0 ..
// oy0 + th - 1 of each, n pixels in all; shared-memory row k of a channel
// holds input row rbase + k.
struct Band {
  int b0, ni, oy0, th, n, rbase;
  bool whole;
  float inv_img, inv_wo;

  __device__ explicit Band(const Args& a) {
    b0 = blockIdx.x * a.images;
    ni = min(a.images, a.B - b0);
    oy0 = blockIdx.y * a.tile_h;
    th = min(a.tile_h, a.Ho - oy0);
    n = ni * th * a.Wo;
    whole = a.tile_h >= a.Ho;
    rbase = whole ? 0 : oy0 * a.stride - a.pt;
    inv_img = 1.0f / (th * a.Wo);
    inv_wo = 1.0f / a.Wo;
  }

  // Pixel p of the band: image i, output row oy, column ox.
  __device__ __forceinline__ void at(int p, const Args& a, int& i, int& oy, int& ox) const {
    i = div_small(p, inv_img);
    const int rem = p - i * th * a.Wo;
    const int r = div_small(rem, inv_wo);
    ox = rem - r * a.Wo;
    oy = oy0 + r;
  }
};

// Starts the asynchronous copies of the band's input rows into xs
// ([ni][cin][rows][W]), one commit group.
__device__ __forceinline__ void load_band(const Args& a, const Band& b, float* xs) {
  const size_t plane = static_cast<size_t>(a.H) * a.W;
  const int rs = a.rows * a.W;
  if (b.whole) {
    // ni whole images: one run of ni * cin * H * W floats.
    const float* src = a.x + static_cast<size_t>(b.b0) * a.cin * plane;
    const int n = b.ni * a.cin * rs;
    if ((a.cin * rs) % 4 == 0) {
      for (int e = threadIdx.x; e < n / 4; e += kThreads) __pipeline_memcpy_async(xs + 4 * e, src + 4 * e, 16);
    } else {
      for (int e = threadIdx.x; e < n; e += kThreads) __pipeline_memcpy_async(xs + e, src + e, 4);
    }
  } else {
    // Rows ry0 .. ry1 - 1 of each (image, channel): one run each.
    const int ry0 = max(0, b.rbase), ry1 = min(a.H, b.rbase + a.rows);
    const int len = (ry1 - ry0) * a.W, runs = b.ni * a.cin;
    const float* src = a.x + static_cast<size_t>(b.b0) * a.cin * plane + static_cast<size_t>(ry0) * a.W;
    float* dst = xs + (ry0 - b.rbase) * a.W;
    if (a.W % 4 == 0) {
      const int l4 = len / 4;
      const float inv = 1.0f / l4;
      for (int e = threadIdx.x; e < runs * l4; e += kThreads) {
        const int ic = div_small(e, inv), k = 4 * (e - ic * l4);
        __pipeline_memcpy_async(dst + ic * rs + k, src + ic * plane + k, 16);
      }
    } else {
      const float inv = 1.0f / len;
      for (int e = threadIdx.x; e < runs * len; e += kThreads) {
        const int ic = div_small(e, inv), k = e - ic * len;
        __pipeline_memcpy_async(dst + ic * rs + k, src + ic * plane + k, 4);
      }
    }
  }
  __pipeline_commit();
}

// max of the 2x2 window, NaN-propagating as the max pool is.
__device__ __forceinline__ float max2(float u, float v) { return (u != u || u > v) ? u : v; }

// One unit of the 1x1: outputs [8og, 8og+8) of the K pixel groups from g0
// (lane l: pixel 32*(g0+k) + l), then bias, residual and activation, stored.
template <int K>
__device__ __forceinline__ void pw_unit(const Args& a, const Layout& L, const Band& b, const float* wp,
                                        const float* xs, const float* ds, int og, int g0) {
  const int lane = threadIdx.x & 31;
  int p[K];
#pragma unroll
  for (int k = 0; k < K; ++k) p[k] = min((g0 + k) * 32 + lane, b.n - 1);
  float acc[K][kOuts];
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int j = 0; j < kOuts; ++j) acc[k][j] = 0.0f;
  }
  const float* w = wp + og * kOuts;
#pragma unroll 4
  for (int ci = 0; ci < a.cin; ++ci) {
    const float4 w0 = *reinterpret_cast<const float4*>(w + ci * L.cp);
    const float4 w1 = *reinterpret_cast<const float4*>(w + ci * L.cp + 4);
    const float* dc = ds + ci * b.n;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float v = dc[p[k]];
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
  const float4 b0 = *reinterpret_cast<const float4*>(wp + L.bpw + og * kOuts);
  const float4 b1 = *reinterpret_cast<const float4*>(wp + L.bpw + og * kOuts + 4);
  const float4 a0 = *reinterpret_cast<const float4*>(wp + L.alpha + og * kOuts);
  const float4 a1 = *reinterpret_cast<const float4*>(wp + L.alpha + og * kOuts + 4);
  const float bias[kOuts] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
  const float slope[kOuts] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const int rs = a.rows * a.W;
  const size_t oplane = static_cast<size_t>(a.Ho) * a.Wo;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if ((g0 + k) * 32 + lane >= b.n) continue;
    int i, oy, ox;
    b.at(p[k], a, i, oy, ox);
    // The residual's first input in shared memory: x[oy][ox], or the 2x2
    // window's top left at stride 2.
    const float* xr = xs + i * a.cin * rs + (oy * a.stride - b.rbase) * a.W + ox * a.stride;
    float* o = a.out + static_cast<size_t>(b.b0 + i) * a.cout * oplane + static_cast<size_t>(oy) * a.Wo + ox;
#pragma unroll
    for (int j = 0; j < kOuts; ++j) {
      const int co = og * kOuts + j;
      if (co >= a.cout) break;
      float v = acc[k][j] + bias[j];
      if (co < a.cin) {
        const float* xc = xr + co * rs;
        v += a.stride == 1 ? xc[0] : max2(max2(xc[0], xc[1]), max2(xc[a.W], xc[a.W + 1]));
      }
      if (v < 0.0f) v = a.relu ? 0.0f : slope[j] * v;
      o[co * oplane] = v;
    }
  }
}

// Three thread blocks an SM (at most 80 registers a thread): on the card
// this ran the face models' blocks 5% faster than two (95 registers, no
// spills), the phases of one thread block overlapping those of the others.
__global__ void __launch_bounds__(kThreads, 3) blaze_block_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  const Layout L(a.cin, a.cout);
  const Band b(a);
  float* wp = reinterpret_cast<float*>(smem4);  // the packed row
  float* xs = wp + L.floats;                    // [ni][cin][rows][W] the band's input rows
  float* ds = xs + b.ni * a.cin * a.rows * a.W;  // [cin][n] the depthwise's outputs

  // 1. The packed row and the input rows, copied asynchronously.
  for (int e = threadIdx.x; e < L.floats / 4; e += kThreads) {
    __pipeline_memcpy_async(smem4 + e, reinterpret_cast<const float4*>(a.params) + e, 16);
  }
  load_band(a, b, xs);
  __pipeline_wait_prior(0);
  __syncthreads();

  // 2. The depthwise. A thread takes one band pixel (lanes along a row) and
  //    every `groups`-th channel from its own, so that a pixel's place and
  //    which of its taps lie inside the image are worked out once.
  {
    const int rs = a.rows * a.W;
    const int span = min(b.n, kThreads), groups = kThreads / span, first = threadIdx.x / span;
    for (int p = threadIdx.x - first * span; first < groups && p < b.n; p += span) {
      int i, oy, ox;
      b.at(p, a, i, oy, ox);
      const int iy0 = oy * a.stride - a.pt, ix0 = ox * a.stride - a.pl;
      bool row_in[3], col_in[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        row_in[k] = iy0 + k >= 0 && iy0 + k < a.H;
        col_in[k] = ix0 + k >= 0 && ix0 + k < a.W;
      }
      // The tap window's top left in shared memory (it may lie outside
      // the image: the masks keep those taps out).
      const float* x0 = xs + i * a.cin * rs + (iy0 - b.rbase) * a.W + ix0;
      for (int c = first; c < a.cin; c += groups) {
        const float* tap = wp + L.taps + c * 9;
        const float* xc = x0 + c * rs;
        float acc = wp[L.bdw + c];
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          if (!row_in[ky]) continue;
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            if (col_in[kx]) acc += tap[ky * 3 + kx] * xc[ky * a.W + kx];
          }
        }
        ds[c * b.n + p] = acc;
      }
    }
  }
  __syncthreads();

  // 3. The 1x1, residual and activation: units of 8 outputs by 1-4 pixel
  //    groups, fewer groups a unit where the output groups are fewer than
  //    the warps, so every warp has work.
  {
    const int nog = L.cp / kOuts, groups = (b.n + 31) >> 5;
    const int split = (kWarps + nog - 1) / nog;
    const int per = nog >= kWarps ? kGroups : min(kGroups, max(1, (groups + split - 1) / split));
    const int chunks = (groups + per - 1) / per;
    for (int u = threadIdx.x >> 5; u < nog * chunks; u += kWarps) {
      const int chunk = u / nog, og = u - chunk * nog, g0 = chunk * per;
      switch (min(per, groups - g0)) {
        case 4: pw_unit<4>(a, L, b, wp, xs, ds, og, g0); break;
        case 3: pw_unit<3>(a, L, b, wp, xs, ds, og, g0); break;
        case 2: pw_unit<2>(a, L, b, wp, xs, ds, og, g0); break;
        default: pw_unit<1>(a, L, b, wp, xs, ds, og, g0); break;
      }
    }
  }
}

}  // namespace

// One block on `stream`; allocates nothing and does not synchronise.
// `params` is the packed row (ops/blaze_block.py `pack_blaze_block`), 16-byte
// aligned; `tile_h` and `images` as ops/blaze_block.py `tiling` gives them;
// `smem_bytes` its `_smem_bytes`. Returns the CUDA error code (0 when the
// launch was accepted); cudaErrorInvalidValue for a stride other than 1 or 2
// or C_out < C_in.
extern "C" int zaru_blaze_block(const void* x, const void* params, void* out, int batch, int cin, int cout, int H,
                                int W, int Ho, int Wo, int stride, int pt, int pl, int relu, int tile_h, int images,
                                int smem_bytes, void* stream) {
  if ((stride != 1 && stride != 2) || cout < cin || tile_h < 1 || images < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const float*>(x), static_cast<const float*>(params), static_cast<float*>(out),
               batch, cin, cout, H, W, Ho, Wo, stride, pt, pl, relu, tile_h, images,
               tile_h >= Ho ? H : (tile_h - 1) * stride + 3};
  cudaError_t err = cudaFuncSetAttribute(blaze_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((batch + images - 1) / images, (Ho + tile_h - 1) / tile_h);
  blaze_block_kernel<<<grid, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
