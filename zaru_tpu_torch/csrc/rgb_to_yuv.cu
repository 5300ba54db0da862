// BT.601 full-range RGB -> YUV on interleaved f32 pixels, for Hopper (sm_90a).
//
// Replaces the TPU kernel of zaru_tpu/ops/pallas_kernels.py
// `rgb_to_yuv_pallas` (:154, inner `kernel` :166, launched at :174): for
// every pixel of an [H,W,3] f32 image, three 3-term sums with the constant
// matrix `_YUV_FROM_RGB` (:131), U and V centred on 0. The Pallas kernel works
// on a planar [3,H,W] copy so that the TPU's 128-lane axis carries the image
// width; that transpose is a TPU layout mechanism and is not carried over:
// this kernel reads and writes the interleaved layout directly.
//
// Numbers: each sum is formed in the kernel body's order,
// (m[i][0]*r + m[i][1]*g) + m[i][2]*b, every product and sum rounded on its
// own (explicit _rn intrinsics; the file is built with --fmad=false), so the
// result is bit-equal to the plain PyTorch version
// (zaru_tpu_torch/ops/yuv.py `rgb_to_yuv_fast_reference`).
//
// Bound: bytes. Each pixel reads 12 bytes and writes 12 and takes 15
// operations, so a 1920x1080 image moves 49.8 MB, about 0.0149 ms at
// 3.35 TB/s. Each thread converts 4 pixels, 48 bytes, as three 16-byte
// loads and three 16-byte stores, so a warp moves 1536 contiguous bytes each
// way; the last n % 4 pixels are converted one by one by one thread.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

struct Matrix {
  float m[9];  // row-major, row i gives output channel i
};

__device__ __forceinline__ float row_sum(const Matrix& k, int i, float r, float g, float b) {
  return __fadd_rn(__fadd_rn(__fmul_rn(k.m[3 * i], r), __fmul_rn(k.m[3 * i + 1], g)),
                   __fmul_rn(k.m[3 * i + 2], b));
}

__device__ __forceinline__ void convert(const Matrix& k, const float* p, float* q) {
  const float r = p[0], g = p[1], b = p[2];
  q[0] = row_sum(k, 0, r, g, b);
  q[1] = row_sum(k, 1, r, g, b);
  q[2] = row_sum(k, 2, r, g, b);
}

__global__ void rgb_to_yuv_kernel(const float4* __restrict__ in, float4* __restrict__ out,
                                  long long n_pixels, Matrix k) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long quads = n_pixels / 4;
  if (t < quads) {
    float4 v[3] = {__ldg(in + 3 * t), __ldg(in + 3 * t + 1), __ldg(in + 3 * t + 2)};
    float4 w[3];
    const float* p = reinterpret_cast<const float*>(v);
    float* q = reinterpret_cast<float*>(w);
#pragma unroll
    for (int i = 0; i < 4; ++i) convert(k, p + 3 * i, q + 3 * i);
    out[3 * t] = w[0];
    out[3 * t + 1] = w[1];
    out[3 * t + 2] = w[2];
  } else if (t == quads) {
    const float* p = reinterpret_cast<const float*>(in);
    float* q = reinterpret_cast<float*>(out);
    for (long long i = 4 * quads; i < n_pixels; ++i) convert(k, p + 3 * i, q + 3 * i);
  }
}

}  // namespace

// Converts `n_pixels` interleaved RGB pixels at `in` into `out` (both
// 16-byte aligned) with the row-major 3x3 matrix `m`. Launches on `stream`;
// allocates nothing and does not synchronise. Returns cudaGetLastError() (0
// when the launch was accepted).
extern "C" int zaru_rgb_to_yuv(const void* in, void* out, long long n_pixels, const float* m,
                               void* stream) {
  Matrix k;
  for (int i = 0; i < 9; ++i) k.m[i] = m[i];
  const int threads = 256;
  const long long items = n_pixels / 4 + 1;  // the quads, then one thread for the tail
  const unsigned blocks = (unsigned)((items + threads - 1) / threads);
  rgb_to_yuv_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(in), static_cast<float4*>(out), n_pixels, k);
  return static_cast<int>(cudaGetLastError());
}
