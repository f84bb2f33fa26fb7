// Shared device building blocks for the port's Hopper kernels.
//
// - Epilogue: the epilogues of the products (wgmma_gemm.cuh, and
//   cls_pool.cu's skinny product): bias; bias + erf-GELU; bias + the
//   polynomial GELU; bias, rounded to bf16, then added to a residual row
//   (rounded once more), which is the `res + (acc + b).astype(bf16)` of the
//   JAX kernels.
// - gelu_erf, gelu_poly: the exact erf-GELU of K2 and the TPU kernels'
//   clamped polynomial erf-GELU of K8b, in f32.
// - ln_rows: the LayerNorm prologue as its own pass (f32 statistics in the
//   fast-variance form max(E[x^2] - E[x]^2, 0), f32 affine, bf16 out), either
//   from the row itself or from precomputed [mean, meansq] row statistics:
//   the A operand of every LayerNorm-fed product (K2, K4's and K4b's LN2,
//   K8a-K8c).
// - row_stats: f32 [mean, meansq, 0 x 6] of bf16 rows, the layout the
//   slab LN+MLP kernel of the JAX package emits.
// - dot_row_bf16: an f32 vector against a bf16 row of device memory, with
//   16-byte loads.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace sft {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float gelu_erf(float x) {
  return x * 0.5f * (1.0f + erff(x * 0.70710678118654752f));
}

// erf(z) ~= z * P9(z^2) on |z| <= 3 (synchformer_tpu/ops/pallas/fused_block.py
// :79-101, |err| <= 3e-5), Horner in f32.
__device__ __forceinline__ float gelu_poly(float x) {
  const float z = fminf(fmaxf(x * 0.70710678118654752f, -3.f), 3.f);
  const float u = z * z;
  float p = -4.884558793996662e-09f;
  p = p * u + 2.462992635407088e-07f;
  p = p * u + -5.581884377842221e-06f;
  p = p * u + 7.619287512854014e-05f;
  p = p * u + -0.0007122925277970079f;
  p = p * u + 0.004930427932570047f;
  p = p * u + -0.026508097122118452f;
  p = p * u + 0.11261191593609451f;
  p = p * u + -0.37607043470191825f;
  p = p * u + 1.1283768672322625f;
  return x * 0.5f * (1.f + z * p);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// <a, row> over the first n <= N values (n % 8 == 0, N % 8 == 0): a f32
// (shared memory), row bf16 in device memory, 16-byte aligned; nothing past
// value n is read. Every 16-byte load is started before the sums, which run
// in element order: a thread walking rows of its own is bound by load
// latency, not by the arithmetic.
template <int N>
__device__ __forceinline__ float dot_row_bf16(const float* __restrict__ a,
                                              const bf16* __restrict__ row, int n = N) {
  static_assert(N % 8 == 0, "dot_row_bf16 takes whole 16-byte chunks");
  uint4 w[N / 8];
#pragma unroll
  for (int c = 0; c < N / 8; ++c)
    w[c] = 8 * c < n ? __ldg(reinterpret_cast<const uint4*>(row) + c) : make_uint4(0u, 0u, 0u, 0u);
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < N / 8; ++c) {
    if (8 * c >= n) continue;
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&w[c]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 v = __bfloat1622float2(p[e]);
      s += a[8 * c + 2 * e] * v.x + a[8 * c + 2 * e + 1] * v.y;
    }
  }
  return s;
}

enum Epilogue { EPI_BIAS = 0, EPI_BIAS_GELU = 1, EPI_BIAS_RESIDUAL = 2, EPI_BIAS_GELU_POLY = 3 };

// One warp per row. stats (rows, 8) f32 [mean, meansq, ...] when given.
__global__ void ln_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ stats,
                               const float* __restrict__ g, const float* __restrict__ b,
                               bf16* __restrict__ y, int64_t rows, int D, float eps) {
  const int lane = threadIdx.x % 32;
  const int64_t row = (int64_t)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const bf16* xr = x + row * D;
  float mean, msq;
  if (stats != nullptr) {
    mean = stats[row * 8 + 0];
    msq = stats[row * 8 + 1];
  } else {
    float s = 0.f, s2 = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float v = __bfloat162float(xr[d]);
      s += v;
      s2 += v * v;
    }
    mean = warp_sum(s) / D;
    msq = warp_sum(s2) / D;
  }
  const float rstd = rsqrtf(fmaxf(msq - mean * mean, 0.f) + eps);
  bf16* yr = y + row * D;
  for (int d = lane; d < D; d += 32)
    yr[d] = __float2bfloat16((__bfloat162float(xr[d]) - mean) * rstd * g[d] + b[d]);
}

inline void ln_rows(const bf16* x, const float* stats, const float* g, const float* b,
                    bf16* y, int64_t rows, int D, float eps, cudaStream_t s) {
  const int warps = 8;
  ln_rows_kernel<<<(unsigned)((rows + warps - 1) / warps), warps * 32, 0, s>>>(
      x, stats, g, b, y, rows, D, eps);
}

__global__ void row_stats_kernel(const bf16* __restrict__ x, float* __restrict__ stats,
                                 int64_t rows, int D) {
  const int lane = threadIdx.x % 32;
  const int64_t row = (int64_t)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  float s = 0.f, s2 = 0.f;
  for (int d = lane; d < D; d += 32) {
    const float v = __bfloat162float(x[row * D + d]);
    s += v;
    s2 += v * v;
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  if (lane < 8) stats[row * 8 + lane] = lane == 0 ? s / D : (lane == 1 ? s2 / D : 0.f);
}

inline void row_stats(const bf16* x, float* stats, int64_t rows, int D, cudaStream_t s) {
  const int warps = 8;
  row_stats_kernel<<<(unsigned)((rows + warps - 1) / warps), warps * 32, 0, s>>>(
      x, stats, rows, D);
}

}  // namespace sft

#define SFT_CHECK_LAUNCH()                        \
  do {                                            \
    cudaError_t e_ = cudaGetLastError();          \
    if (e_ != cudaSuccess) return (int)e_;        \
  } while (0)
