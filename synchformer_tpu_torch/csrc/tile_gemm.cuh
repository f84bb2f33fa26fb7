// Shared device building blocks for the port's Hopper kernels.
//
// - gemm_bf16: C[M,N] = epilogue(A[M,K] @ W[N,K]^T + bias), bf16 operands,
//   fp32 accumulation on the tensor cores through WMMA (16x16x16 tiles).
//   W is a torch Linear weight (out, in), row-major, so its rows are the
//   columns of the product. Epilogues: bias; bias + erf-GELU; bias, rounded
//   to bf16, then added to a residual row (rounded once more), which is the
//   `res + (acc + b).astype(bf16)` of the JAX kernels.
// - gemm_ln_bf16: the same product with the LayerNorm of A applied while its
//   tile is staged in shared memory (per-row [mean, rstd] from ln_stats, f32
//   affine, rounded to bf16), so the normalised rows never reach device
//   memory: the LN + matmul of K8c and of K8a's prologue.
// - ln_rows: the LayerNorm prologue as its own pass (f32 statistics in the
//   fast-variance form max(E[x^2] - E[x]^2, 0), f32 affine, bf16 out), either
//   from the row itself or from precomputed [mean, meansq] row statistics.
// - row_stats: f32 [mean, meansq, 0 x 6] of bf16 rows, the layout the
//   slab LN+MLP kernel of the JAX package emits; ln_stats: f32 [mean, rstd]
//   of bf16 rows, for gemm_ln_bf16.
// - dot_row_bf16: an f32 vector against a bf16 row of device memory, with
//   16-byte loads.
//
// The tile GEMM is the simple form: one 64x64 output tile per block, four
// warps of 32x32, a 32-deep K step staged through shared memory without
// pipelining. It stays under K4, K4b, K8a and K8c; K1 and K2 run on the
// Hopper GEMM of wgmma_gemm.cuh (TMA, wgmma, warp specialisation), whose
// epilogues round as these do.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace sft {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float gelu_erf(float x) {
  return x * 0.5f * (1.0f + erff(x * 0.70710678118654752f));
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

// <a, row> over N values (N % 8 == 0): a f32 (shared memory), row bf16 in
// device memory, 16-byte aligned. Every 16-byte load is started before the
// sums, which run in element order: a thread walking rows of its own is bound
// by load latency, not by the arithmetic.
template <int N>
__device__ __forceinline__ float dot_row_bf16(const float* __restrict__ a,
                                              const bf16* __restrict__ row) {
  static_assert(N % 8 == 0, "dot_row_bf16 takes whole 16-byte chunks");
  uint4 w[N / 8];
#pragma unroll
  for (int c = 0; c < N / 8; ++c) w[c] = __ldg(reinterpret_cast<const uint4*>(row) + c);
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < N / 8; ++c) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&w[c]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 v = __bfloat1622float2(p[e]);
      s += a[8 * c + 2 * e] * v.x + a[8 * c + 2 * e + 1] * v.y;
    }
  }
  return s;
}

enum Epilogue { EPI_BIAS = 0, EPI_BIAS_GELU = 1, EPI_BIAS_RESIDUAL = 2 };

constexpr int GEMM_BM = 64;
constexpr int GEMM_BN = 64;
constexpr int GEMM_BK = 32;
constexpr int GEMM_THREADS = 128;
constexpr int GEMM_LDS = GEMM_BK + 8;  // bf16 row pitch of the staged tiles
constexpr int GEMM_LDC = GEMM_BN + 4;  // f32 row pitch of the output tile

// The LayerNorm a GEMM applies to A's rows while it stages them: stats[r] =
// (mean, rstd) of row r in f32, g / b the f32 affine of the K columns.
struct LnPrologue {
  const float2* stats;
  const float* g;
  const float* b;
};

// 8 bf16 of row r, columns c..c+7: (x - mean) * rstd * g + b in f32, rounded
// to bf16 (flax LayerNorm numerics).
__device__ __forceinline__ uint4 ln_apply8(uint4 raw, float2 st, const float* __restrict__ g,
                                           const float* __restrict__ b) {
  const __nv_bfloat162* in = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float4 g0 = __ldg(reinterpret_cast<const float4*>(g));
  const float4 g1 = __ldg(reinterpret_cast<const float4*>(g) + 1);
  const float4 b0 = __ldg(reinterpret_cast<const float4*>(b));
  const float4 b1 = __ldg(reinterpret_cast<const float4*>(b) + 1);
  const float gs[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
  const float bs[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
  uint4 out;
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 v = __bfloat1622float2(in[e]);
    o[e] = __floats2bfloat162_rn((v.x - st.x) * st.y * gs[2 * e] + bs[2 * e],
                                 (v.y - st.x) * st.y * gs[2 * e + 1] + bs[2 * e + 1]);
  }
  return out;
}

// Requires N % 64 == 0, K % 32 == 0 and 16-byte aligned A and W rows; rows
// of A beyond M are masked. R (residual) has row stride r_stride elements;
// 0 broadcasts one row to every output row. With LN, A's rows are normalised
// by ln as they are staged (ln.g and ln.b 16-byte aligned).
template <int EPI, bool LN>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
                 const float* __restrict__ bias, const bf16* __restrict__ R,
                 int64_t r_stride, bf16* __restrict__ C, int M, int N, int K,
                 LnPrologue ln) {
  using namespace nvcuda;
  __shared__ __align__(32) bf16 As[GEMM_BM * GEMM_LDS];
  __shared__ __align__(32) bf16 Ws[GEMM_BN * GEMM_LDS];
  __shared__ __align__(32) float Cs[GEMM_BM * GEMM_LDC];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;
  const int64_t m0 = (int64_t)blockIdx.y * GEMM_BM;
  const int n0 = blockIdx.x * GEMM_BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += GEMM_BK) {
    // 64 rows x 32 cols = 256 vectors of 8 bf16 per operand; 2 per thread
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int idx = tid + v * GEMM_THREADS;
      const int r = idx / 4, c = (idx % 4) * 8;
      uint4 a = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < M) {
        a = *reinterpret_cast<const uint4*>(A + (m0 + r) * K + k0 + c);
        if constexpr (LN) a = ln_apply8(a, ln.stats[m0 + r], ln.g + k0 + c, ln.b + k0 + c);
      }
      *reinterpret_cast<uint4*>(As + r * GEMM_LDS + c) = a;
      *reinterpret_cast<uint4*>(Ws + r * GEMM_LDS + c) =
          *reinterpret_cast<const uint4*>(W + (int64_t)(n0 + r) * K + k0 + c);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GEMM_BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm * 32 + i * 16) * GEMM_LDS + kk, GEMM_LDS);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Ws + (wn * 32 + j * 16) * GEMM_LDS + kk, GEMM_LDS);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * GEMM_LDC + wn * 32 + j * 16,
                              acc[i][j], GEMM_LDC, wmma::mem_row_major);
  __syncthreads();

  for (int idx = tid; idx < GEMM_BM * GEMM_BN; idx += GEMM_THREADS) {
    const int r = idx / GEMM_BN, c = idx % GEMM_BN;
    const int64_t gm = m0 + r;
    if (gm >= M) continue;
    const int gn = n0 + c;
    float v = Cs[r * GEMM_LDC + c] + bias[gn];
    if (EPI == EPI_BIAS_GELU) v = gelu_erf(v);
    if (EPI == EPI_BIAS_RESIDUAL) v = __bfloat162float(R[gm * r_stride + gn]) + bf16r(v);
    C[gm * N + gn] = __float2bfloat16(v);
  }
}

template <int EPI>
inline void gemm_bf16(const bf16* A, const bf16* W, const float* bias, const bf16* R,
                      int64_t r_stride, bf16* C, int M, int N, int K, cudaStream_t s) {
  dim3 grid(N / GEMM_BN, (M + GEMM_BM - 1) / GEMM_BM);
  gemm_bf16_kernel<EPI, false><<<grid, GEMM_THREADS, 0, s>>>(A, W, bias, R, r_stride, C, M, N,
                                                             K, LnPrologue{});
}

// C = LN(A) @ W^T + bias, rounded once to bf16.
inline void gemm_ln_bf16(const bf16* A, const bf16* W, const float* bias, bf16* C, int M, int N,
                         int K, LnPrologue ln, cudaStream_t s) {
  dim3 grid(N / GEMM_BN, (M + GEMM_BM - 1) / GEMM_BM);
  gemm_bf16_kernel<EPI_BIAS, true><<<grid, GEMM_THREADS, 0, s>>>(A, W, bias, nullptr, 0, C, M,
                                                                 N, K, ln);
}

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

// One warp per row: (mean, rstd) with rstd = rsqrt(max(E[x^2] - E[x]^2, 0) +
// eps) in f32 (D even, rows 4-byte aligned).
__global__ void ln_stats_kernel(const bf16* __restrict__ x, float2* __restrict__ stats,
                                int64_t rows, int D, float eps) {
  const int lane = threadIdx.x % 32;
  const int64_t row = (int64_t)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const __nv_bfloat162* xr = reinterpret_cast<const __nv_bfloat162*>(x + row * D);
  float s = 0.f, s2 = 0.f;
  for (int d = lane; d < D / 2; d += 32) {
    const float2 v = __bfloat1622float2(xr[d]);
    s += v.x + v.y;
    s2 += v.x * v.x + v.y * v.y;
  }
  const float mean = warp_sum(s) / D;
  const float msq = warp_sum(s2) / D;
  if (lane == 0) stats[row] = make_float2(mean, rsqrtf(fmaxf(msq - mean * mean, 0.f) + eps));
}

inline void ln_stats(const bf16* x, float2* stats, int64_t rows, int D, float eps,
                     cudaStream_t s) {
  const int warps = 8;
  ln_stats_kernel<<<(unsigned)((rows + warps - 1) / warps), warps * 32, 0, s>>>(x, stats, rows,
                                                                               D, eps);
}

}  // namespace sft

#define SFT_CHECK_LAUNCH()                        \
  do {                                            \
    cudaError_t e_ = cudaGetLastError();          \
    if (e_ != cudaSuccess) return (int)e_;        \
  } while (0)
