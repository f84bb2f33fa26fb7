// K4: one pre-LN encoder layer for a shared CLS row over (B, M, D) tokens:
// LN1 -> q from CLS, K/V over [CLS; tokens] -> 1-query attention -> proj ->
// residual -> LN2 -> MLP -> residual. Output (B, D).
//
// Replaces synchformer_tpu/ops/pallas/cls_pool.py::_cls_pool_tokens_pallas
// (body _cls_pool_tokens_kernel).
//
// With a single query, the (M, 2D) K/V projection is not needed:
//   logit_h[j] = LN(x_j) . (Wk_h^T q_h) + bk_h . q_h
//   out_h      = (sum_j p_hj LN(x_j)) Wv_h^T + (sum_j p_hj) bv_h + p_h,cls v_cls,h
// so the per-group work is one pass for the LN statistics, one for the
// logits against U = Wk_h^T q_h (H x D, shared by every group), one for the
// p-weighted sum of LN(x), and one (D x D) matrix-vector product with Wv.
// K and V are never formed, so their bf16 rounding in the reference is
// skipped; the tests' bf16 tolerance allows for that.
//
// Launches: (1) prep, one block: LN1(CLS), q, k_cls, v_cls, U, bk.q and the
// CLS logit; (2) pool, one block per group (896 spatial, 672 frequency at the
// main path's B=8, S=14), writing the bf16 attention row to device memory;
// (3) proj + CLS residual, LN2, fc1 + GELU, fc2 + residual on the tile GEMM
// with the groups as rows. The TPU kernel keeps all of it in VMEM; here the
// (B, D) and (B, 4D) intermediates pass through device memory (a few MB).
// Bound: the pool pass reads x once (270 MB for the spatial aggregator) plus
// Wv from L2 per group; the GEMMs are small.
#include "tile_gemm.cuh"

using sft::bf16;

namespace {

constexpr int THREADS = 256;
constexpr int MAXH = 16;

// work layout (f32): q[D] kc[D] vc[D] U[H*D] cq[H] lc[H]
__global__ void __launch_bounds__(THREADS)
cls_prep_kernel(const bf16* __restrict__ cls, const float* __restrict__ g1,
                const float* __restrict__ b1, const bf16* __restrict__ wqkv,
                const float* __restrict__ bqkv, float* __restrict__ work, int D, int H,
                float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ln = reinterpret_cast<float*>(smem);  // D
  float* q = ln + D;                           // D
  float* kc = q + D;                           // D
  float* red = kc + D;                         // 64
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int dh = D / H;

  float s = 0.f, s2 = 0.f;
  for (int d = tid; d < D; d += THREADS) {
    const float v = __bfloat162float(cls[d]);
    s += v;
    s2 += v * v;
  }
  s = sft::warp_sum(s);
  s2 = sft::warp_sum(s2);
  if (lane == 0) {
    red[warp] = s;
    red[32 + warp] = s2;
  }
  __syncthreads();
  s = 0.f;
  s2 = 0.f;
  for (int w = 0; w < THREADS / 32; ++w) {
    s += red[w];
    s2 += red[32 + w];
  }
  const float mean = s / D;
  const float rstd = rsqrtf(fmaxf(s2 / D - mean * mean, 0.f) + eps);
  for (int d = tid; d < D; d += THREADS)
    ln[d] = sft::bf16r((__bfloat162float(cls[d]) - mean) * rstd * g1[d] + b1[d]);
  __syncthreads();

  // q, k_cls, v_cls: one warp per output row of Wqkv
  for (int e = warp; e < 3 * D; e += THREADS / 32) {
    const bf16* wr = wqkv + (int64_t)e * D;
    float a = 0.f;
    for (int d = lane; d < D; d += 32) a += ln[d] * __bfloat162float(wr[d]);
    a = sft::warp_sum(a);
    if (lane == 0) {
      const float v = sft::bf16r(a + bqkv[e]);
      if (e < D) q[e] = v;
      else if (e < 2 * D) kc[e - D] = v;
      work[e] = v;
    }
  }
  __syncthreads();

  // U[h][d] = sum_{e in head h} q[e] Wk[e][d]
  for (int idx = tid; idx < H * D; idx += THREADS) {
    const int h = idx / D, d = idx % D;
    float a = 0.f;
    for (int e = h * dh; e < (h + 1) * dh; ++e)
      a += q[e] * __bfloat162float(wqkv[(int64_t)(D + e) * D + d]);
    work[3 * D + idx] = a;
  }
  if (tid < H) {
    float cq = 0.f, lc = 0.f;
    for (int e = tid * dh; e < (tid + 1) * dh; ++e) {
      cq += q[e] * bqkv[D + e];
      lc += q[e] * kc[e];
    }
    work[3 * D + H * D + tid] = cq;
    work[3 * D + H * D + H + tid] = lc;
  }
}

__global__ void __launch_bounds__(THREADS)
cls_pool_kernel(const bf16* __restrict__ x, const float* __restrict__ g1,
                const float* __restrict__ b1, const bf16* __restrict__ wqkv,
                const float* __restrict__ bqkv, const float* __restrict__ work,
                bf16* __restrict__ att, int M, int D, int H, float eps, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* U = reinterpret_cast<float*>(smem);  // H*D
  float* z = U + H * D;                       // H*D
  float* p = z + H * D;                       // H*(M+1)
  float* mean_s = p + H * (M + 1);            // M
  float* rstd_s = mean_s + M;                 // M
  float* ptok = rstd_s + M;                   // H
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int nw = THREADS / 32;
  const int dh = D / H;
  const int b = blockIdx.x;
  const bf16* xb = x + (int64_t)b * M * D;
  const float* vc = work + 2 * D;
  const float* cq = work + 3 * D + H * D;
  const float* lc = cq + H;

  for (int i = tid; i < H * D; i += THREADS) U[i] = work[3 * D + i];
  for (int j = warp; j < M; j += nw) {
    float s = 0.f, s2 = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float v = __bfloat162float(xb[(int64_t)j * D + d]);
      s += v;
      s2 += v * v;
    }
    s = sft::warp_sum(s);
    s2 = sft::warp_sum(s2);
    if (lane == 0) {
      const float mu = s / D;
      mean_s[j] = mu;
      rstd_s[j] = rsqrtf(fmaxf(s2 / D - mu * mu, 0.f) + eps);
    }
  }
  __syncthreads();

  // logits: one warp per token row, all heads at once
  for (int j = warp; j < M; j += nw) {
    float acc[MAXH];
#pragma unroll
    for (int h = 0; h < MAXH; ++h) acc[h] = 0.f;
    const float mu = mean_s[j], rs = rstd_s[j];
    for (int d = lane; d < D; d += 32) {
      const float lv = sft::bf16r((__bfloat162float(xb[(int64_t)j * D + d]) - mu) * rs * g1[d] + b1[d]);
#pragma unroll
      for (int h = 0; h < MAXH; ++h)
        if (h < H) acc[h] += lv * U[h * D + d];
    }
#pragma unroll
    for (int h = 0; h < MAXH; ++h) {
      if (h < H) {
        const float v = sft::warp_sum(acc[h]);
        if (lane == 0) p[h * (M + 1) + 1 + j] = (v + cq[h]) * scale;
      }
    }
  }
  if (tid < H) p[tid * (M + 1)] = lc[tid] * scale;
  __syncthreads();

  // softmax over [CLS; tokens], one warp per head; probabilities in bf16
  for (int h = warp; h < H; h += nw) {
    float* ph = p + h * (M + 1);
    float m = -INFINITY;
    for (int j = lane; j <= M; j += 32) m = fmaxf(m, ph[j]);
    m = sft::warp_max(m);
    float s = 0.f;
    for (int j = lane; j <= M; j += 32) {
      const float e = __expf(ph[j] - m);
      ph[j] = e;
      s += e;
    }
    s = sft::warp_sum(s);
    const float inv = 1.f / s;
    float st = 0.f;
    for (int j = lane; j <= M; j += 32) {
      const float pr = sft::bf16r(ph[j] * inv);
      ph[j] = pr;
      if (j > 0) st += pr;
    }
    st = sft::warp_sum(st);
    if (lane == 0) ptok[h] = st;
  }
  __syncthreads();

  // z[h][d] = sum_j p[h][1+j] LN(x_j)[d]
  for (int d = tid; d < D; d += THREADS) {
    float acc[MAXH];
#pragma unroll
    for (int h = 0; h < MAXH; ++h) acc[h] = 0.f;
    const float gd = g1[d], bd = b1[d];
    for (int j = 0; j < M; ++j) {
      const float lv = sft::bf16r((__bfloat162float(xb[(int64_t)j * D + d]) - mean_s[j]) * rstd_s[j] * gd + bd);
#pragma unroll
      for (int h = 0; h < MAXH; ++h)
        if (h < H) acc[h] += p[h * (M + 1) + 1 + j] * lv;
    }
#pragma unroll
    for (int h = 0; h < MAXH; ++h)
      if (h < H) z[h * D + d] = acc[h];
  }
  __syncthreads();

  // att[e] = z[h(e)] . Wv[e] + ptok[h] bv[e] + p_cls[h] vc[e]; one warp per e
  for (int e = warp; e < D; e += nw) {
    const int h = e / dh;
    const bf16* wr = wqkv + (int64_t)(2 * D + e) * D;
    float a = 0.f;
    for (int d = lane; d < D; d += 32) a += z[h * D + d] * __bfloat162float(wr[d]);
    a = sft::warp_sum(a);
    if (lane == 0)
      att[(int64_t)b * D + e] = __float2bfloat16(
          a + ptok[h] * bqkv[2 * D + e] + p[h * (M + 1)] * vc[e]);
  }
}

}  // namespace

extern "C" int sft_cls_pool_tokens(const void* x, const void* cls, const void* g1,
                                   const void* b1, const void* wqkv, const void* bqkv,
                                   const void* wp, const void* bp, const void* g2,
                                   const void* b2, const void* w1, const void* fb1,
                                   const void* w2, const void* fb2, void* work, void* att,
                                   void* y, void* ln2, void* hbuf, void* out, int B, int M,
                                   int D, int H, int hidden, float eps, void* stream) {
  if (H > MAXH || D % H != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float scale = 1.0f / sqrtf((float)(D / H));
  const size_t smem_prep = (3 * (size_t)D + 64) * sizeof(float);
  cudaFuncSetAttribute(cls_prep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_prep);
  SFT_CHECK_LAUNCH();
  cls_prep_kernel<<<1, THREADS, smem_prep, s>>>(
      static_cast<const bf16*>(cls), static_cast<const float*>(g1),
      static_cast<const float*>(b1), static_cast<const bf16*>(wqkv),
      static_cast<const float*>(bqkv), static_cast<float*>(work), D, H, eps);
  SFT_CHECK_LAUNCH();
  const size_t smem_pool =
      (2 * (size_t)H * D + (size_t)H * (M + 1) + 2 * (size_t)M + H) * sizeof(float);
  cudaFuncSetAttribute(cls_pool_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_pool);
  SFT_CHECK_LAUNCH();
  cls_pool_kernel<<<B, THREADS, smem_pool, s>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(g1),
      static_cast<const float*>(b1), static_cast<const bf16*>(wqkv),
      static_cast<const float*>(bqkv), static_cast<const float*>(work),
      static_cast<bf16*>(att), M, D, H, eps, scale);
  SFT_CHECK_LAUNCH();
  bf16* yb = static_cast<bf16*>(y);
  sft::gemm_bf16<sft::EPI_BIAS_RESIDUAL>(static_cast<const bf16*>(att),
                                         static_cast<const bf16*>(wp),
                                         static_cast<const float*>(bp),
                                         static_cast<const bf16*>(cls), 0, yb, B, D, D, s);
  SFT_CHECK_LAUNCH();
  sft::ln_rows(yb, nullptr, static_cast<const float*>(g2), static_cast<const float*>(b2),
               static_cast<bf16*>(ln2), B, D, eps, s);
  SFT_CHECK_LAUNCH();
  sft::gemm_bf16<sft::EPI_BIAS_GELU>(static_cast<const bf16*>(ln2),
                                     static_cast<const bf16*>(w1),
                                     static_cast<const float*>(fb1), nullptr, 0,
                                     static_cast<bf16*>(hbuf), B, hidden, D, s);
  SFT_CHECK_LAUNCH();
  sft::gemm_bf16<sft::EPI_BIAS_RESIDUAL>(static_cast<const bf16*>(hbuf),
                                         static_cast<const bf16*>(w2),
                                         static_cast<const float*>(fb2), yb, D,
                                         static_cast<bf16*>(out), B, D, hidden, s);
  SFT_CHECK_LAUNCH();
  return 0;
}
