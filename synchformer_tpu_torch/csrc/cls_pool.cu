// K4 and K4b: one pre-LN encoder layer for the CLS row only: LN1 -> q from
// the CLS row, K/V over every row -> 1-query attention -> proj -> residual on
// the CLS row -> LN2 -> MLP -> residual. Output (B, D).
//
// K4 (sft_cls_pool_tokens) replaces synchformer_tpu/ops/pallas/cls_pool.py::
// _cls_pool_tokens_pallas (body _cls_pool_tokens_kernel): (B, M, D) tokens
// and one CLS row shared by every group, attended as [CLS; tokens].
// K4b (sft_cls_pool) replaces cls_pool.py::_cls_pool_pallas (body
// _cls_pool_kernel): the CLS row is row 0 of each group's (N, D) x, so it
// differs per group (the global segment aggregator in training, where the
// positional dropout has touched it).
//
// With a single query, the (N, 2D) K/V projection is not needed:
//   logit_h[j] = LN(x_j) . (Wk_h^T q_h) + bk_h . q_h
//   out_h      = (sum_j p_hj LN(x_j)) Wv_h^T + (sum_j p_hj) bv_h
// so the per-group work is one pass for the LN statistics, one for the
// logits against U_h = Wk_h^T q_h (H x D), one for the p-weighted sum of
// LN(x), and one (D x D) matrix-vector product with Wv. K and V are never
// formed, so their bf16 rounding in the reference is skipped; the tests' bf16
// tolerance allows for that.
//
// K4 launches: (1) prep, one block: LN1(CLS), q, k_cls, v_cls, U, bk.q and
// the CLS logit, shared by every group; (2) pool, one block per group (896
// spatial, 672 frequency at the main path's B=8, S=14), the CLS key and value
// added to the tokens' as a separate logit; (3) the tail below.
// K4b launches: (1) LN1 of each group's row 0; (2) q = LN1(x_0) Wq^T + bq on
// the tile GEMM with the groups as rows; (3) U_b,h = Wk_h^T q_b,h and
// c_b,h = bk_h . q_b,h per group (B D^2 MACs: about 0.13 GFLOP at the
// spatial shape's 224 groups, where forming K/V would take about 415); (4)
// the same pool kernel, reading U and c at a per-group stride, with row 0 an
// ordinary key; (5) the tail.
// Tail: proj + residual on the CLS row, LN2, fc1 + GELU, fc2 + residual on
// the tile GEMM with the groups as rows. The TPU kernels keep all of it in
// VMEM; here the (B, D) and (B, 4D) intermediates and K4b's (B, H, D) U pass
// through device memory (a few MB). Bound: the pool pass reads x once (270 MB
// for the spatial aggregator) plus Wv from L2 per group; at the global
// aggregator's (2, 15, 768) the 14 MB of weights.
#include "tile_gemm.cuh"

using sft::bf16;

namespace {

constexpr int THREADS = 256;
constexpr int MAXH = 16;
constexpr int UG = 8;  // K4b groups per block of the U pass

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

// K4b (1): LN1 of row 0 of each group, one warp per group, rounded to bf16.
__global__ void __launch_bounds__(THREADS)
ln_row0_kernel(const bf16* __restrict__ x, int64_t group_stride, const float* __restrict__ g,
               const float* __restrict__ b, bf16* __restrict__ y, int B, int D, float eps) {
  const int lane = threadIdx.x % 32;
  const int grp = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  if (grp >= B) return;
  const bf16* xr = x + (int64_t)grp * group_stride;
  float s = 0.f, s2 = 0.f;
  for (int d = lane; d < D; d += 32) {
    const float v = __bfloat162float(xr[d]);
    s += v;
    s2 += v * v;
  }
  const float mean = sft::warp_sum(s) / D;
  const float msq = sft::warp_sum(s2) / D;
  const float rstd = rsqrtf(fmaxf(msq - mean * mean, 0.f) + eps);
  for (int d = lane; d < D; d += 32)
    y[(int64_t)grp * D + d] =
        __float2bfloat16((__bfloat162float(xr[d]) - mean) * rstd * g[d] + b[d]);
}

// K4b (3): U[b][h][d] = sum_{e in head h} q[b][e] Wk[e][d] and
// c[b][h] = sum_{e in head h} q[b][e] bk[e], in f32 from the bf16 q. Grid
// (ceil(D / THREADS), H, ceil(B / UG)): a thread owns one column d of one
// head for UG groups, so each Wk row is read once per UG groups.
__global__ void __launch_bounds__(THREADS)
cls_u_kernel(const bf16* __restrict__ q, const bf16* __restrict__ wqkv,
             const float* __restrict__ bqkv, float* __restrict__ U, float* __restrict__ cq,
             int B, int D, int H) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // UG * dh
  const int dh = D / H;
  const int h = blockIdx.y, b0 = blockIdx.z * UG;
  const int tid = threadIdx.x;
  for (int i = tid; i < UG * dh; i += THREADS) {
    const int g = i / dh, e = i % dh;
    qs[i] = b0 + g < B ? __bfloat162float(q[(int64_t)(b0 + g) * D + h * dh + e]) : 0.f;
  }
  __syncthreads();
  if (blockIdx.x == 0 && tid < UG && b0 + tid < B) {
    float c = 0.f;
    for (int e = 0; e < dh; ++e) c += qs[tid * dh + e] * bqkv[D + h * dh + e];
    cq[(int64_t)(b0 + tid) * H + h] = c;
  }
  const int d = blockIdx.x * THREADS + tid;
  if (d >= D) return;
  float acc[UG];
#pragma unroll
  for (int g = 0; g < UG; ++g) acc[g] = 0.f;
  const bf16* wk = wqkv + (int64_t)(D + h * dh) * D + d;
  for (int e = 0; e < dh; ++e) {
    const float w = __bfloat162float(wk[(int64_t)e * D]);
#pragma unroll
    for (int g = 0; g < UG; ++g) acc[g] += qs[g * dh + e] * w;
  }
#pragma unroll
  for (int g = 0; g < UG; ++g)
    if (b0 + g < B) U[((int64_t)(b0 + g) * H + h) * D + d] = acc[g];
}

// One block per group over its M rows of x. U (H x D) and cq (H) at
// group b are U + b * u_stride, cq + b * c_stride (stride 0: shared by every
// group). TOKENS (K4): a CLS key and value outside x, logit lc[h] and value
// vc, at column 0 of the softmax; otherwise (K4b) the M rows are all the keys.
template <bool TOKENS>
__global__ void __launch_bounds__(THREADS)
cls_pool_kernel(const bf16* __restrict__ x, const float* __restrict__ g1,
                const float* __restrict__ b1, const bf16* __restrict__ wqkv,
                const float* __restrict__ bqkv, const float* __restrict__ Ug,
                const float* __restrict__ cqg, int64_t u_stride, int c_stride,
                const float* __restrict__ lc, const float* __restrict__ vc,
                bf16* __restrict__ att, int M, int D, int H, float eps, float scale) {
  constexpr int OFF = TOKENS ? 1 : 0;  // softmax columns before the rows of x
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = M + OFF;
  float* U = reinterpret_cast<float*>(smem);  // H*D
  float* z = U + H * D;                       // H*D
  float* p = z + H * D;                       // H*L
  float* mean_s = p + H * L;                  // M
  float* rstd_s = mean_s + M;                 // M
  float* ptok = rstd_s + M;                   // H
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int nw = THREADS / 32;
  const int dh = D / H;
  const int b = blockIdx.x;
  const bf16* xb = x + (int64_t)b * M * D;
  const float* Ub = Ug + (int64_t)b * u_stride;
  const float* cq = cqg + (int64_t)b * c_stride;

  for (int i = tid; i < H * D; i += THREADS) U[i] = Ub[i];
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

  // logits: one warp per row of x, all heads at once
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
        if (lane == 0) p[h * L + OFF + j] = (v + cq[h]) * scale;
      }
    }
  }
  if (TOKENS && tid < H) p[tid * L] = lc[tid] * scale;
  __syncthreads();

  // softmax over every column, one warp per head; probabilities in bf16;
  // ptok[h] sums those of the rows of x
  for (int h = warp; h < H; h += nw) {
    float* ph = p + h * L;
    float m = -INFINITY;
    for (int j = lane; j < L; j += 32) m = fmaxf(m, ph[j]);
    m = sft::warp_max(m);
    float s = 0.f;
    for (int j = lane; j < L; j += 32) {
      const float e = __expf(ph[j] - m);
      ph[j] = e;
      s += e;
    }
    s = sft::warp_sum(s);
    const float inv = 1.f / s;
    float st = 0.f;
    for (int j = lane; j < L; j += 32) {
      const float pr = sft::bf16r(ph[j] * inv);
      ph[j] = pr;
      if (j >= OFF) st += pr;
    }
    st = sft::warp_sum(st);
    if (lane == 0) ptok[h] = st;
  }
  __syncthreads();

  // z[h][d] = sum_j p[h][OFF + j] LN(x_j)[d]
  for (int d = tid; d < D; d += THREADS) {
    float acc[MAXH];
#pragma unroll
    for (int h = 0; h < MAXH; ++h) acc[h] = 0.f;
    const float gd = g1[d], bd = b1[d];
    for (int j = 0; j < M; ++j) {
      const float lv = sft::bf16r((__bfloat162float(xb[(int64_t)j * D + d]) - mean_s[j]) * rstd_s[j] * gd + bd);
#pragma unroll
      for (int h = 0; h < MAXH; ++h)
        if (h < H) acc[h] += p[h * L + OFF + j] * lv;
    }
#pragma unroll
    for (int h = 0; h < MAXH; ++h)
      if (h < H) z[h * D + d] = acc[h];
  }
  __syncthreads();

  // att[e] = z[h(e)] . Wv[e] + ptok[h] bv[e] (+ p_cls[h] vc[e]); one warp per e
  for (int e = warp; e < D; e += nw) {
    const int h = e / dh;
    const bf16* wr = wqkv + (int64_t)(2 * D + e) * D;
    float a = 0.f;
    for (int d = lane; d < D; d += 32) a += z[h * D + d] * __bfloat162float(wr[d]);
    a = sft::warp_sum(a);
    if (lane == 0) {
      float v = a + ptok[h] * bqkv[2 * D + e];
      if (TOKENS) v += p[h * L] * vc[e];
      att[(int64_t)b * D + e] = __float2bfloat16(v);
    }
  }
}

template <bool TOKENS>
int launch_pool(const bf16* x, const float* g1, const float* b1, const bf16* wqkv,
                const float* bqkv, const float* U, const float* cq, int64_t u_stride,
                int c_stride, const float* lc, const float* vc, bf16* att, int B, int M, int D,
                int H, float eps, cudaStream_t s) {
  const float scale = 1.0f / sqrtf((float)(D / H));
  const int L = M + (TOKENS ? 1 : 0);
  const size_t smem = (2 * (size_t)H * D + (size_t)H * L + 2 * (size_t)M + H) * sizeof(float);
  cudaFuncSetAttribute(cls_pool_kernel<TOKENS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  SFT_CHECK_LAUNCH();
  cls_pool_kernel<TOKENS><<<B, THREADS, smem, s>>>(x, g1, b1, wqkv, bqkv, U, cq, u_stride,
                                                   c_stride, lc, vc, att, M, D, H, eps, scale);
  SFT_CHECK_LAUNCH();
  return 0;
}

// proj + residual (row r of R at R + r * r_stride), LN2, fc1 + GELU, fc2 +
// residual, with the groups as rows
int launch_tail(const bf16* att, const bf16* R, int64_t r_stride, const bf16* wp,
                const float* bp, const float* g2, const float* b2, const bf16* w1,
                const float* fb1, const bf16* w2, const float* fb2, bf16* y, bf16* ln2,
                bf16* hbuf, bf16* out, int B, int D, int hidden, float eps, cudaStream_t s) {
  sft::gemm_bf16<sft::EPI_BIAS_RESIDUAL>(att, wp, bp, R, r_stride, y, B, D, D, s);
  SFT_CHECK_LAUNCH();
  sft::ln_rows(y, nullptr, g2, b2, ln2, B, D, eps, s);
  SFT_CHECK_LAUNCH();
  sft::gemm_bf16<sft::EPI_BIAS_GELU>(ln2, w1, fb1, nullptr, 0, hbuf, B, hidden, D, s);
  SFT_CHECK_LAUNCH();
  sft::gemm_bf16<sft::EPI_BIAS_RESIDUAL>(hbuf, w2, fb2, y, D, out, B, D, hidden, s);
  SFT_CHECK_LAUNCH();
  return 0;
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
  const size_t smem_prep = (3 * (size_t)D + 64) * sizeof(float);
  cudaFuncSetAttribute(cls_prep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_prep);
  SFT_CHECK_LAUNCH();
  float* wk = static_cast<float*>(work);
  cls_prep_kernel<<<1, THREADS, smem_prep, s>>>(
      static_cast<const bf16*>(cls), static_cast<const float*>(g1),
      static_cast<const float*>(b1), static_cast<const bf16*>(wqkv),
      static_cast<const float*>(bqkv), wk, D, H, eps);
  SFT_CHECK_LAUNCH();
  int rc = launch_pool<true>(static_cast<const bf16*>(x), static_cast<const float*>(g1),
                             static_cast<const float*>(b1), static_cast<const bf16*>(wqkv),
                             static_cast<const float*>(bqkv), wk + 3 * D, wk + 3 * D + H * D,
                             0, 0, wk + 3 * D + H * D + H, wk + 2 * D, static_cast<bf16*>(att),
                             B, M, D, H, eps, s);
  if (rc != 0) return rc;
  return launch_tail(static_cast<const bf16*>(att), static_cast<const bf16*>(cls), 0,
                     static_cast<const bf16*>(wp), static_cast<const float*>(bp),
                     static_cast<const float*>(g2), static_cast<const float*>(b2),
                     static_cast<const bf16*>(w1), static_cast<const float*>(fb1),
                     static_cast<const bf16*>(w2), static_cast<const float*>(fb2),
                     static_cast<bf16*>(y), static_cast<bf16*>(ln2), static_cast<bf16*>(hbuf),
                     static_cast<bf16*>(out), B, D, hidden, eps, s);
}

// K4b. Scratch: qbuf bf16 (2, B, D) [LN1(x_0); q], ubuf f32 (B*H*D + B*H)
// [U; c]; att, y, ln2 bf16 (B, D); hbuf bf16 (B, hidden).
extern "C" int sft_cls_pool(const void* x, const void* g1, const void* b1, const void* wqkv,
                            const void* bqkv, const void* wp, const void* bp, const void* g2,
                            const void* b2, const void* w1, const void* fb1, const void* w2,
                            const void* fb2, void* qbuf, void* ubuf, void* att, void* y,
                            void* ln2, void* hbuf, void* out, int B, int N, int D, int H,
                            int hidden, float eps, void* stream) {
  if (H > MAXH || D % H != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wq = static_cast<const bf16*>(wqkv);
  const float* bq = static_cast<const float*>(bqkv);
  bf16* ln0 = static_cast<bf16*>(qbuf);
  bf16* q = ln0 + (int64_t)B * D;
  float* U = static_cast<float*>(ubuf);
  float* cq = U + (int64_t)B * H * D;
  const int64_t gstride = (int64_t)N * D;

  const int warps = THREADS / 32;
  ln_row0_kernel<<<(B + warps - 1) / warps, THREADS, 0, s>>>(
      xb, gstride, static_cast<const float*>(g1), static_cast<const float*>(b1), ln0, B, D, eps);
  SFT_CHECK_LAUNCH();
  sft::gemm_bf16<sft::EPI_BIAS>(ln0, wq, bq, nullptr, 0, q, B, D, D, s);
  SFT_CHECK_LAUNCH();
  const int dh = D / H;
  dim3 ugrid((D + THREADS - 1) / THREADS, H, (B + UG - 1) / UG);
  cls_u_kernel<<<ugrid, THREADS, (size_t)UG * dh * sizeof(float), s>>>(q, wq, bq, U, cq, B, D, H);
  SFT_CHECK_LAUNCH();
  int rc = launch_pool<false>(xb, static_cast<const float*>(g1), static_cast<const float*>(b1),
                              wq, bq, U, cq, (int64_t)H * D, H, nullptr, nullptr,
                              static_cast<bf16*>(att), B, N, D, H, eps, s);
  if (rc != 0) return rc;
  return launch_tail(static_cast<const bf16*>(att), xb, gstride, static_cast<const bf16*>(wp),
                     static_cast<const float*>(bp), static_cast<const float*>(g2),
                     static_cast<const float*>(b2), static_cast<const bf16*>(w1),
                     static_cast<const float*>(fb1), static_cast<const bf16*>(w2),
                     static_cast<const float*>(fb2), static_cast<bf16*>(y),
                     static_cast<bf16*>(ln2), static_cast<bf16*>(hbuf), static_cast<bf16*>(out),
                     B, D, hidden, eps, s);
}
