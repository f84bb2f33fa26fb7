// The divided space-time attention launches shared by K1, K5, K7a/K7b
// (csrc/divided_attention.cu) and K8a (csrc/fused_block.cu): (1) the group
// attention of every patch token and (2) the CLS row over all 1 + f*n keys,
// on the split or the packed layout (csrc/divided_attention.cu says how the
// layouts and the launches work).
//
// Launch (1) in space mode (a group is a frame: n queries over [CLS; n]
// keys) is the tensor-core kernel of mma_attention.cuh on the TPU kernels'
// recipe (exp rounded to bf16 unnormalised, the CLS key's term in f32, one
// division). In time mode (a group is a spatial position: f = 8 queries over
// f + 1 keys, too short for a 16-row tile) it is time_attention_kernel below,
// bound by memory: at (112, 8, 196), 12 heads of 64, it reads 809 MB of qkv
// and writes 270 MB, 0.32 ms at 3.35 TB/s, against about 5 GFLOP of
// arithmetic (microseconds on any unit). So the design is about bytes: a block owns P
// consecutive spatial positions of one segment and all H heads, stages their
// f * P key / value rows and the segment's CLS key / value row (each frame's
// P rows are contiguous) with 16-byte cp.async, and reads each query slice
// and writes each output slice with 16-byte accesses: every byte of qkv is
// read once and every output row written once. The arithmetic runs on CUDA
// cores, four lanes a query.
#pragma once

#include "mma_attention.cuh"

namespace sft {
namespace attn {

constexpr int WARPS = 8;

// Shared memory of the time pass: P positions' f * P key / value rows and
// the CLS row's, [k | v] each, and each warp's logits of 8 queries. P is the
// largest of 4, 2, 1 whose rows fit TIME_SMEM_TARGET (4 blocks an SM at D =
// 768, f = 8: P = 2), else 1; the wrappers mirror this plan
// (ops/kernels/_build.py::time_pass_plan) and refuse an f whose rows do not
// fit the block's shared memory.
constexpr int TIME_THREADS = WARPS * 32;
constexpr size_t TIME_SMEM_TARGET = 57344;
constexpr size_t MAX_SMEM = 232448;

inline size_t time_smem(int f, int D, int P) {
  return (size_t)(1 + f * P) * 2 * D * sizeof(bf16) + (size_t)WARPS * 8 * (f + 1) * sizeof(float);
}

inline int time_positions(int f, int D) {
  for (int P = 4; P > 1; P /= 2)
    if (time_smem(f, D, P) <= TIME_SMEM_TARGET) return P;
  return 1;
}

// Time mode's group attention. Block (x, b): positions g0 = x * P .. g0 + P - 1
// (those below n) of segment b, all H heads. Staged row 0 is the CLS row,
// row 1 + i * P + p frame i at position g0 + p. Each warp takes (position,
// head) items, 8 queries (frames) at a time, four lanes a query, each lane
// DH / 4 columns: q scaled by DH^-0.5 and rounded to bf16, f32 logits by quad
// shuffles over [CLS; the f frames], f32 softmax, the normalised
// probabilities rounded to bf16, P @ V in f32, the output rounded once.
// Query i of position g, segment b: qkv_p + (b * in_p + g + i * n) * 3D;
// output rows attn + (b * out_p + g + i * n) * D; the CLS row of segment b:
// qkv_c + b * in_c * 3D.
template <int DH>
__global__ void __launch_bounds__(TIME_THREADS)
time_attention_kernel(const bf16* __restrict__ qkv_p, const bf16* __restrict__ qkv_c,
                      bf16* __restrict__ attn, int f, int n, int H, int P, int in_p, int in_c,
                      int out_p, float scale) {
  constexpr int C = DH / 4;  // columns a lane owns
  constexpr int V = C / 8;   // its 16-byte pieces
  static_assert(C % 8 == 0, "the time pass takes head_dim in {32, 64, 96, 128}");
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = H * DH, D2 = 2 * D;
  const int g0 = blockIdx.x * P, b = blockIdx.y;
  const int np = min(P, n - g0);
  const int rows = 1 + f * P;
  bf16* KV = reinterpret_cast<bf16*>(smem);
  float* ps_all = reinterpret_cast<float*>(KV + (size_t)rows * D2);
  const bf16* pin = qkv_p + (int64_t)b * in_p * 3 * D;
  bf16* pout = attn + (int64_t)b * out_p * D;

  const int pieces = D2 / 8;
  for (int idx = threadIdx.x; idx < rows * pieces; idx += TIME_THREADS) {
    const int r = idx / pieces, c = idx % pieces;
    const bf16* src = qkv_c + (int64_t)b * in_c * 3 * D;
    bool valid = true;
    if (r > 0) {
      const int i = (r - 1) / P, p = (r - 1) % P;
      valid = p < np;
      src = pin + ((int64_t)i * n + g0 + (valid ? p : 0)) * 3 * D;
    }
    cp_async16(KV + (size_t)r * D2 + c * 8, src + D + c * 8, valid);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int quad = lane / 4, part = lane % 4;
  float* ps = ps_all + (warp * 8 + quad) * (f + 1);
  for (int item = warp; item < np * H; item += WARPS) {
    const int p = item / H, h = item % H;
    const int col = h * DH + part * C;
    for (int i0 = 0; i0 < f; i0 += 8) {
      const int i = i0 + quad;
      const bool live = i < f;
      const int64_t tok = (int64_t)(live ? i : 0) * n + g0 + p;
      float q[C];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const uint4 raw = live ? __ldg(reinterpret_cast<const uint4*>(pin + tok * 3 * D + col) + v)
                               : make_uint4(0u, 0u, 0u, 0u);
        const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float2 x = __bfloat1622float2(e[u]);
          q[8 * v + 2 * u] = sft::bf16r(x.x * scale);
          q[8 * v + 2 * u + 1] = sft::bf16r(x.y * scale);
        }
      }
      float m = -INFINITY;
      for (int j = 0; j <= f; ++j) {
        const int r = j == 0 ? 0 : 1 + (j - 1) * P + p;
        const uint4* kr = reinterpret_cast<const uint4*>(KV + (size_t)r * D2 + col);
        float s = 0.f;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const uint4 raw = kr[v];
          const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float2 k = __bfloat1622float2(e[u]);
            s += q[8 * v + 2 * u] * k.x + q[8 * v + 2 * u + 1] * k.y;
          }
        }
        s = tc::quad_sum(s);
        if (part == 0) ps[j] = s;
        m = fmaxf(m, s);
      }
      __syncwarp();
      if (live) {
        float sum = 0.f;
        for (int j = 0; j <= f; ++j) sum += __expf(ps[j] - m);
        const float inv = 1.f / sum;
        float o[C] = {};
        for (int j = 0; j <= f; ++j) {
          const float pj = sft::bf16r(__expf(ps[j] - m) * inv);
          const int r = j == 0 ? 0 : 1 + (j - 1) * P + p;
          const uint4* vr = reinterpret_cast<const uint4*>(KV + (size_t)r * D2 + D + col);
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const uint4 raw = vr[v];
            const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const float2 x = __bfloat1622float2(e[u]);
              o[8 * v + 2 * u] += pj * x.x;
              o[8 * v + 2 * u + 1] += pj * x.y;
            }
          }
        }
        uint4* orow = reinterpret_cast<uint4*>(pout + tok * D + col);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          uint4 w;
          uint32_t* wp = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
          for (int u = 0; u < 4; ++u) wp[u] = tc::pack_bf16(o[8 * v + 2 * u], o[8 * v + 2 * u + 1]);
          orow[v] = w;
        }
      }
      __syncwarp();
    }
  }
}

constexpr int CLS_THREADS = 256;
constexpr int KEYS_IN_FLIGHT = 4;  // loads a CLS-row warp starts before it sums

// CLS query of (b, h) over [CLS; all f*n patches].
template <int DH>
__global__ void __launch_bounds__(CLS_THREADS)
cls_row_kernel(const bf16* __restrict__ qkv_p, const bf16* __restrict__ qkv_c,
               bf16* __restrict__ out_c, int fn, int H, int in_p, int in_c, int out_cs,
               float scale) {
  constexpr int NP = (DH / 2 + 31) / 32;  // bf16 pairs of a row per lane
  constexpr bool FULL = (DH / 2) % 32 == 0;  // every lane holds NP pairs
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int D = H * DH;
  const int nk = fn + 1;
  float* qs = reinterpret_cast<float*>(smem);        // DH
  float* red = qs + DH;                               // 32
  float* acc = red + 32;                              // (CLS_THREADS / 32) x DH
  float* ps = acc + (CLS_THREADS / 32) * DH;          // nk
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const bf16* crow = qkv_c + (int64_t)b * in_c * 3 * D;
  const bf16* prow0 = qkv_p + (int64_t)b * in_p * 3 * D;

  if (tid < DH) qs[tid] = sft::bf16r(__bfloat162float(crow[h * DH + tid]) * scale);
  __syncthreads();

  float m = -INFINITY;
  for (int j = tid; j < nk; j += CLS_THREADS) {
    const bf16* row = j == 0 ? crow : prow0 + (int64_t)(j - 1) * 3 * D;
    const float s = sft::dot_row_bf16<DH>(qs, row + D + h * DH);
    ps[j] = s;
    m = fmaxf(m, s);
  }
  m = sft::warp_max(m);
  if (lane == 0) red[warp] = m;
  __syncthreads();
  m = red[0];
  for (int w = 1; w < CLS_THREADS / 32; ++w) m = fmaxf(m, red[w]);
  __syncthreads();
  float sum = 0.f;
  for (int j = tid; j < nk; j += CLS_THREADS) {
    const float e = __expf(ps[j] - m);
    ps[j] = e;
    sum += e;
  }
  sum = sft::warp_sum(sum);
  if (lane == 0) red[warp] = sum;
  __syncthreads();
  sum = 0.f;
  for (int w = 0; w < CLS_THREADS / 32; ++w) sum += red[w];
  const float inv = 1.f / sum;
  for (int j = tid; j < nk; j += CLS_THREADS) ps[j] = sft::bf16r(ps[j] * inv);
  __syncthreads();

  // each warp takes keys j = warp, warp + 8, ...; each lane a pair of
  // columns, one sweep over the keys per pair; the sweep is bound by load
  // latency, so it loads KEYS_IN_FLIGHT keys before it sums them (in key
  // order)
#pragma unroll
  for (int u = 0; u < NP; ++u) {
    const int t = lane + 32 * u;
    if (FULL || t < DH / 2) {
      float a0 = 0.f, a1 = 0.f;
      constexpr int STEP = CLS_THREADS / 32;
      for (int j0 = warp; j0 < nk; j0 += STEP * KEYS_IN_FLIGHT) {
        float2 v[KEYS_IN_FLIGHT];
#pragma unroll
        for (int k = 0; k < KEYS_IN_FLIGHT; ++k) {
          const int j = j0 + k * STEP;
          const bf16* row = j == 0 ? crow : prow0 + (int64_t)(j - 1) * 3 * D;
          v[k] = j < nk ? __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(
                              row + 2 * D + h * DH)[t])
                        : make_float2(0.f, 0.f);
        }
#pragma unroll
        for (int k = 0; k < KEYS_IN_FLIGHT; ++k) {
          const int j = j0 + k * STEP;
          if (j < nk) {
            a0 += ps[j] * v[k].x;
            a1 += ps[j] * v[k].y;
          }
        }
      }
      acc[warp * DH + 2 * t] = a0;
      acc[warp * DH + 2 * t + 1] = a1;
    }
  }
  __syncthreads();
  if (tid < DH) {
    float s = 0.f;
    for (int w = 0; w < CLS_THREADS / 32; ++w) s += acc[w * DH + tid];
    out_c[(int64_t)b * out_cs * D + h * DH + tid] = __float2bfloat16(s);
  }
}

// keys of a space-mode chunk: one sweep up to 207 patches a frame
constexpr int SPACE_KT = 13;

// The attention of every patch (space: the tensor-core kernel; time:
// time_attention_kernel) and of the CLS row. Row strides between segments: in_p / in_c
// of the patch / CLS rows of qkv, out_p / out_c of the outputs.
template <int DH>
int launch_attention(const bf16* qkv_p, const bf16* qkv_c, bf16* attn_p, bf16* out_c, int B,
                     int f, int n, int H, int mode, int in_p, int in_c, int out_p, int out_cs,
                     cudaStream_t s) {
  const int fn = f * n;
  const float scale = (float)pow((double)DH, -0.5);
  if (mode == 0) {
    const tc::Problem p{qkv_p, qkv_c, attn_p, in_p, in_c, out_p, n, n, H, 0, 0, 0, scale};
    const int err = tc::launch<DH, SPACE_KT, true>(p, f, B, s);
    if (err != 0) return err;
  } else {
    const int D = H * DH;
    const int P = time_positions(f, D);
    const size_t smem_t = time_smem(f, D, P);
    if (smem_t > MAX_SMEM) return (int)cudaErrorInvalidValue;
    cudaFuncSetAttribute(time_attention_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem_t);
    SFT_CHECK_LAUNCH();
    time_attention_kernel<DH><<<dim3((n + P - 1) / P, B), TIME_THREADS, smem_t, s>>>(
        qkv_p, qkv_c, attn_p, f, n, H, P, in_p, in_c, out_p, scale);
    SFT_CHECK_LAUNCH();
  }
  const size_t smem_c = (DH + 32 + (CLS_THREADS / 32) * DH + (size_t)(fn + 1)) * sizeof(float);
  cudaFuncSetAttribute(cls_row_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem_c);
  SFT_CHECK_LAUNCH();
  cls_row_kernel<DH><<<dim3(H, B), CLS_THREADS, smem_c, s>>>(qkv_p, qkv_c, out_c, fn, H, in_p,
                                                             in_c, out_cs, scale);
  SFT_CHECK_LAUNCH();
  return 0;
}

// launch_attention at the head_dim of the call; the instantiated set is
// {32, 64, 96, 128}, and the wrappers refuse any other before they launch.
inline int dispatch_attention(int dh, const bf16* qkv_p, const bf16* qkv_c, bf16* attn_p,
                       bf16* out_c, int B, int f, int n, int H, int mode, int in_p, int in_c,
                       int out_p, int out_cs, cudaStream_t s) {
  switch (dh) {
    case 32:
      return launch_attention<32>(qkv_p, qkv_c, attn_p, out_c, B, f, n, H, mode, in_p, in_c,
                                  out_p, out_cs, s);
    case 64:
      return launch_attention<64>(qkv_p, qkv_c, attn_p, out_c, B, f, n, H, mode, in_p, in_c,
                                  out_p, out_cs, s);
    case 96:
      return launch_attention<96>(qkv_p, qkv_c, attn_p, out_c, B, f, n, H, mode, in_p, in_c,
                                  out_p, out_cs, s);
    case 128:
      return launch_attention<128>(qkv_p, qkv_c, attn_p, out_c, B, f, n, H, mode, in_p, in_c,
                                   out_p, out_cs, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace attn
}  // namespace sft
