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
// f + 1 keys, too short for a 16-row tile) it is group_attention_kernel below,
// on CUDA cores.
#pragma once

#include "mma_attention.cuh"

namespace sft {
namespace attn {

constexpr int WARPS = 8;

// Time mode's group attention: one block per (head, position, segment), each
// warp one query row at a time (logits one key per lane, f32 softmax by
// shuffles, normalised probabilities rounded to bf16, P @ V in bf16 pairs of
// columns). Query i of position g, segment b: qkv_p + (b * in_p + g + i * n)
// * 3D; output rows attn + (b * out_p + g + i * n) * D. The CLS row of
// segment b: qkv_c + b * in_c * 3D.
template <int DH>
__global__ void __launch_bounds__(WARPS * 32)
group_attention_kernel(const bf16* __restrict__ qkv_p, const bf16* __restrict__ qkv_c,
                       bf16* __restrict__ attn, int L, int n, int H, int in_p, int in_c,
                       int out_p, float scale) {
  constexpr int PITCH = DH + 2;  // bf16 row pitch: an odd number of words
  constexpr int NP = (DH / 2 + 31) / 32;  // bf16 pairs of a row per lane
  constexpr bool FULL = (DH / 2) % 32 == 0;  // every lane holds NP pairs
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int D = H * DH;
  const int nk = L + 1;
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + nk * PITCH;
  float* qs_all = reinterpret_cast<float*>(Vs + nk * PITCH);
  float* ps_all = qs_all + WARPS * DH;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int64_t tok0 = g;
  const bf16* pin = qkv_p + (int64_t)b * in_p * 3 * D;
  bf16* pout = attn + (int64_t)b * out_p * D;

  for (int idx = tid; idx < nk * (DH / 2); idx += blockDim.x) {
    const int r = idx / (DH / 2), t = idx % (DH / 2);
    const bf16* row = r == 0 ? qkv_c + (int64_t)b * in_c * 3 * D
                             : pin + (tok0 + (int64_t)(r - 1) * n) * 3 * D;
    reinterpret_cast<__nv_bfloat162*>(Ks + r * PITCH)[t] =
        reinterpret_cast<const __nv_bfloat162*>(row + D + h * DH)[t];
    reinterpret_cast<__nv_bfloat162*>(Vs + r * PITCH)[t] =
        reinterpret_cast<const __nv_bfloat162*>(row + 2 * D + h * DH)[t];
  }
  __syncthreads();

  float* qs = qs_all + warp * DH;
  float* ps = ps_all + warp * nk;
  for (int i = warp; i < L; i += WARPS) {
    const int64_t tok = tok0 + (int64_t)i * n;
    const bf16* qrow = pin + tok * 3 * D + h * DH;
    for (int d = lane; d < DH; d += 32) qs[d] = sft::bf16r(__bfloat162float(qrow[d]) * scale);
    __syncwarp();
    float m = -INFINITY;
    for (int j = lane; j < nk; j += 32) {
      const __nv_bfloat162* kr = reinterpret_cast<const __nv_bfloat162*>(Ks + j * PITCH);
      float s = 0.f;
#pragma unroll 8
      for (int t = 0; t < DH / 2; ++t) {
        const float2 kv = __bfloat1622float2(kr[t]);
        s += qs[2 * t] * kv.x + qs[2 * t + 1] * kv.y;
      }
      ps[j] = s;
      m = fmaxf(m, s);
    }
    m = sft::warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < nk; j += 32) {
      const float e = __expf(ps[j] - m);
      ps[j] = e;
      sum += e;
    }
    sum = sft::warp_sum(sum);
    const float inv = 1.f / sum;
    for (int j = lane; j < nk; j += 32) ps[j] = sft::bf16r(ps[j] * inv);
    __syncwarp();
    float a[NP][2] = {};
    for (int j = 0; j < nk; ++j) {
      const __nv_bfloat162* vr = reinterpret_cast<const __nv_bfloat162*>(Vs + j * PITCH);
#pragma unroll
      for (int u = 0; u < NP; ++u) {
        const int t = lane + 32 * u;
        if (FULL || t < DH / 2) {
          const float2 v = __bfloat1622float2(vr[t]);
          a[u][0] += ps[j] * v.x;
          a[u][1] += ps[j] * v.y;
        }
      }
    }
    __nv_bfloat162* orow = reinterpret_cast<__nv_bfloat162*>(pout + tok * D + h * DH);
#pragma unroll
    for (int u = 0; u < NP; ++u) {
      const int t = lane + 32 * u;
      if (FULL || t < DH / 2) orow[t] = __floats2bfloat162_rn(a[u][0], a[u][1]);
    }
    __syncwarp();
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

// The attention of every patch (space: the tensor-core kernel; time: the
// group kernel) and of the CLS row. Row strides between segments: in_p / in_c
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
    const size_t smem_g = 2 * (size_t)(f + 1) * (DH + 2) * sizeof(bf16) +
                          (size_t)WARPS * (DH + f + 1) * sizeof(float);
    cudaFuncSetAttribute(group_attention_kernel<DH>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_g);
    SFT_CHECK_LAUNCH();
    group_attention_kernel<DH><<<dim3(H, n, B), WARPS * 32, smem_g, s>>>(
        qkv_p, qkv_c, attn_p, f, n, H, in_p, in_c, out_p, scale);
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
