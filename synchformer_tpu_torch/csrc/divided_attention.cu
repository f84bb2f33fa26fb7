// K1: divided space-time attention on the split (CLS, patches) layout with
// the output projection and residual in the epilogue, and K5: the same
// attention without them.
//
// K1 replaces synchformer_tpu/ops/pallas/divided_attention.py::
// divided_attention_proj_4d (body _kernel_4d_proj with _cls_row_4d,
// _space_pair_v3, _time_pair_v3); K5 replaces divided_attention_pallas_4d
// (body _kernel_4d), the forward of the Stage I training step. K5 runs
// launches (1) and (2) below and writes the attention straight to its
// output; its bound at Stage I's (28, 8, 196, 2304) is the ~270 MB it moves.
//
// Semantics, per head (12 of 64 on the main path), q scaled by dh^-0.5:
// - each patch token attends {CLS} U its group: the n tokens of its frame
//   (space, 197 keys) or the f tokens at its spatial position (time, 9 keys);
// - the CLS query attends all 1 + f*n keys and leaves un-projected;
// - patches: y = res + (attn @ Wo^T + bo), rounded once.
//
// Three launches. (1) group attention: one block per (head, group, batch)
// stages the group's K/V rows (plus the CLS row) in shared memory with a
// padded pitch, each warp walks query rows (logits one key per lane, f32
// softmax by shuffles, bf16 probabilities, P @ V two columns per lane) and
// writes the bf16 attention output to a scratch buffer in device memory. Space
// and time differ only in the group/member strides, so one kernel serves both.
// (2) the CLS row: one block per (head, batch) over all 1569 keys. (3) the
// projection + residual on the tile GEMM. The TPU kernel keeps the attention
// output in VMEM before the projection; here it round-trips device memory
// (2 x 270 MB per call at B=112), which a later fused epilogue removes.
// Bound: the space call is ~104 GFLOP of attention math on CUDA cores; the
// tensor cores only run the projection.
#include "tile_gemm.cuh"

using sft::bf16;

namespace {

constexpr int DH = 64;
constexpr int PITCH = DH + 2;
constexpr int WARPS = 8;

// qkv_p rows: token (b, g, j) = b*f*n + g*gs + j*ms, each 3D wide.
__global__ void __launch_bounds__(WARPS * 32)
group_attention_kernel(const bf16* __restrict__ qkv_p, const bf16* __restrict__ qkv_c,
                       bf16* __restrict__ attn, int fn, int L, int gs, int ms, int H,
                       float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int D = H * DH;
  const int nk = L + 1;
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + nk * PITCH;
  float* qs_all = reinterpret_cast<float*>(Vs + nk * PITCH);
  float* ps_all = qs_all + WARPS * DH;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int64_t tok0 = (int64_t)b * fn + (int64_t)g * gs;

  for (int idx = tid; idx < nk * (DH / 2); idx += blockDim.x) {
    const int r = idx / (DH / 2), t = idx % (DH / 2);
    const bf16* row = r == 0 ? qkv_c + (int64_t)b * 3 * D
                             : qkv_p + (tok0 + (int64_t)(r - 1) * ms) * 3 * D;
    reinterpret_cast<__nv_bfloat162*>(Ks + r * PITCH)[t] =
        reinterpret_cast<const __nv_bfloat162*>(row + D + h * DH)[t];
    reinterpret_cast<__nv_bfloat162*>(Vs + r * PITCH)[t] =
        reinterpret_cast<const __nv_bfloat162*>(row + 2 * D + h * DH)[t];
  }
  __syncthreads();

  float* qs = qs_all + warp * DH;
  float* ps = ps_all + warp * nk;
  for (int i = warp; i < L; i += WARPS) {
    const int64_t tok = tok0 + (int64_t)i * ms;
    const bf16* qrow = qkv_p + tok * 3 * D + h * DH;
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
    float a0 = 0.f, a1 = 0.f;
    for (int j = 0; j < nk; ++j) {
      const float2 v = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(Vs + j * PITCH)[lane]);
      a0 += ps[j] * v.x;
      a1 += ps[j] * v.y;
    }
    reinterpret_cast<__nv_bfloat162*>(attn + tok * D + h * DH)[lane] =
        __floats2bfloat162_rn(a0, a1);
    __syncwarp();
  }
}

constexpr int CLS_THREADS = 256;

// CLS query of (b, h) over [CLS; all f*n patches].
__global__ void __launch_bounds__(CLS_THREADS)
cls_row_kernel(const bf16* __restrict__ qkv_p, const bf16* __restrict__ qkv_c,
               bf16* __restrict__ out_c, int fn, int H, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int D = H * DH;
  const int nk = fn + 1;
  float* qs = reinterpret_cast<float*>(smem);        // DH
  float* red = qs + DH;                               // 32
  float* acc = red + 32;                              // (CLS_THREADS / 32) x DH
  float* ps = acc + (CLS_THREADS / 32) * DH;          // nk
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const bf16* crow = qkv_c + (int64_t)b * 3 * D;
  const bf16* prow0 = qkv_p + (int64_t)b * fn * 3 * D;

  if (tid < DH) qs[tid] = sft::bf16r(__bfloat162float(crow[h * DH + tid]) * scale);
  __syncthreads();

  float m = -INFINITY;
  for (int j = tid; j < nk; j += CLS_THREADS) {
    const bf16* row = j == 0 ? crow : prow0 + (int64_t)(j - 1) * 3 * D;
    const __nv_bfloat162* kr = reinterpret_cast<const __nv_bfloat162*>(row + D + h * DH);
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

  // each warp takes keys j = warp, warp + 8, ...; each lane two columns
  float a0 = 0.f, a1 = 0.f;
  for (int j = warp; j < nk; j += CLS_THREADS / 32) {
    const bf16* row = j == 0 ? crow : prow0 + (int64_t)(j - 1) * 3 * D;
    const float2 v = __bfloat1622float2(
        reinterpret_cast<const __nv_bfloat162*>(row + 2 * D + h * DH)[lane]);
    a0 += ps[j] * v.x;
    a1 += ps[j] * v.y;
  }
  acc[warp * DH + 2 * lane] = a0;
  acc[warp * DH + 2 * lane + 1] = a1;
  __syncthreads();
  if (tid < DH) {
    float s = 0.f;
    for (int w = 0; w < CLS_THREADS / 32; ++w) s += acc[w * DH + tid];
    out_c[(int64_t)b * D + h * DH + tid] = __float2bfloat16(s);
  }
}

// The attention of every patch (group kernel) and of the CLS row, written to
// attn_p (B, f, n, D) and out_c (B, 1, D) in head-major feature order.
int launch_attention(const bf16* qkv_p, const bf16* qkv_c, bf16* attn_p, bf16* out_c,
                     int B, int f, int n, int H, int mode, cudaStream_t s) {
  const int fn = f * n;
  const float scale = 0.125f;  // 64^-0.5
  const int L = mode == 0 ? n : f, G = mode == 0 ? f : n;
  const int gs = mode == 0 ? n : 1, ms = mode == 0 ? 1 : n;
  const size_t smem_g = 2 * (size_t)(L + 1) * PITCH * sizeof(bf16) +
                        (size_t)WARPS * (DH + L + 1) * sizeof(float);
  cudaFuncSetAttribute(group_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem_g);
  SFT_CHECK_LAUNCH();
  group_attention_kernel<<<dim3(H, G, B), WARPS * 32, smem_g, s>>>(qkv_p, qkv_c, attn_p, fn,
                                                                   L, gs, ms, H, scale);
  SFT_CHECK_LAUNCH();
  const size_t smem_c = (DH + 32 + (CLS_THREADS / 32) * DH + (size_t)(fn + 1)) * sizeof(float);
  cudaFuncSetAttribute(cls_row_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_c);
  SFT_CHECK_LAUNCH();
  cls_row_kernel<<<dim3(H, B), CLS_THREADS, smem_c, s>>>(qkv_p, qkv_c, out_c, fn, H, scale);
  SFT_CHECK_LAUNCH();
  return 0;
}

}  // namespace

// K1. mode 0 = space (groups are frames), 1 = time (groups are spatial positions).
extern "C" int sft_divided_attention_proj(const void* qkv_p, const void* qkv_c,
                                          const void* res, const void* wo, const void* bo,
                                          void* attn_scratch, void* out_p, void* out_c,
                                          int B, int f, int n, int H, int dh, int mode,
                                          void* stream) {
  if (dh != DH) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int D = H * DH, fn = f * n;
  const int err = launch_attention(static_cast<const bf16*>(qkv_p),
                                   static_cast<const bf16*>(qkv_c),
                                   static_cast<bf16*>(attn_scratch), static_cast<bf16*>(out_c),
                                   B, f, n, H, mode, s);
  if (err != 0) return err;
  sft::gemm_bf16<sft::EPI_BIAS_RESIDUAL>(
      static_cast<const bf16*>(attn_scratch), static_cast<const bf16*>(wo),
      static_cast<const float*>(bo), static_cast<const bf16*>(res), D,
      static_cast<bf16*>(out_p), B * fn, D, D, s);
  SFT_CHECK_LAUNCH();
  return 0;
}

// K5: the same attention without the projection: out_p (B, f, n, D) and
// out_c (B, 1, D), the outputs of divided_attention_pallas_4d.
extern "C" int sft_divided_attention(const void* qkv_p, const void* qkv_c, void* out_p,
                                     void* out_c, int B, int f, int n, int H, int dh,
                                     int mode, void* stream) {
  if (dh != DH) return (int)cudaErrorInvalidValue;
  return launch_attention(static_cast<const bf16*>(qkv_p), static_cast<const bf16*>(qkv_c),
                          static_cast<bf16*>(out_p), static_cast<bf16*>(out_c), B, f, n, H,
                          mode, static_cast<cudaStream_t>(stream));
}
