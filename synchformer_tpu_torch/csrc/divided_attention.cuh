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
//
// Any head_dim dh that is a multiple of 8, up to 256: the kernels are
// instantiated for the widths of mma_attention.cuh's padded_width and dh
// runs at the next one up, its staged columns past dh zeroed
// (mma_attention.cuh says how). The time pass
// stages a group of HG heads' key / value columns (all H where they fit), so
// how many frames it takes depends on dh, not on D: its plan (time_plan,
// mirrored by ops/kernels/_build.py::time_pass_plan) picks P and HG.
#pragma once

#include "mma_attention.cuh"

namespace sft {
namespace attn {

constexpr int WARPS = 8;

// Shared memory of the time pass: P positions' f * P key / value rows and
// the CLS row's, [k | v] each over HG heads at DHP columns a head, and each
// warp's logits of 8 queries. The plan: all H heads and the largest P of 4,
// 2 whose rows fit TIME_SMEM_TARGET (4 blocks an SM at D = 768, f = 8: P =
// 2); else P = 1 and the largest HG dividing H that fits the target, else
// the largest that fits a block. The wrappers mirror it
// (ops/kernels/_build.py::time_pass_plan) and refuse an f whose rows do not
// fit even one head.
constexpr int TIME_THREADS = WARPS * 32;
constexpr size_t TIME_SMEM_TARGET = 57344;
constexpr size_t MAX_SMEM = 232448;

inline size_t time_smem(int f, int HG, int DHP, int P) {
  return (size_t)(1 + f * P) * 2 * HG * DHP * sizeof(bf16) +
         (size_t)WARPS * 8 * (f + 1) * sizeof(float);
}

struct TimePlan {
  int P, HG;
  size_t smem;
};

inline TimePlan time_plan(int f, int H, int DHP) {
  for (int P = 4; P > 1; P /= 2)
    if (time_smem(f, H, DHP, P) <= TIME_SMEM_TARGET) return {P, H, time_smem(f, H, DHP, P)};
  const size_t limits[2] = {TIME_SMEM_TARGET, MAX_SMEM};
  for (size_t limit : limits)
    for (int hg = H; hg >= 1; --hg)
      if (H % hg == 0 && time_smem(f, hg, DHP, 1) <= limit) return {1, hg, time_smem(f, hg, DHP, 1)};
  return {1, 1, time_smem(f, 1, DHP, 1)};
}

// Time mode's group attention. Block (x, b, z): positions g0 = x * P .. g0 +
// P - 1 (those below n) of segment b, heads h0 = z * HG .. h0 + HG - 1.
// Staged row 0 is the CLS row, row 1 + i * P + p frame i at position g0 + p:
// [k of the HG heads | v of the HG heads], DHP columns a head, zero past dh.
// Each warp takes (position, head) items, 8 queries (frames) at a time (not
// DIRECT: (item, 8 queries) units, so that a block of few heads keeps its
// warps busy), four lanes a query, each lane DHP / 4 columns: q scaled by dh^-0.5 and rounded
// to bf16, f32 logits by quad shuffles over [CLS; the f frames], f32
// softmax, the normalised probabilities rounded to bf16, P @ V in f32, the
// output rounded once. Query i of position g, segment b: qkv_p + (b * in_p +
// g + i * n) * 3D; output rows attn + (b * out_p + g + i * n) * D; the CLS
// row of segment b: qkv_c + b * in_c * 3D; D = H * dh. DIRECT: dh == DHP
// and HG == H, so a staged row is the [k | v] of the device row as it lies
// (the main path's plan, compiled without the head-group arithmetic).
template <int DHP, bool DIRECT>
__global__ void __launch_bounds__(TIME_THREADS)
time_attention_kernel(const bf16* __restrict__ qkv_p, const bf16* __restrict__ qkv_c,
                      bf16* __restrict__ attn, int f, int n, int H, int dh_arg, int HG_arg,
                      int P, int in_p, int in_c, int out_p, float scale) {
  constexpr int C = DHP / 4;   // columns a lane owns
  constexpr int V = C / 8;     // its 16-byte pieces
  constexpr int HP = DHP / 8;  // 16-byte pieces of a staged head
  static_assert(C % 8 == 0, "the time pass takes widths that are multiples of 32");
  extern __shared__ __align__(16) unsigned char smem[];
  const int dh = DIRECT ? DHP : dh_arg, HG = DIRECT ? H : HG_arg;
  const int D = H * dh, W = HG * DHP, W2 = 2 * W;
  const int g0 = blockIdx.x * P, b = blockIdx.y, h0 = blockIdx.z * HG;
  const int np = min(P, n - g0);
  const int rows = 1 + f * P;
  const int cpr = dh / 8;
  bf16* KV = reinterpret_cast<bf16*>(smem);
  float* ps_all = reinterpret_cast<float*>(KV + (size_t)rows * W2);
  const bf16* pin = qkv_p + (int64_t)b * in_p * 3 * D;
  bf16* pout = attn + (int64_t)b * out_p * D;

  const int pieces = W2 / 8;
  for (int idx = threadIdx.x; idx < rows * pieces; idx += TIME_THREADS) {
    const int r = idx / pieces, c = idx % pieces;
    const bf16* src = qkv_c + (int64_t)b * in_c * 3 * D;
    bool valid = true;
    if (r > 0) {
      const int i = (r - 1) / P, p = (r - 1) % P;
      valid = p < np;
      src = pin + ((int64_t)i * n + g0 + (valid ? p : 0)) * 3 * D;
    }
    if (DIRECT) {
      cp_async16(KV + (size_t)r * W2 + c * 8, src + D + c * 8, valid);
    } else {
      const int kv = c >= HG * HP, hh = (c - kv * HG * HP) / HP, cc = c % HP;
      valid = valid && cc < cpr;
      cp_async16(KV + (size_t)r * W2 + c * 8,
                 valid ? src + (1 + kv) * D + (h0 + hh) * dh + cc * 8 : qkv_c, valid);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int quad = lane / 4, part = lane % 4;
  float* ps = ps_all + (warp * 8 + quad) * (f + 1);
  // queries i0 .. i0 + 7 (frames) of (position, head) item
  auto queries = [&](int item, int i0) {
    const int p = item / HG, hh = item % HG;
    const int scol = hh * DHP + part * C;           // the lane's staged columns
    const int gcol = (h0 + hh) * dh + part * C;     // and in device memory
    {
      const int i = i0 + quad;
      const bool live = i < f;
      const int64_t tok = (int64_t)(live ? i : 0) * n + g0 + p;
      float q[C];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const bool in = live && part * C + 8 * v < dh;
        const uint4 raw = in ? __ldg(reinterpret_cast<const uint4*>(pin + tok * 3 * D + gcol) + v)
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
        const uint4* kr = reinterpret_cast<const uint4*>(KV + (size_t)r * W2 + scol);
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
          const uint4* vr = reinterpret_cast<const uint4*>(KV + (size_t)r * W2 + W + scol);
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
        uint4* orow = reinterpret_cast<uint4*>(pout + tok * D + gcol);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          if (part * C + 8 * v >= dh) continue;
          uint4 w;
          uint32_t* wp = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
          for (int u = 0; u < 4; ++u) wp[u] = tc::pack_bf16(o[8 * v + 2 * u], o[8 * v + 2 * u + 1]);
          orow[v] = w;
        }
      }
      __syncwarp();
    }
  };
  if (DIRECT) {  // each warp its items, 8 queries at a time
    for (int item = warp; item < np * HG; item += WARPS)
      for (int i0 = 0; i0 < f; i0 += 8) queries(item, i0);
  } else {  // (item, 8 queries) units: a warp for each 8 frames where a block holds few heads
    const int q8 = (f + 7) / 8;
    for (int unit = warp; unit < np * HG * q8; unit += WARPS) queries(unit / q8, unit % q8 * 8);
  }
}

constexpr int CLS_THREADS = 256;
constexpr int KEYS_IN_FLIGHT = 4;  // loads a CLS-row warp starts before it sums

// CLS query of (b, h) over [CLS; all f*n patches]; D = H * dh, dh <= DHP
// (EXACT: dh == DHP, compiled as a constant).
template <int DHP, bool EXACT>
__global__ void __launch_bounds__(CLS_THREADS)
cls_row_kernel(const bf16* __restrict__ qkv_p, const bf16* __restrict__ qkv_c,
               bf16* __restrict__ out_c, int fn, int H, int dh_arg, int in_p, int in_c,
               int out_cs, float scale) {
  constexpr int NP = (DHP / 2 + 31) / 32;  // bf16 pairs of a row per lane, at most
  extern __shared__ __align__(16) unsigned char smem[];
  const int dh = EXACT ? DHP : dh_arg;
  const int h = blockIdx.x, b = blockIdx.y;
  const int D = H * dh;
  const int nk = fn + 1;
  float* qs = reinterpret_cast<float*>(smem);        // DHP
  float* red = qs + DHP;                              // 32
  float* acc = red + 32;                              // (CLS_THREADS / 32) x DHP
  float* ps = acc + (CLS_THREADS / 32) * DHP;         // nk
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const bf16* crow = qkv_c + (int64_t)b * in_c * 3 * D;
  const bf16* prow0 = qkv_p + (int64_t)b * in_p * 3 * D;

  if (tid < DHP) qs[tid] = tid < dh ? sft::bf16r(__bfloat162float(crow[h * dh + tid]) * scale) : 0.f;
  __syncthreads();

  float m = -INFINITY;
  for (int j = tid; j < nk; j += CLS_THREADS) {
    const bf16* row = j == 0 ? crow : prow0 + (int64_t)(j - 1) * 3 * D;
    const float s = sft::dot_row_bf16<DHP>(qs, row + D + h * dh, dh);
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
    if (t < dh / 2) {
      float a0 = 0.f, a1 = 0.f;
      constexpr int STEP = CLS_THREADS / 32;
      for (int j0 = warp; j0 < nk; j0 += STEP * KEYS_IN_FLIGHT) {
        float2 v[KEYS_IN_FLIGHT];
#pragma unroll
        for (int k = 0; k < KEYS_IN_FLIGHT; ++k) {
          const int j = j0 + k * STEP;
          const bf16* row = j == 0 ? crow : prow0 + (int64_t)(j - 1) * 3 * D;
          v[k] = j < nk ? __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(
                              row + 2 * D + h * dh)[t])
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
      acc[warp * DHP + 2 * t] = a0;
      acc[warp * DHP + 2 * t + 1] = a1;
    }
  }
  __syncthreads();
  if (tid < dh) {
    float s = 0.f;
    for (int w = 0; w < CLS_THREADS / 32; ++w) s += acc[w * DHP + tid];
    out_c[(int64_t)b * out_cs * D + h * dh + tid] = __float2bfloat16(s);
  }
}

// key tiles of a space-mode chunk at width DHP: one sweep up to 207 patches
// a frame at widths up to 128; fewer at 192 and 256, which shared memory and
// registers bound
__host__ __device__ constexpr int space_kt(int DHP) { return DHP <= 128 ? 13 : (DHP <= 192 ? 8 : 6); }

// The attention of every patch (space: the tensor-core kernel; time:
// time_attention_kernel) and of the CLS row at width DHP >= dh. Row strides
// between segments: in_p / in_c of the patch / CLS rows of qkv, out_p /
// out_c of the outputs.
template <int DHP>
int launch_attention(const bf16* qkv_p, const bf16* qkv_c, bf16* attn_p, bf16* out_c, int B,
                     int f, int n, int H, int dh, int mode, int in_p, int in_c, int out_p,
                     int out_cs, cudaStream_t s) {
  const int fn = f * n;
  const float scale = (float)pow((double)dh, -0.5);
  if (mode == 0) {
    const tc::Problem p{qkv_p, qkv_c, attn_p, in_p, in_c, out_p, n, n, H, dh, 0, 0, 0, scale};
    const int err = tc::launch<DHP, space_kt(DHP), true>(p, f, B, s);
    if (err != 0) return err;
  } else {
    const TimePlan tp = time_plan(f, H, DHP);
    if (tp.smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
    auto kern = dh == DHP && tp.HG == H ? time_attention_kernel<DHP, true>
                                        : time_attention_kernel<DHP, false>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)tp.smem);
    SFT_CHECK_LAUNCH();
    kern<<<dim3((n + tp.P - 1) / tp.P, B, H / tp.HG), TIME_THREADS, tp.smem, s>>>(
        qkv_p, qkv_c, attn_p, f, n, H, dh, tp.HG, tp.P, in_p, in_c, out_p, scale);
    SFT_CHECK_LAUNCH();
  }
  const size_t smem_c = (DHP + 32 + (CLS_THREADS / 32) * DHP + (size_t)(fn + 1)) * sizeof(float);
  auto cls = dh == DHP ? cls_row_kernel<DHP, true> : cls_row_kernel<DHP, false>;
  cudaFuncSetAttribute(cls, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_c);
  SFT_CHECK_LAUNCH();
  cls<<<dim3(H, B), CLS_THREADS, smem_c, s>>>(qkv_p, qkv_c, out_c, fn, H, dh, in_p, in_c,
                                              out_cs, scale);
  SFT_CHECK_LAUNCH();
  return 0;
}

// launch_attention at tc::padded_width(dh); a dh that is not a multiple of
// 8 or is above 256 is refused (the wrappers refuse it before they launch).
inline int dispatch_attention(int dh, const bf16* qkv_p, const bf16* qkv_c, bf16* attn_p,
                              bf16* out_c, int B, int f, int n, int H, int mode, int in_p,
                              int in_c, int out_p, int out_cs, cudaStream_t s) {
#define SFT_ATTN(W)                                                                            \
  case W:                                                                                      \
    return launch_attention<W>(qkv_p, qkv_c, attn_p, out_c, B, f, n, H, dh, mode, in_p, in_c, \
                               out_p, out_cs, s)
  switch (tc::padded_width(dh)) {
    SFT_ATTN(32);
    SFT_ATTN(64);
    SFT_ATTN(96);
    SFT_ATTN(128);
    SFT_ATTN(192);
    SFT_ATTN(256);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SFT_ATTN
}

}  // namespace attn
}  // namespace sft
