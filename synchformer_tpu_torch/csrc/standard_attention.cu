// K3: unmasked full-softmax multi-head self-attention read straight from the
// packed (B, N, [q|k|v]) projection; output (B, N, D) in head-major order.
//
// Replaces synchformer_tpu/ops/pallas/standard_attention.py::
// _standard_attention_pallas (body _kernel). On the main path it runs the
// AST encoder's 12 layers at B=112, N=74, 12 heads of 64: 1.2 GFLOP and
// 38 MB read per call, so it is bound by latency and launch width, not by
// the tensor cores. One block per (batch, head) stages that head's K and V
// (74 x 64 each) in shared memory with a padded row pitch (no bank
// conflicts) and each warp walks query rows: logits with one key per lane,
// an f32 softmax by warp shuffles, probabilities rounded to bf16 as in the
// reference, then P @ V with two output columns per lane. The ragged N needs
// no padding: every loop is bounded by N.
#include "tile_gemm.cuh"

using sft::bf16;

namespace {

constexpr int DH = 64;
constexpr int PITCH = DH + 2;  // bf16 elements; 33 words per row
constexpr int WARPS = 4;

__global__ void __launch_bounds__(WARPS * 32)
standard_attention_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int N,
                          int H, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int D = H * DH;
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + N * PITCH;
  float* qs_all = reinterpret_cast<float*>(Vs + N * PITCH);
  float* ps_all = qs_all + WARPS * DH;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const bf16* base = qkv + (int64_t)b * N * 3 * D;

  for (int idx = tid; idx < N * (DH / 2); idx += blockDim.x) {
    const int r = idx / (DH / 2), t = idx % (DH / 2);
    const bf16* row = base + (int64_t)r * 3 * D;
    reinterpret_cast<__nv_bfloat162*>(Ks + r * PITCH)[t] =
        reinterpret_cast<const __nv_bfloat162*>(row + D + h * DH)[t];
    reinterpret_cast<__nv_bfloat162*>(Vs + r * PITCH)[t] =
        reinterpret_cast<const __nv_bfloat162*>(row + 2 * D + h * DH)[t];
  }
  __syncthreads();

  float* qs = qs_all + warp * DH;
  float* ps = ps_all + warp * N;
  for (int i = warp; i < N; i += WARPS) {
    const bf16* qrow = base + (int64_t)i * 3 * D + h * DH;
    for (int d = lane; d < DH; d += 32) qs[d] = sft::bf16r(__bfloat162float(qrow[d]) * scale);
    __syncwarp();
    float m = -INFINITY;
    for (int j = lane; j < N; j += 32) {
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
    for (int j = lane; j < N; j += 32) {
      const float e = __expf(ps[j] - m);
      ps[j] = e;
      sum += e;
    }
    sum = sft::warp_sum(sum);
    const float inv = 1.f / sum;
    for (int j = lane; j < N; j += 32) ps[j] = sft::bf16r(ps[j] * inv);
    __syncwarp();
    float a0 = 0.f, a1 = 0.f;
    for (int j = 0; j < N; ++j) {
      const float2 v = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(Vs + j * PITCH)[lane]);
      a0 += ps[j] * v.x;
      a1 += ps[j] * v.y;
    }
    reinterpret_cast<__nv_bfloat162*>(out + ((int64_t)b * N + i) * D + h * DH)[lane] =
        __floats2bfloat162_rn(a0, a1);
    __syncwarp();
  }
}

}  // namespace

extern "C" int sft_standard_attention(const void* qkv, void* out, int B, int N, int H,
                                      int dh, void* stream) {
  if (dh != DH) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)N * PITCH * sizeof(bf16) + (size_t)WARPS * (DH + N) * sizeof(float);
  cudaFuncSetAttribute(standard_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  SFT_CHECK_LAUNCH();
  dim3 grid(H, B);
  standard_attention_kernel<<<grid, WARPS * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(out), N, H, (float)(1.0 / 8.0));
  SFT_CHECK_LAUNCH();
  return 0;
}
