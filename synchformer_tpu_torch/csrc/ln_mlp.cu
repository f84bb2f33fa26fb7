// The fused_rows kernels. K2: x + fc2(GELU(fc1(LN(x)))) over flattened
// rows, with optional per-row f32 [mean, meansq, 0 x 6] statistics of the
// bf16 output. K8c: LN(x) @ W^T + b.
//
// Replaces synchformer_tpu/ops/pallas/fused_rows.py::_ln_mlp_pallas_slab /
// _ln_mlp_pallas (bodies _ln_mlp_slab_kernel, _ln_mlp_kernel). Four launches:
// LN (ln_rows), fc1 + bias + GELU and fc2 + bias + residual on the Hopper
// GEMM of wgmma_gemm.cuh (TMA, wgmma, persistent; redesigned from the WMMA
// tile GEMM), then the row statistics (row_stats). At the video tower's shape
// (175616 rows, 768 -> 3072 -> 768) the two GEMMs are 1.66 TFLOP (830 GFLOP
// each) and bound by the tensor cores. The TPU kernel keeps the LN output and
// the (rows, 4D) fc1 activation in VMEM; here both pass through device memory
// (the activation 2 x 1.08 GB, about 0.64 ms at 3.35 TB/s): a 128-row slab of
// the 3072-wide activation (768 KB in bf16) fits neither one block's shared
// memory (227 KB) nor its registers, so fc2 cannot take it from fc1 on chip
// without splitting the hidden dimension across blocks.
//
// K8c replaces synchformer_tpu/ops/pallas/fused_rows.py::_ln_matmul_pallas
// (body _ln_matmul_kernel) and stays on the WMMA tile GEMM: the LayerNorm is
// applied to each A tile as the tile GEMM stages it (gemm_ln_bf16), f32
// accumulation, the bias added in f32 and the sum rounded once, so the
// normalised rows never reach device memory. The row statistics come from a
// pre-pass (ln_stats: one read of x, 8 bytes a row out) rather than from each
// column tile's CTA, which would re-read every row once per 64 output columns
// (36 times at 768 -> 2304). At the QKV shape (175728 rows, 768 -> 2304) it is
// 621.9 GFLOP, bound by the tensor cores.
#include "wgmma_gemm.cuh"

using sft::bf16;

// K2. Needs d % 128 == 0 and hidden % 128 == 0 (the Hopper GEMM's N and K).
extern "C" int sft_ln_mlp(const void* x, const void* g, const void* b, const void* w1,
                          const void* b1, const void* w2, const void* b2, void* ln_buf,
                          void* h_buf, void* out, void* stats, long long rows, int d,
                          int hidden, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  sft::ln_rows(xb, nullptr, static_cast<const float*>(g), static_cast<const float*>(b),
               static_cast<bf16*>(ln_buf), rows, d, eps, s);
  SFT_CHECK_LAUNCH();
  int err = sft::wgmma_gemm<sft::EPI_BIAS_GELU>(
      static_cast<const bf16*>(ln_buf), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), nullptr, 0, static_cast<bf16*>(h_buf), rows, hidden, d, s);
  if (err != 0) return err;
  err = sft::wgmma_gemm<sft::EPI_BIAS_RESIDUAL>(
      static_cast<const bf16*>(h_buf), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), xb, d, static_cast<bf16*>(out), rows, d, hidden, s);
  if (err != 0) return err;
  if (stats != nullptr) {
    sft::row_stats(static_cast<const bf16*>(out), static_cast<float*>(stats), rows, d, s);
    SFT_CHECK_LAUNCH();
  }
  return 0;
}

// K8c. stats: (rows) float2 scratch for [mean, rstd]. Needs d % 32 == 0,
// n_out % 64 == 0.
extern "C" int sft_ln_matmul(const void* x, const void* g, const void* b, const void* w,
                             const void* bias, void* stats, void* out, long long rows, int d,
                             int n_out, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  sft::ln_stats(xb, static_cast<float2*>(stats), rows, d, eps, s);
  SFT_CHECK_LAUNCH();
  sft::gemm_ln_bf16(xb, static_cast<const bf16*>(w), static_cast<const float*>(bias),
                    static_cast<bf16*>(out), (int)rows, n_out, d,
                    sft::LnPrologue{static_cast<const float2*>(stats),
                                    static_cast<const float*>(g), static_cast<const float*>(b)},
                    s);
  SFT_CHECK_LAUNCH();
  return 0;
}
