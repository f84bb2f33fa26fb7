// The fused_rows kernels. K2 and K8b: x + fc2(GELU(fc1(LN(x)))) over
// flattened rows (K2 optionally with per-row f32 [mean, meansq, 0 x 6]
// statistics of the bf16 output). K8c: LN(x) @ W^T + b.
//
// K2 replaces synchformer_tpu/ops/pallas/fused_rows.py::_ln_mlp_pallas_slab
// / _ln_mlp_pallas (bodies _ln_mlp_slab_kernel, _ln_mlp_kernel), K8b
// synchformer_tpu/ops/pallas/fused_block.py::_fused_mlp_pallas (body
// _fused_mlp_kernel). One entry, four launches: LN (ln_rows), fc1 + bias +
// GELU and fc2 + bias + residual on the Hopper GEMM of wgmma_gemm.cuh (TMA,
// wgmma, persistent), then the row statistics (row_stats, K2 only). The GELU
// is K2's exact erf, or for K8b the TPU kernel's clamped degree-9 erf
// polynomial (|err| <= 3e-5) in f32 rounded to bf16 once. At the video
// tower's shape (175616 rows, 768 -> 3072 -> 768) the two GEMMs are 1.66
// TFLOP (830 GFLOP each) and bound by the tensor cores.
//
// The TPU kernels keep the LN output and the (rows, 4D) fc1 activation in
// VMEM; here both pass through device memory. The LN output costs one pass
// over the rows (2 x 270 MB at that shape). Normalising the A tiles on chip
// instead, in the GEMM, redoes that work for every output column tile (12
// times at fc1), on the CUDA cores of the warps that run wgmma, and it did
// not overlap their products: built both ways (in place in the TMA-staged
// tile, and in registers as wgmma's A fragments), K2 took 3.83-3.89 and
// 4.12-4.15 ms a call against 3.29-3.52 with this pass, on an NVIDIA H100
// 80GB HBM3 at 700 W (PERF.md).
// The activation (2 x 1.08 GB, about 0.64 ms at 3.35 TB/s) stays in device
// memory because a 128-row slab of it (768 KB in bf16) fits neither one
// block's shared memory (227 KB) nor its registers, so fc2 cannot take it
// from fc1 on chip without splitting the hidden dimension across blocks; a
// single launch that streamed all of W1 and W2 (9.4 MB) through every 64-row
// block would read about 26 GB from L2 a call, more than the round trip
// (thread-block clusters with TMA multicast of the W tiles would change
// that: ROADMAP).
//
// K8c replaces synchformer_tpu/ops/pallas/fused_rows.py::_ln_matmul_pallas
// (body _ln_matmul_kernel) with the first two launches of K8a
// (fused_block.cu): ln_rows, then the Hopper GEMM with EPI_BIAS, f32
// accumulation, the bias added in f32 and the sum rounded once. At the QKV
// shape (175728 rows, 768 -> 2304) it is 621.9 GFLOP, bound by the tensor
// cores.
#include "wgmma_gemm.cuh"

using sft::bf16;

// K2 (poly == 0) and K8b (poly == 1). ln_buf: (rows, d) bf16 scratch for the
// LN output, h_buf (rows, hidden) bf16 for the activation; stats (rows, 8)
// f32 or null. Needs d % 64 == 0 and hidden % 64 == 0 (the Hopper GEMM's N
// and K).
extern "C" int sft_ln_mlp(const void* x, const void* g, const void* b, const void* w1,
                          const void* b1, const void* w2, const void* b2, void* ln_buf,
                          void* h_buf, void* out, void* stats, long long rows, int d,
                          int hidden, float eps, int poly, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* ln = static_cast<const bf16*>(ln_buf);
  bf16* h = static_cast<bf16*>(h_buf);
  sft::ln_rows(xb, nullptr, static_cast<const float*>(g), static_cast<const float*>(b),
               static_cast<bf16*>(ln_buf), rows, d, eps, s);
  SFT_CHECK_LAUNCH();
  const bf16* w1b = static_cast<const bf16*>(w1);
  const float* b1f = static_cast<const float*>(b1);
  int err = poly ? sft::wgmma_gemm<sft::EPI_BIAS_GELU_POLY>(ln, w1b, b1f, nullptr, 0, h, rows,
                                                            hidden, d, s)
                 : sft::wgmma_gemm<sft::EPI_BIAS_GELU>(ln, w1b, b1f, nullptr, 0, h, rows,
                                                       hidden, d, s);
  if (err != 0) return err;
  err = sft::wgmma_gemm<sft::EPI_BIAS_RESIDUAL>(
      h, static_cast<const bf16*>(w2), static_cast<const float*>(b2), xb, d,
      static_cast<bf16*>(out), rows, d, hidden, s);
  if (err != 0) return err;
  if (stats != nullptr) {
    sft::row_stats(static_cast<const bf16*>(out), static_cast<float*>(stats), rows, d, s);
    SFT_CHECK_LAUNCH();
  }
  return 0;
}

// K8c. ln_buf: (rows, d) bf16 scratch for the LN output. Needs d % 32 == 0
// and n_out % 64 == 0 (the Hopper GEMM's K and N).
extern "C" int sft_ln_matmul(const void* x, const void* g, const void* b, const void* w,
                             const void* bias, void* ln_buf, void* out, long long rows, int d,
                             int n_out, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  sft::ln_rows(static_cast<const bf16*>(x), nullptr, static_cast<const float*>(g),
               static_cast<const float*>(b), static_cast<bf16*>(ln_buf), rows, d, eps, s);
  SFT_CHECK_LAUNCH();
  return sft::wgmma_gemm<sft::EPI_BIAS>(static_cast<const bf16*>(ln_buf),
                                        static_cast<const bf16*>(w),
                                        static_cast<const float*>(bias), nullptr, 0,
                                        static_cast<bf16*>(out), rows, n_out, d, s);
}
