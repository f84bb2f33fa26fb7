// The Hopper GEMM of wgmma_gemm.cuh on its own: C = epilogue(A @ W^T + bias),
// for checking and timing it apart from K1, K2 and K8a-K8c, which call it
// from their own entries (ln_mlp.cu, divided_attention.cu, fused_block.cu).
// No model path calls this entry.
#include "wgmma_gemm.cuh"

using sft::bf16;

// epi: 0 bias, 1 bias + GELU, 2 bias + residual (r, row stride r_stride), 3
// bias + the polynomial GELU.
extern "C" int sft_gemm(const void* a, const void* w, const void* bias, const void* r,
                        long long r_stride, void* c, long long m, int n, int k, int epi,
                        void* stream) {
  const bf16* A = static_cast<const bf16*>(a);
  const bf16* W = static_cast<const bf16*>(w);
  const float* b = static_cast<const float*>(bias);
  const bf16* R = static_cast<const bf16*>(r);
  bf16* C = static_cast<bf16*>(c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (epi) {
    case sft::EPI_BIAS:
      return sft::wgmma_gemm<sft::EPI_BIAS>(A, W, b, nullptr, 0, C, m, n, k, s);
    case sft::EPI_BIAS_GELU:
      return sft::wgmma_gemm<sft::EPI_BIAS_GELU>(A, W, b, nullptr, 0, C, m, n, k, s);
    case sft::EPI_BIAS_RESIDUAL:
      return sft::wgmma_gemm<sft::EPI_BIAS_RESIDUAL>(A, W, b, R, r_stride, C, m, n, k, s);
    case sft::EPI_BIAS_GELU_POLY:
      return sft::wgmma_gemm<sft::EPI_BIAS_GELU_POLY>(A, W, b, nullptr, 0, C, m, n, k, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
