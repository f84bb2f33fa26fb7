// K8a: LayerNorm -> QKV projection -> packed divided attention, the
// attn_impl='pallas_fused' route of the Motionformer's packed flow. (K8b, the
// route's LN + MLP + residual, is K2's entry with the polynomial GELU:
// ln_mlp.cu.)
//
// K8a replaces synchformer_tpu/ops/pallas/fused_block.py::
// _fused_attention_pallas (body _fused_attn_kernel). Four launches: (1)
// ln_rows, the LayerNorm of x into a (B, 1 + f*n, D) bf16 scratch (f32
// statistics and affine, one rounding); (2) the Hopper GEMM of
// wgmma_gemm.cuh (TMA, wgmma, persistent grid) with EPI_BIAS into a (B, 1 +
// f*n, 3D) bf16 qkv scratch (f32 accumulation, the bias in f32, one
// rounding); then (3) and (4), the group and CLS-row launches of K7a
// (divided_attention.cuh). The TPU kernel keeps four segments' LN output and
// qkv in a 29 MB VMEM scratch; here both pass through device memory, the qkv
// 810 MB a call at B*S = 112, D = 768 (about 0.48 ms of traffic at 3.35
// TB/s), because no SM holds what one attention group needs: the CLS query
// of each head attends all 1 + f*n keys, a time group spans every frame, and
// one frame's qkv for all heads (196 x 2304 bf16, 903 KB) is four times an
// SM's shared memory. The LN output (2 x 270 MB) costs less than normalising
// x's tiles inside the GEMM, which redoes the LayerNorm for every one of the
// 9 output column tiles (ln_mlp.cu, PERF.md). The space mode runs on the
// tensor cores with the TPU kernels' recipe (mma_attention.cuh); the time
// mode rounds the normalised probabilities to bf16 and sums P @ V in f32, as
// the XLA composition does, where the TPU body's _time_block rounds each exp
// * v product to bf16 before its f32 sum. The two agree in f32. At the
// serving shape (112, 1569, 768), 8 heads of 96, the QKV product is 621.9
// GFLOP and the space attention 106.8 GFLOP (time 5.4): bound by the tensor
// cores. K8c (ln_mlp.cu::sft_ln_matmul) is launches (1) and (2) alone.
#include "divided_attention.cuh"
#include "wgmma_gemm.cuh"

using sft::bf16;

// K8a. x (B, 1 + f*n, D) -> out (B, 1 + f*n, D) before the projection;
// w (3D, D) packed [q; k; v] rows; scratch: ln (B, 1 + f*n, D) and qkv (B,
// 1 + f*n, 3D) bf16. mode 0 = space, 1 = time. Any D = H * dh, dh a
// multiple of 8 up to 256.
extern "C" int sft_fused_divided_attention(const void* x, const void* g, const void* b,
                                           const void* w, const void* bias, void* ln,
                                           void* qkv, void* out, int B, int f, int n, int H,
                                           int dh, int mode, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int seq = 1 + f * n, D = H * dh;
  const int64_t rows = (int64_t)B * seq;
  bf16* lb = static_cast<bf16*>(ln);
  bf16* q = static_cast<bf16*>(qkv);
  bf16* o = static_cast<bf16*>(out);
  sft::ln_rows(static_cast<const bf16*>(x), nullptr, static_cast<const float*>(g),
               static_cast<const float*>(b), lb, rows, D, eps, s);
  SFT_CHECK_LAUNCH();
  const int err = sft::wgmma_gemm<sft::EPI_BIAS>(lb, static_cast<const bf16*>(w),
                                                 static_cast<const float*>(bias), nullptr, 0, q,
                                                 rows, 3 * D, D, s);
  if (err != 0) return err;
  return sft::attn::dispatch_attention(dh, q + 3 * D, q, o + D, o, B, f, n, H, mode, seq, seq,
                                       seq, seq, s);
}
