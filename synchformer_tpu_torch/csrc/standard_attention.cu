// K3: unmasked full-softmax multi-head self-attention read straight from the
// packed (B, N, [q|k|v]) projection; output (B, N, D) in head-major order.
//
// Replaces synchformer_tpu/ops/pallas/standard_attention.py::
// _standard_attention_pallas (body _kernel). On the main path it runs the
// AST encoder's 12 layers at B=112, N=74, 12 heads of 64: 1.9 GFLOP and
// 51 MB a call, bound by the bytes (15 us at 3.35 TB/s). The first port ran
// its products on CUDA cores, one query row a warp (0.243 ms, 8 TFLOP/s).
// Here it is the tensor-core kernel of mma_attention.cuh: mma.sync with 16-row
// tiles (74 tokens pad to 80), one block per (batch row, head) with a warp per
// query tile (5 warps at N=74), so that each block stages only 28 KB and several
// blocks share an SM, hiding each other's staging. Up to 80 tokens the
// softmax takes one sweep; longer sequences a second sweep over 80-key
// chunks with the same normalised numerics.
//
// Numerics (standard_attention.py:44-57): q scaled by 1/8 (exact in bf16),
// f32 logits, the softmax normalised in f32 and rounded to bf16, P @ V
// summed in f32.
#include "mma_attention.cuh"

using sft::bf16;

namespace {

constexpr int DH = 64;
constexpr int KT = 5;  // 80 keys a chunk: the AST's 74 tokens in one sweep

}  // namespace

extern "C" int sft_standard_attention(const void* qkv, void* out, int B, int N, int H,
                                      int dh, void* stream) {
  if (dh != DH) return (int)cudaErrorInvalidValue;
  const sft::tc::Problem p{static_cast<const bf16*>(qkv), nullptr, static_cast<bf16*>(out),
                           N, 0, N, 0, N, H, 0, 0, 0, 0.125f};
  return sft::tc::launch<DH, KT, false>(p, 1, B, static_cast<cudaStream_t>(stream));
}
