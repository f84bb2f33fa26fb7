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
// Any head_dim dh that is a multiple of 8 up to 256 (the JAX layer reaches
// K3 at every head layout that pairs into 128 lanes: 16, 32, 64, 128, 256),
// run at the least width that holds it (mma_attention.cuh's padded_width:
// the columns past dh are staged as zeros, nothing of the next head is
// read).
// And any N: a block holds at most 8 query tiles (the grid's x dimension
// grows with N, H * ceil(N / 128) blocks), its shared memory is fixed by
// the width and the 80-key chunk, and past 80 tokens the softmax takes two
// sweeps over the chunks. Nothing in the kernel set the 1024-token limit the
// wrapper once had; the AudioSet AST's 1024 mel frames make 1214 tokens.
//
// Numerics (standard_attention.py:44-57): q scaled by dh^-0.5 in f32 and
// rounded to bf16 (1/8, exact, at 64), f32 logits, the softmax normalised
// in f32 and rounded to bf16, P @ V summed in f32.
#include <math.h>

#include "mma_attention.cuh"

using sft::bf16;

namespace {

constexpr int KT = 5;  // 80 keys a chunk: the AST's 74 tokens in one sweep

template <int W>
int launch_width(const void* qkv, void* out, int B, int N, int H, int dh, cudaStream_t s) {
  const float scale = (float)pow((double)dh, -0.5);
  const sft::tc::Problem p{static_cast<const bf16*>(qkv), nullptr, static_cast<bf16*>(out),
                           N, 0, N, 0, N, H, dh, 0, 0, 0, scale};
  return sft::tc::launch<W, KT, false>(p, 1, B, s);
}

}  // namespace

extern "C" int sft_standard_attention(const void* qkv, void* out, int B, int N, int H,
                                      int dh, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (sft::tc::padded_width(dh)) {
    case 32:
      return launch_width<32>(qkv, out, B, N, H, dh, s);
    case 64:
      return launch_width<64>(qkv, out, B, N, H, dh, s);
    case 96:
      return launch_width<96>(qkv, out, B, N, H, dh, s);
    case 128:
      return launch_width<128>(qkv, out, B, N, H, dh, s);
    case 192:
      return launch_width<192>(qkv, out, B, N, H, dh, s);
    case 256:
      return launch_width<256>(qkv, out, B, N, H, dh, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
