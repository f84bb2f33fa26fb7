// K1: divided space-time attention on the split (CLS, patches) layout with
// the output projection and residual in the epilogue; K5: the same
// attention without them; K7a/K7b: the same attention on the packed layout.
//
// K1 replaces synchformer_tpu/ops/pallas/divided_attention.py::
// divided_attention_proj_4d (body _kernel_4d_proj with _cls_row_4d,
// _space_pair_v3, _time_pair_v3); K5 replaces divided_attention_pallas_4d
// (body _kernel_4d), the forward of the Stage I training step; K7a replaces
// divided_attention_pallas (body _kernel with _cls_row, _space_segment,
// _time_block_mxu), the forward of the Motionformer's packed flow, and K7b
// its v3 body (_divided_attention_pallas_v3, _kernel_v3), the same function
// at 128-lane-groupable heads. K5 and K7 run launches (1) and (2) below and
// write the attention straight to their output; the bound at Stage I's
// 28 segments is the ~270 MB they move.
//
// Layouts. Split: patches (B, f, n, 3D) and CLS (B, 1, 3D), outputs (B, f, n,
// D) and (B, 1, D). Packed: one (B, 1 + f*n, 3D) tensor, the CLS row first in
// each segment, output (B, 1 + f*n, D). Both are read and written in place:
// the kernels take a patch base and a CLS base per tensor and the number of
// rows from one segment to the next (split: f*n for patches, 1 for the CLS;
// packed: 1 + f*n for both, the patch base one row after the CLS base).
//
// Semantics, per head (any head_dim dh that is a multiple of 8 up to 256,
// run at the least width of divided_attention.cuh's WIDTHS that holds it),
// q scaled by dh^-0.5 and rounded to bf16:
// - each patch token attends {CLS} U its group: the n tokens of its frame
//   (space, n + 1 keys) or the f tokens at its spatial position (time, f + 1);
// - the CLS query attends all 1 + f*n keys;
// - f32 logits and softmax; in space mode exp(s - m) is rounded to bf16
//   unnormalised, the CLS key's term stays f32 and the row is divided once
//   (the TPU kernels' _space_segment / _space_pair_v3); in time mode and for
//   the CLS row the normalised probabilities are rounded to bf16 before P @ V;
// - K1 patches: y = res + (attn @ Wo^T + bo), rounded once; the CLS row leaves
//   un-projected.
//
// Three launches, (1) and (2) in divided_attention.cuh, which K8a
// (csrc/fused_block.cu) shares. (1) group attention: in space mode the
// tensor-core kernel of mma_attention.cuh (blocks of up to 8 query tiles of
// 16 rows over a frame's [CLS; n] keys staged by cp.async, both products on
// mma.sync); in time mode (9 keys a group) one block per tile of P spatial
// positions and segment, all heads, its key / value rows staged by 16-byte
// cp.async, four lanes a query on CUDA cores (bound by memory). (2) the CLS
// row: one block per (head, batch) over all 1 + f*n keys, a thread per key
// row for the logits (16-byte loads), a warp per key for P @ V (a few keys'
// loads in flight). It stays its own launch: the recipe normalises the CLS
// query's softmax over all 1 + f*n keys before rounding the probabilities to
// bf16, so a split softmax folded into (1) would round at another place.
// (3) K1 only: the projection + residual on the Hopper GEMM of
// wgmma_gemm.cuh (EPI_BIAS_RESIDUAL). The TPU kernel keeps the attention
// output in VMEM before the projection; here it round-trips device memory
// (2 x 270 MB per call at B=112, about 0.16 ms), which a later fused epilogue
// removes.
#include "divided_attention.cuh"
#include "wgmma_gemm.cuh"

using sft::bf16;
using sft::attn::dispatch_attention;

// K1. mode 0 = space (groups are frames), 1 = time (groups are spatial
// positions). Any D = H * dh (dh a multiple of 8): the projection GEMM takes
// a D that is not a multiple of 128 on its tail epilogue.
extern "C" int sft_divided_attention_proj(const void* qkv_p, const void* qkv_c,
                                          const void* res, const void* wo, const void* bo,
                                          void* attn_scratch, void* out_p, void* out_c,
                                          int B, int f, int n, int H, int dh, int mode,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int D = H * dh, fn = f * n;
  const int err = dispatch_attention(dh, static_cast<const bf16*>(qkv_p),
                                     static_cast<const bf16*>(qkv_c),
                                     static_cast<bf16*>(attn_scratch), static_cast<bf16*>(out_c),
                                     B, f, n, H, mode, fn, 1, fn, 1, s);
  if (err != 0) return err;
  return sft::wgmma_gemm<sft::EPI_BIAS_RESIDUAL>(
      static_cast<const bf16*>(attn_scratch), static_cast<const bf16*>(wo),
      static_cast<const float*>(bo), static_cast<const bf16*>(res), D,
      static_cast<bf16*>(out_p), (long long)B * fn, D, D, s);
}

// K5: the attention without the projection on the split layout: out_p
// (B, f, n, D) and out_c (B, 1, D), the outputs of divided_attention_pallas_4d.
extern "C" int sft_divided_attention(const void* qkv_p, const void* qkv_c, void* out_p,
                                     void* out_c, int B, int f, int n, int H, int dh,
                                     int mode, void* stream) {
  const int fn = f * n;
  return dispatch_attention(dh, static_cast<const bf16*>(qkv_p),
                            static_cast<const bf16*>(qkv_c), static_cast<bf16*>(out_p),
                            static_cast<bf16*>(out_c), B, f, n, H, mode, fn, 1, fn, 1,
                            static_cast<cudaStream_t>(stream));
}

// K7a / K7b: the same attention on the packed layout, qkv (B, 1 + f*n, 3D) ->
// out (B, 1 + f*n, D), the output of divided_attention_pallas.
extern "C" int sft_divided_attention_packed(const void* qkv, void* out, int B, int f, int n,
                                            int H, int dh, int mode, void* stream) {
  const int seq = 1 + f * n, D = H * dh;
  const bf16* q = static_cast<const bf16*>(qkv);
  bf16* o = static_cast<bf16*>(out);
  return dispatch_attention(dh, q + 3 * D, q, o + D, o, B, f, n, H, mode, seq, seq, seq, seq,
                            static_cast<cudaStream_t>(stream));
}
