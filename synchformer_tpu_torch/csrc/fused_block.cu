// K8a: LayerNorm -> QKV projection -> packed divided attention; K8b: x +
// fc2(GELU(fc1(LN(x)))) in one launch. The attn_impl='pallas_fused' route of
// the Motionformer's packed flow.
//
// K8a replaces synchformer_tpu/ops/pallas/fused_block.py::
// _fused_attention_pallas (body _fused_attn_kernel). On the TPU the LN, the
// QKV product and the attention of four segments share one 29 MB VMEM
// scratch. An SM has 228 KB, the CLS query of each head attends all 1 + f*n
// keys and each time group spans every frame, so this first port passes the
// (B, 1 + f*n, 3D) qkv through device memory (810 MB a call at B*S = 112,
// D = 768): (1) ln_stats and (2) the tile GEMM with the LayerNorm applied as
// it stages x (gemm_ln_bf16, K8c's code: f32 accumulation, bias in f32, one
// rounding), then (3) and (4), the group and CLS-row launches of K7a
// (divided_attention.cuh). Its space mode runs on the tensor cores with the
// TPU kernels' recipe (mma_attention.cuh); its time mode rounds the
// normalised probabilities to bf16 and sums P @ V in f32, as the XLA
// composition does, where the TPU body's _time_block rounds each exp * v
// product to bf16 before its f32 sum. The two agree in f32. At the serving
// shape (112, 1569, 768), 8 heads of 96, the QKV product is 621.9 GFLOP and
// the space attention 106.8 GFLOP (time 5.4): bound by the tensor cores.
//
// K8b replaces _fused_mlp_pallas (body _fused_mlp_kernel). One launch; a CTA
// takes MLP_BM rows and keeps them on chip from LN to output:
// 1. LN of the rows into shared memory (bf16, f32 statistics);
// 2. per chunk of MLP_HC hidden columns: fc1 on the tensor cores (WMMA),
//    bias + GELU in f32, rounded to bf16 in shared memory: the fc1
//    activation never leaves the SM;
// 3. fc2 of the chunk accumulated in f32 registers (each of the 8 warps owns
//    all 64 rows x 96 output columns, 192 registers of accumulators, so a
//    warp may use 255: at 16 warps of 32 rows the 128-register cap spilled
//    700 bytes a thread);
// The weights stream through two shared-memory stage buffers with cp.async:
// the slices of W1's chunk rows and the pieces of W2's chunk columns, each
// stage's copies in flight while the previous one is computed.
// 4. epilogue: bias, one bf16 rounding, + the residual, one more rounding
//    (`x + y.astype(dtype)` of the TPU kernel).
// GELU is the TPU kernel's clamped degree-9 erf polynomial (|err| <= 3e-5),
// not the exact erff of K2 (tile_gemm.cuh::gelu_erf). Every CTA streams all
// of W1 and W2 (9.4 MB) from L2: with MLP_BM = 64 rows that is about 26 GB of
// L2 reads a call at B*S = 112 (52 GB at 32 rows; 128 rows would need 384 KB
// of f32 accumulators, more than an SM's registers). The 1658.4 GFLOP of the
// two products bound it on the tensor cores.
#include "divided_attention.cuh"

using sft::bf16;
using sft::cp_async16;
using sft::cp_async_commit;
using sft::cp_async_wait;

namespace {

// erf(z) ~= z * P9(z^2) on |z| <= 3 (synchformer_tpu/ops/pallas/fused_block.py
// :79-101), Horner in f32.
__device__ __forceinline__ float gelu_poly(float x) {
  const float z = fminf(fmaxf(x * 0.70710678118654752f, -3.f), 3.f);
  const float u = z * z;
  float p = -4.884558793996662e-09f;
  p = p * u + 2.462992635407088e-07f;
  p = p * u + -5.581884377842221e-06f;
  p = p * u + 7.619287512854014e-05f;
  p = p * u + -0.0007122925277970079f;
  p = p * u + 0.004930427932570047f;
  p = p * u + -0.026508097122118452f;
  p = p * u + 0.11261191593609451f;
  p = p * u + -0.37607043470191825f;
  p = p * u + 1.1283768672322625f;
  return x * 0.5f * (1.f + z * p);
}

constexpr int MLP_D = 768;            // model width: a warp per 96 output columns
constexpr int MLP_BM = 64;            // rows per CTA
constexpr int MLP_RF = MLP_BM / 16;   // row fragments each warp accumulates
constexpr int MLP_WARPS = MLP_D / 96;
constexpr int MLP_THREADS = 32 * MLP_WARPS;
constexpr int MLP_HC = 64;            // hidden columns per chunk
constexpr int MLP_KS = 128;           // fc1 depth of a staged W1 slice
constexpr int NS1 = MLP_D / MLP_KS;   // W1 slices a chunk
constexpr int NSTAGE = NS1 + MLP_HC / 16;  // + W2 pieces of 16 hidden columns
constexpr int XS_LD = MLP_D + 8;      // bf16 pitch of the LN tile
constexpr int WS_LD = MLP_KS + 8;     // bf16 pitch of a W1 slice (64 rows)
constexpr int W2_LD = 16 + 8;         // bf16 pitch of a W2 piece (768 rows)
constexpr int HF_LD = MLP_HC + 4;     // f32 pitch of the fc1 chunk
constexpr int HS_LD = MLP_HC + 8;     // bf16 pitch of the GELU chunk
constexpr int WBUF = MLP_D * W2_LD > MLP_HC * WS_LD ? MLP_D * W2_LD : MLP_HC * WS_LD;
constexpr size_t MLP_SMEM = (size_t)MLP_BM * XS_LD * 2 + 2 * (size_t)WBUF * 2 +
                            (size_t)MLP_BM * HF_LD * 4 + (size_t)MLP_BM * HS_LD * 2;
static_assert(MLP_BM / 16 * (MLP_HC / 16) == 2 * MLP_WARPS, "two fc1 fragments per warp");
static_assert(MLP_WARPS * 256 <= MLP_BM * HF_LD, "epilogue scratch fits the fc1 chunk");

__global__ void __launch_bounds__(MLP_THREADS, 1)
fused_mlp_kernel(const bf16* __restrict__ x, const float* __restrict__ g,
                 const float* __restrict__ b, const bf16* __restrict__ w1,
                 const float* __restrict__ b1, const bf16* __restrict__ w2,
                 const float* __restrict__ b2, bf16* __restrict__ out, int64_t M, int hidden,
                 float eps) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Xs = reinterpret_cast<bf16*>(smem);
  bf16* Wb = Xs + MLP_BM * XS_LD;  // two stage buffers of WBUF
  float* Hf = reinterpret_cast<float*>(Wb + 2 * WBUF);
  bf16* Hs = reinterpret_cast<bf16*>(Hf + MLP_BM * HF_LD);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int64_t m0 = (int64_t)blockIdx.x * MLP_BM;
  const int n_stages = hidden / MLP_HC * NSTAGE;

  // Stage t of the weight stream, into buffer t % 2: per chunk of 64 hidden
  // columns, NS1 slices of W1's chunk rows (64 x 128), then four pieces of
  // W2's chunk columns (768 x 16); cp.async, one commit group a stage.
  auto load_stage = [&](int t) {
    const int c0 = t / NSTAGE * MLP_HC, st = t % NSTAGE;
    bf16* dst = Wb + (t & 1) * WBUF;
    if (st < NS1) {
      for (int idx = tid; idx < MLP_HC * (MLP_KS / 8); idx += MLP_THREADS) {
        const int r = idx / (MLP_KS / 8), c = (idx % (MLP_KS / 8)) * 8;
        cp_async16(dst + r * WS_LD + c, w1 + (int64_t)(c0 + r) * MLP_D + st * MLP_KS + c);
      }
    } else {
      const int kk = (st - NS1) * 16;
      for (int idx = tid; idx < MLP_D * 2; idx += MLP_THREADS) {
        const int r = idx / 2, c = (idx % 2) * 8;
        cp_async16(dst + r * W2_LD + c, w2 + (int64_t)r * hidden + c0 + kk + c);
      }
    }
    cp_async_commit();
  };
  load_stage(0);

  // 1. LN: a warp per row, its 768 values in registers (three 16-byte loads
  // a lane); rows past M are zeros
  for (int r = warp; r < MLP_BM; r += MLP_WARPS) {
    const int64_t gm = m0 + r;
    uint4* dst = reinterpret_cast<uint4*>(Xs + r * XS_LD);
    if (gm >= M) {
      for (int c = lane; c < MLP_D / 8; c += 32) dst[c] = make_uint4(0u, 0u, 0u, 0u);
      continue;
    }
    const uint4* src = reinterpret_cast<const uint4*>(x + gm * MLP_D);
    uint4 v[MLP_D / 256];
    float s = 0.f, s2 = 0.f;
#pragma unroll
    for (int u = 0; u < MLP_D / 256; ++u) {
      v[u] = __ldg(src + lane + 32 * u);
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v[u]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(p[e]);
        s += f.x + f.y;
        s2 += f.x * f.x + f.y * f.y;
      }
    }
    const float mean = sft::warp_sum(s) / MLP_D;
    const float msq = sft::warp_sum(s2) / MLP_D;
    const float2 st = make_float2(mean, rsqrtf(fmaxf(msq - mean * mean, 0.f) + eps));
#pragma unroll
    for (int u = 0; u < MLP_D / 256; ++u) {
      const int c = lane + 32 * u;
      dst[c] = sft::ln_apply8(v[u], st, g + 8 * c, b + 8 * c);
    }
  }

  // fc2 accumulators: warp w owns every row and output columns 96*w..
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MLP_RF][6];
#pragma unroll
  for (int i = 0; i < MLP_RF; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  // its two fc1 fragments of each chunk: rows 16*fi.., chunk columns 16*fj..
  const int fi = warp / 2, fj = (warp % 2) * 2;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> h_acc[2];

  for (int t = 0; t < n_stages; ++t) {
    // stage t + 1's copies fly while stage t is computed
    if (t + 1 < n_stages) {
      load_stage(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* W = Wb + (t & 1) * WBUF;
    const int c0 = t / NSTAGE * MLP_HC, st = t % NSTAGE;
    if (st < NS1) {
      // 2. fc1 chunk: LN tile (BM x 768) @ W1[c0 : c0 + 64]^T, one slice
      if (st == 0) {
        wmma::fill_fragment(h_acc[0], 0.0f);
        wmma::fill_fragment(h_acc[1], 0.0f);
      }
#pragma unroll
      for (int kk = 0; kk < MLP_KS; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, Xs + fi * 16 * XS_LD + st * MLP_KS + kk, XS_LD);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
          wmma::load_matrix_sync(fb, W + (fj + u) * 16 * WS_LD + kk, WS_LD);
          wmma::mma_sync(h_acc[u], fa, fb, h_acc[u]);
        }
      }
      if (st == NS1 - 1) {
        // bias + GELU in f32, rounded to bf16: the chunk's activation
#pragma unroll
        for (int u = 0; u < 2; ++u)
          wmma::store_matrix_sync(Hf + fi * 16 * HF_LD + (fj + u) * 16, h_acc[u], HF_LD,
                                  wmma::mem_row_major);
        __syncthreads();
        for (int idx = tid; idx < MLP_BM * MLP_HC; idx += MLP_THREADS) {
          const int r = idx / MLP_HC, c = idx % MLP_HC;
          Hs[r * HS_LD + c] = __float2bfloat16(gelu_poly(Hf[r * HF_LD + c] + b1[c0 + c]));
        }
      }
    } else {
      // 3. fc2: acc += GELU chunk (BM x 16 of its columns) @ the W2 piece^T
      const int kk = (st - NS1) * 16;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[MLP_RF];
#pragma unroll
      for (int i = 0; i < MLP_RF; ++i)
        wmma::load_matrix_sync(fa[i], Hs + i * 16 * HS_LD + kk, HS_LD);
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fb, W + (warp * 96 + j * 16) * W2_LD, W2_LD);
#pragma unroll
        for (int i = 0; i < MLP_RF; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
      }
    }
    // buffer t % 2 is refilled by stage t + 2's copies, started next iteration
    __syncthreads();
  }

  // 4. epilogue through a 16 x 16 f32 scratch per warp (the fc1 chunk's space)
  float* scr = Hf + warp * 256;
#pragma unroll
  for (int i = 0; i < MLP_RF; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      wmma::store_matrix_sync(scr, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int64_t gm = m0 + i * 16 + e / 16;
        const int gn = warp * 96 + j * 16 + e % 16;
        if (gm < M) {
          const int64_t o = gm * MLP_D + gn;
          out[o] = __float2bfloat16(__bfloat162float(x[o]) + sft::bf16r(scr[e] + b2[gn]));
        }
      }
      __syncwarp();
    }
}

}  // namespace

// K8a. x (B, 1 + f*n, D) -> out (B, 1 + f*n, D) before the projection;
// w (3D, D) packed [q; k; v] rows; scratch: stats (B * (1 + f*n)) float2 and
// qkv (B, 1 + f*n, 3D). mode 0 = space, 1 = time. Needs D % 64 == 0.
extern "C" int sft_fused_divided_attention(const void* x, const void* g, const void* b,
                                           const void* w, const void* bias, void* stats,
                                           void* qkv, void* out, int B, int f, int n, int H,
                                           int dh, int mode, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int seq = 1 + f * n, D = H * dh;
  const int64_t rows = (int64_t)B * seq;
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* q = static_cast<bf16*>(qkv);
  bf16* o = static_cast<bf16*>(out);
  sft::ln_stats(xb, static_cast<float2*>(stats), rows, D, eps, s);
  SFT_CHECK_LAUNCH();
  sft::gemm_ln_bf16(xb, static_cast<const bf16*>(w), static_cast<const float*>(bias), q,
                    (int)rows, 3 * D, D,
                    sft::LnPrologue{static_cast<const float2*>(stats),
                                    static_cast<const float*>(g), static_cast<const float*>(b)},
                    s);
  SFT_CHECK_LAUNCH();
  return sft::attn::dispatch_attention(dh, q + 3 * D, q, o + D, o, B, f, n, H, mode, seq, seq,
                                       seq, seq, s);
}

// K8b. x (rows, 768) -> x + fc2(GELU(fc1(LN(x)))); w1 (hidden, 768), w2
// (768, hidden) bf16; LN params and biases f32. Needs hidden % 64 == 0.
extern "C" int sft_fused_mlp(const void* x, const void* g, const void* b, const void* w1,
                             const void* b1, const void* w2, const void* b2, void* out,
                             long long rows, int d, int hidden, float eps, void* stream) {
  if (d != MLP_D || hidden % MLP_HC != 0) return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(fused_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)MLP_SMEM);
  SFT_CHECK_LAUNCH();
  const long long blocks = (rows + MLP_BM - 1) / MLP_BM;
  fused_mlp_kernel<<<(unsigned)blocks, MLP_THREADS, MLP_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(g), static_cast<const float*>(b),
      static_cast<const bf16*>(w1), static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<bf16*>(out), rows, hidden, eps);
  SFT_CHECK_LAUNCH();
  return 0;
}
