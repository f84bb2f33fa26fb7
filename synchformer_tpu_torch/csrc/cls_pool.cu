// K4 and K4b: one pre-LN encoder layer for the CLS row only: LN1 -> q from
// the CLS row, K/V over every row -> 1-query attention -> proj -> residual on
// the CLS row -> LN2 -> MLP -> residual. Output (B, D).
//
// K4 (sft_cls_pool_tokens) replaces synchformer_tpu/ops/pallas/cls_pool.py::
// _cls_pool_tokens_pallas (body _cls_pool_tokens_kernel): (B, M, D) tokens
// and one CLS row shared by every group, attended as [CLS; tokens].
// K4b (sft_cls_pool) replaces cls_pool.py::_cls_pool_pallas (body
// _cls_pool_kernel): the CLS row is row 0 of each group's (N, D) x, so it
// differs per group (the global segment aggregator in training, where the
// positional dropout has touched it).
//
// With a single query, the (N, 2D) K/V projection is not needed:
//   logit_h[j] = LN(x_j) . U_h + c_h,  U_h = Wk_h^T q_h,  c_h = bk_h . q_h
//   out_h      = Z_h Wv_h^T + ptok_h bv_h,  Z_h = sum_j p_hj LN(x_j),
//                ptok_h = sum_j p_hj
// K and V are never formed, so their bf16 rounding in the reference is
// skipped (the tests' bf16 tolerance allows for that).
//
// Bound on an NVIDIA H100: the pool pass reads x once (270 MB at the spatial
// aggregator's (896, 196, 768), 0.08 ms at 3.35 TB/s); every product is small
// (about 11 GFLOP there, most of it the MLP); at the MoCo step's (2, 15, 768)
// the 14 MB of weights. So the design spreads every weight read over the
// card and keeps x's one read at the memory rate. Launches:
// - prep. K4: LN1 of the CLS row (ln_row0_kernel), then q, k_cls and v_cls
//   as one skinny product (skinny_kernel: a block per output row, its four
//   warps a quarter of K each, 16-byte loads; 2304 blocks); K4b: LN1 of each
//   group's row 0, then q on the skinny product (groups <= SKINNY_ROWS) or
//   the Hopper GEMM (wgmma_gemm.cuh). Then u_kernel: U_h = q_h Wk_h on
//   mma.sync (bf16 products exact, f32 sums), over (D / 64) x H x (groups /
//   16) blocks, Wk read once per 16 groups, stored as bf16 hi + lo (hi =
//   bf16(U), lo = bf16(U - hi)); c_h (and K4's CLS logit q_h . k_cls,h) in
//   f32.
// - pool_kernel, the pass over x: a group's rows go into shared memory by
//   16-byte cp.async, a commit group per 16-row tile, each tile normalised
//   as it lands (f32 row statistics, each element normalised and rounded to
//   bf16 once, in place); the logits LN(X) U^T are two mma.sync products (U
//   hi and U lo: the f32 U to about 2^-16), scaled in f32; the softmax is
//   taken over all L = M (+1 for K4's CLS key) columns in f32 and only then
//   rounded to bf16 (the reference's rounding point: no online rounding); Z
//   = P^T LN(X) is one more mma.sync product (heads as the 16 rows, H
//   padded), f32 sums. Rows that do not fill a 16-row tile, and heads past
//   H, read a zero row instead (ldmatrix takes a row address a lane). A
//   group of up to `cap` rows (112 at D = 768, 12 heads) stays resident and
//   x is read once. A longer one (196 at the spatial aggregator) is split
//   over a 2-block cluster whose halves exchange their softmax max and sum
//   through distributed shared memory and write Z as two f32 partials,
//   which att_kernel adds; a half longer than `cap` is streamed in chunks,
//   a first pass for the softmax statistics, a second (from L2, the last
//   chunk still resident) recomputing LN and logits for P and Z. (One block
//   streaming the whole group, and the halves summing Z on chip through
//   distributed shared memory, were both built and measured slower:
//   PERF.md.) The plan (ops/kernels/_build.py::cls_pool_plan) is passed in.
//   K4's short groups (12 rows at the frequency aggregator) are packed
//   several to a block, sharing U: Z is taken group by group with the other
//   groups' probabilities masked out of the A fragments. One block an SM
//   (about 200 KB of shared memory at 98 rows), so the phases after the
//   loads do not overlap another block's loads: the pass runs at about 4x
//   its bound (PERF.md).
// - the Wv product: att = Z_h Wv_h^T + ptok_h bv (+ p_cls,h v_cls for K4)
//   for all groups at once. att_kernel: H products of (B x D) x (D x dh) on
//   mma.sync with Z in f32 as bf16 hi + lo (so Z keeps f32 precision; the
//   output rounds to bf16 once), Wv read once per 64 groups, not once per
//   group; at SKINNY_ROWS groups or fewer, att_skinny_kernel (the skinny
//   product's split, Z in f32 on the CUDA cores).
// - the tail, with the groups as rows: proj + residual (the CLS row, r_stride
//   0, for K4; each group's row 0 for K4b), ln_rows (LN2), fc1 + erf-GELU,
//   fc2 + residual, on the Hopper GEMM (EPI_BIAS_RESIDUAL, EPI_BIAS_GELU,
//   EPI_BIAS_RESIDUAL), or, at SKINNY_ROWS groups or fewer (the MoCo step's
//   2; measured on the whole of K4: at 8 groups 0.062 ms against the GEMM's
//   0.091, at 12 even; PERF.md), on skinny_kernel, which spreads the weight
//   read over N blocks (a 128-row wgmma tile would be 98%
//   empty at 2 rows). Both round as the reference does: bf16(acc + b),
//   bf16(R + bf16(acc + b)), bf16(GELU(acc + b)), with f32 sums.
// Roundings beside the reference's: K and V are not rounded (U trick); U
// enters the logits as hi + lo and Z the Wv product as hi + lo (both at
// about 2^-16); the sums run in another order. The TPU kernels keep every
// intermediate in VMEM; here Z (B x H x D f32, 33 MB at the spatial shape,
// twice that as a cluster's partials), att and the MLP activation pass
// through device memory.
#include <cooperative_groups.h>

#include "mma_attention.cuh"
#include "wgmma_gemm.cuh"

namespace cg = cooperative_groups;
using sft::bf16;
using sft::cp_async16;
using sft::cp_async_commit;
using sft::cp_async_wait;
using sft::tc::ldmatrix_x4;
using sft::tc::ldmatrix_x4_trans;
using sft::tc::mma_bf16;
using sft::tc::pack_bf16;

namespace {

constexpr int THREADS = 256;  // pool_kernel: 8 warps
constexpr int MAXH = 16;      // heads: the 16 rows of Z's m16 tile
constexpr int GMAX = 16;      // groups a pool block packs at most
constexpr int ZU = 8;         // 16-column units of Z a warp holds in one column pass
constexpr int MAX_SMEM = 232448;
constexpr int SKINNY_ROWS = 8;  // groups at or below which the products run skinny
constexpr int SKINNY_WARPS = 4;  // skinny_kernel: warps a block, each a quarter of K
constexpr int U_ROWS = 16;       // u_kernel: groups a block
constexpr int U_COLS = 64;       // u_kernel: columns of U a block
constexpr int ATT_ROWS = 64;     // att_kernel: groups a block
constexpr int ATT_KB = 64;       // att_kernel: columns of Z and Wv staged at once

__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 t = __bfloat1622float2(p[e]);
    f[2 * e] = t.x;
    f[2 * e + 1] = t.y;
  }
}

// Wait until at most n of this thread's cp.async groups are pending (more
// than 7: until 7 are, which completes at least as many).
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// LN1 of row 0 of each group, one warp per group, rounded to bf16.
__global__ void __launch_bounds__(THREADS)
ln_row0_kernel(const bf16* __restrict__ x, int64_t group_stride, const float* __restrict__ g,
               const float* __restrict__ b, bf16* __restrict__ y, int B, int D, float eps) {
  const int lane = threadIdx.x % 32;
  const int grp = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  if (grp >= B) return;
  const bf16* xr = x + (int64_t)grp * group_stride;
  float s = 0.f, s2 = 0.f;
  for (int d = lane; d < D; d += 32) {
    const float v = __bfloat162float(xr[d]);
    s += v;
    s2 += v * v;
  }
  const float mean = sft::warp_sum(s) / D;
  const float msq = sft::warp_sum(s2) / D;
  const float rstd = rsqrtf(fmaxf(msq - mean * mean, 0.f) + eps);
  for (int d = lane; d < D; d += 32)
    y[(int64_t)grp * D + d] =
        __float2bfloat16((__bfloat162float(xr[d]) - mean) * rstd * g[d] + b[d]);
}

// C[r, n] = epilogue(A[r, :] . W[n, :] + bias[n]) for r < rows <= RT:
// one block per output column n, its SKINNY_WARPS warps each a quarter of K
// in 8-value pieces (K % 8 == 0; the last quarter shorter where K % 32 !=
// 0: an MLP width of 8-value pieces) with 16-byte loads of W's row and A's
// rows (a few KB, from L1), the quarters' f32 sums added in order in shared
// memory. The epilogues round as wgmma_gemm.cuh's.
template <int EPI, int RM>
__global__ void __launch_bounds__(SKINNY_WARPS * 32)
skinny_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
              const float* __restrict__ bias, const bf16* __restrict__ R, int64_t r_stride,
              bf16* __restrict__ C, int rows, int N, int K) {
  __shared__ float part[SKINNY_WARPS][RM];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int n = blockIdx.x, kw = (K / 8 + SKINNY_WARPS - 1) / SKINNY_WARPS * 8, k0 = warp * kw;
  const int k1 = min(k0 + kw, K);
  float acc[RM];
#pragma unroll
  for (int r = 0; r < RM; ++r) acc[r] = 0.f;
  const bf16* wr = W + (int64_t)n * K;
#pragma unroll 4
  for (int k = k0 + lane * 8; k < k1; k += 256) {
    float w[8];
    unpack8(__ldg(reinterpret_cast<const uint4*>(wr + k)), w);
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      if (r < rows) {
        float a[8];
        unpack8(__ldg(reinterpret_cast<const uint4*>(A + (int64_t)r * K + k)), a);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[r] += a[e] * w[e];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    if (r < rows) {
      const float v = sft::warp_sum(acc[r]);
      if (lane == 0) part[warp][r] = v;
    }
  }
  __syncthreads();
  if (warp != 0) return;
  for (int r = lane; r < rows; r += 32) {
    float v = part[0][r];
#pragma unroll
    for (int w = 1; w < SKINNY_WARPS; ++w) v += part[w][r];
    v += bias[n];
    if (EPI == sft::EPI_BIAS_GELU) v = sft::gelu_erf(v);
    if (EPI == sft::EPI_BIAS_RESIDUAL)
      v = __bfloat162float(R[(int64_t)r * r_stride + n]) + sft::bf16r(v);
    C[(int64_t)r * N + n] = __float2bfloat16(v);
  }
}

// skinny_kernel with the least power of two >= rows (from RT) as its rows
template <int EPI, int RT>
int skinny(const bf16* A, const bf16* W, const float* bias, const bf16* R, int64_t r_stride,
           bf16* C, int rows, int N, int K, cudaStream_t s) {
  if constexpr (RT < SKINNY_ROWS) {
    if (rows > RT) return skinny<EPI, 2 * RT>(A, W, bias, R, r_stride, C, rows, N, K, s);
  }
  skinny_kernel<EPI, RT><<<N, SKINNY_WARPS * 32, 0, s>>>(A, W, bias, R, r_stride, C, rows, N, K);
  SFT_CHECK_LAUNCH();
  return 0;
}

// C = epilogue(A W^T + bias) with the groups as rows: skinny at
// SKINNY_ROWS rows or fewer, else the Hopper GEMM.
template <int EPI>
int product(const bf16* A, const bf16* W, const float* bias, const bf16* R, int64_t r_stride,
            bf16* C, int rows, int N, int K, cudaStream_t s) {
  if (rows > SKINNY_ROWS) return sft::wgmma_gemm<EPI>(A, W, bias, R, r_stride, C, rows, N, K, s);
  return skinny<EPI, 2>(A, W, bias, R, r_stride, C, rows, N, K, s);
}

// U[b][h][d] = sum_{e < dh} q[b][h dh + e] Wk[h dh + e][d] on mma.sync (f32
// sums of exact bf16 products), stored as bf16 hi and lo; c[b][h] = q_b,h .
// bk_h; with kc (K4, one group), lc[h] = q_h . kc_h. Grid (D / U_COLS x
// groups / U_ROWS, H), the column tiles of one row of groups adjacent; 4
// warps, 16 columns each; the head's Wk rows in chunks of 64 (zero-filled
// past dh).
__global__ void __launch_bounds__(128)
u_kernel(const bf16* __restrict__ q, int64_t q_stride, const bf16* __restrict__ wqkv,
         const float* __restrict__ bqkv, const bf16* __restrict__ kc, bf16* __restrict__ uhi,
         bf16* __restrict__ ulo, float* __restrict__ c, float* __restrict__ lc, int B, int D,
         int H) {
  constexpr int KC = 64, QP = KC + 8, WP = U_COLS + 8;  // odd 16-byte pitches
  __shared__ __align__(16) bf16 Qs[U_ROWS * QP];
  __shared__ __align__(16) bf16 Ws[KC * WP];
  const int dh = D / H, h = blockIdx.y, dt = blockIdx.x % (D / U_COLS), d0 = dt * U_COLS;
  const int b0 = blockIdx.x / (D / U_COLS) * U_ROWS;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const bf16* wk = wqkv + (int64_t)(D + h * dh) * D + d0;
  float acc[2][4] = {};
  for (int e0 = 0; e0 < dh; e0 += KC) {
    __syncthreads();
    for (int i = tid; i < U_ROWS * KC; i += 128) {
      const int r = i / KC, e = e0 + i % KC;
      Qs[r * QP + i % KC] = b0 + r < B && e < dh ? q[(int64_t)(b0 + r) * q_stride + h * dh + e]
                                                 : __float2bfloat16(0.f);
    }
    for (int i = tid; i < KC * (U_COLS / 8); i += 128) {
      const int e = i / (U_COLS / 8), u = i % (U_COLS / 8);
      cp_async16(Ws + e * WP + u * 8, e0 + e < dh ? wk + (int64_t)(e0 + e) * D + u * 8 : wk,
                 e0 + e < dh);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      uint32_t a[4], b[4];
      ldmatrix_x4(a, Qs + (lane & 15) * QP + ks * 16 + (lane >> 4) * 8);
      ldmatrix_x4_trans(b, Ws + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * WP +
                               warp * 16 + (lane >> 4) * 8);
      mma_bf16(acc[0], a, b[0], b[1]);
      mma_bf16(acc[1], a, b[2], b[3]);
    }
  }
#pragma unroll
  for (int nn = 0; nn < 2; ++nn) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = lane / 4 + 8 * half;
      if (b0 + r >= B) continue;
      const int64_t idx = ((int64_t)(b0 + r) * H + h) * D + d0 + warp * 16 + nn * 8 + 2 * (lane % 4);
      const float v0 = acc[nn][2 * half], v1 = acc[nn][2 * half + 1];
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v0, v1);
      const float2 hf = __bfloat1622float2(hi);
      *reinterpret_cast<__nv_bfloat162*>(uhi + idx) = hi;
      *reinterpret_cast<__nv_bfloat162*>(ulo + idx) = __floats2bfloat162_rn(v0 - hf.x, v1 - hf.y);
    }
  }
  if (dt == 0 && tid < U_ROWS && b0 + tid < B) {
    const bf16* qr = q + (int64_t)(b0 + tid) * q_stride + h * dh;
    float cq = 0.f, l = 0.f;
    for (int e = 0; e < dh; ++e) {
      const float qe = __bfloat162float(qr[e]);
      cq += qe * bqkv[D + h * dh + e];
      if (kc != nullptr) l += qe * __bfloat162float(kc[h * dh + e]);
    }
    c[(int64_t)(b0 + tid) * H + h] = cq;
    if (kc != nullptr) lc[h] = l;
  }
}

// The pool pass's operands. Group g's U (hi, lo: H x D bf16) at + g *
// u_stride and c (H f32) at + g * c_stride (stride 0: shared by every
// group); lc: K4's CLS logits (H, unscaled). Out: z (B, CL, H, D) f32 and
// pt (B, CL, H) f32, a partial per block of a cluster; pc (B, H) f32, K4's
// p_cls. G groups a block (CL 1), rows: the rows of x a block holds at once.
struct Pool {
  const bf16* x;
  const float* g1;
  const float* b1;
  const bf16* uhi;
  const bf16* ulo;
  int64_t u_stride;
  const float* c;
  int c_stride;
  const float* lc;
  float* z;
  float* pt;
  float* pc;
  int B, M, D, H, G, rows;
  float eps, scale;
};

// pool_kernel's shared memory (bytes) for `rows` rows: x (rows x (D + 8)
// bf16), U hi and lo (H x (D + 8) each), a zero row, the logits (16 x (rows
// + 1) f32), P^T (16 x (rows rounded to 16, + 8) bf16), the softmax state of
// GMAX groups and the cluster's exchange slots (max, sum). Mirrored by
// ops/kernels/_build.py::cls_pool_smem.
inline size_t pool_smem(int rows, int D, int H) {
  const size_t p = D + 8, t16 = (rows + 15) / 16 * 16;
  return (size_t)rows * p * 2 + 2 * (size_t)H * p * 2 + p * 2 + 16 * ((size_t)rows + 1) * 4 +
         16 * (t16 + 8) * 2 + GMAX * 16 * 3 * 4 + 2 * MAXH * 4;
}

__device__ __forceinline__ uint4 ln8(const uint4& xv, float mean, float rstd, const float4& g0,
                                     const float4& g1, const float4& b0, const float4& b1) {
  float v[8];
  unpack8(xv, v);
  const float g[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
  const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
  uint4 out;
  uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
  for (int e = 0; e < 4; ++e)
    o[e] = pack_bf16((v[2 * e] - mean) * rstd * g[2 * e] + b[2 * e],
                     (v[2 * e + 1] - mean) * rstd * g[2 * e + 1] + b[2 * e + 1]);
  return out;
}

// A group's (or a cluster half's) rows of x -> Z, ptok (and K4's p_cls).
// Grid: one block per G groups (CL 1) or two per group (CL 2, a cluster).
template <bool TOKENS, int CL>
__global__ void __launch_bounds__(THREADS, 1)
pool_kernel(const Pool p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = p.D, H = p.H, P = D + 8, U = D / 8;  // U: 16-byte units of a row
  const int PTP = (p.rows + 15) / 16 * 16 + 8;
  bf16* Xs = reinterpret_cast<bf16*>(smem);
  bf16* Uh = Xs + (size_t)p.rows * P;
  bf16* Ul = Uh + (size_t)H * P;
  bf16* zr = Ul + (size_t)H * P;
  const int LP = p.rows + 1;  // f32 pitch of lg's head rows
  float* lg = reinterpret_cast<float*>(zr + P);  // the logits, [head][row]
  bf16* PT = reinterpret_cast<bf16*>(lg + (size_t)16 * LP);
  float* sm = reinterpret_cast<float*>(PT + 16 * PTP);  // per (group, head): the softmax max,
  float* ss = sm + GMAX * 16;  // then the sum, then its inverse
  float* st = ss + GMAX * 16;  // ptok
  float* xch = st + GMAX * 16;  // this block's (max, sum) per head, for the peer
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = CL == 2 ? blockIdx.x % 2 : 0;
  const int g0 = blockIdx.x / CL * p.G, ng = min(p.G, p.B - g0);
  const int half = (p.M + 1) / 2;
  const int nrows = CL == 2 ? (rank == 1 ? p.M - half : half) : ng * p.M;
  const int nch = (nrows + p.rows - 1) / p.rows;
  const bf16* xs = p.x + ((int64_t)g0 * p.M + (rank == 1 ? half : 0)) * D;
  const float* cg0 = p.c + (int64_t)g0 * p.c_stride;

  // U hi / lo of the block's group (K4: shared by every group), staged by
  // the first pass after its rows of x, so that x's loads start first
  auto stage_u = [&]() {
    const bf16* uh = p.uhi + (int64_t)g0 * p.u_stride;
    const bf16* ul = p.ulo + (int64_t)g0 * p.u_stride;
    for (int i = tid; i < H * U; i += THREADS) {
      const int h = i / U, u = i % U;
      cp_async16(Uh + h * P + u * 8, uh + (int64_t)h * D + u * 8);
      cp_async16(Ul + h * P + u * 8, ul + (int64_t)h * D + u * 8);
    }
    cp_async_commit();
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (int i = tid; i < P / 8; i += THREADS) reinterpret_cast<uint4*>(zr)[i] = zero;
    for (int i = tid; i < 2 * PTP; i += THREADS) reinterpret_cast<uint4*>(PT)[i] = zero;
    for (int i = tid; i < GMAX * 16; i += THREADS) {
      sm[i] = -INFINITY;
      ss[i] = 0.f;
      st[i] = 0.f;
    }
  };

  // the lane's g1 / b1 for its first four 16-byte units of a row, held for
  // every row the warp normalises
  float4 gr[4][2], br[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int u = lane + 32 * i;
    if (u < U) {
      gr[i][0] = __ldg(reinterpret_cast<const float4*>(p.g1 + u * 8));
      gr[i][1] = __ldg(reinterpret_cast<const float4*>(p.g1 + u * 8 + 4));
      br[i][0] = __ldg(reinterpret_cast<const float4*>(p.b1 + u * 8));
      br[i][1] = __ldg(reinterpret_cast<const float4*>(p.b1 + u * 8 + 4));
    }
  }
  // rows r and r + 8 of Xs (the second if `two`): f32 statistics, then each
  // element normalised and rounded to bf16 in place, by one warp, the two
  // rows' loads and reductions interleaved (the lane's first four units of
  // each row in registers)
  auto normalise = [&](int r, bool two) {
    bf16* ra = Xs + r * P;
    bf16* rb = ra + 8 * P;
    uint4 xa[4], xb[4];
    float st4[4] = {0.f, 0.f, 0.f, 0.f};  // sum and sum of squares of each row
    auto add = [&](const uint4& v8, float& sum, float& sq) {
      float v[8];
      unpack8(v8, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        sum += v[e];
        sq += v[e] * v[e];
      }
    };
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int u = lane + 32 * i;
      if (u < U) {
        xa[i] = *reinterpret_cast<const uint4*>(ra + u * 8);
        if (two) xb[i] = *reinterpret_cast<const uint4*>(rb + u * 8);
        add(xa[i], st4[0], st4[1]);
        if (two) add(xb[i], st4[2], st4[3]);
      }
    }
    for (int u = lane + 128; u < U; u += 32) {
      add(*reinterpret_cast<const uint4*>(ra + u * 8), st4[0], st4[1]);
      if (two) add(*reinterpret_cast<const uint4*>(rb + u * 8), st4[2], st4[3]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int k = 0; k < 4; ++k) st4[k] += __shfl_xor_sync(0xffffffffu, st4[k], o);
    }
    const float ma = st4[0] / D, mb = st4[2] / D;
    const float sa = rsqrtf(fmaxf(st4[1] / D - ma * ma, 0.f) + p.eps);
    const float sb = rsqrtf(fmaxf(st4[3] / D - mb * mb, 0.f) + p.eps);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int u = lane + 32 * i;
      if (u < U) {
        *reinterpret_cast<uint4*>(ra + u * 8) =
            ln8(xa[i], ma, sa, gr[i][0], gr[i][1], br[i][0], br[i][1]);
        if (two)
          *reinterpret_cast<uint4*>(rb + u * 8) =
              ln8(xb[i], mb, sb, gr[i][0], gr[i][1], br[i][0], br[i][1]);
      }
    }
    for (int u = lane + 128; u < U; u += 32) {
      const float* g = p.g1 + u * 8;
      const float* b = p.b1 + u * 8;
      const float4 g0 = __ldg(reinterpret_cast<const float4*>(g));
      const float4 g1 = __ldg(reinterpret_cast<const float4*>(g + 4));
      const float4 b0 = __ldg(reinterpret_cast<const float4*>(b));
      const float4 b1 = __ldg(reinterpret_cast<const float4*>(b + 4));
      *reinterpret_cast<uint4*>(ra + u * 8) =
          ln8(*reinterpret_cast<const uint4*>(ra + u * 8), ma, sa, g0, g1, b0, b1);
      if (two)
        *reinterpret_cast<uint4*>(rb + u * 8) =
            ln8(*reinterpret_cast<const uint4*>(rb + u * 8), mb, sb, g0, g1, b0, b1);
    }
  };
  // lg[h][r] = (LN(x_r) . (U_hi + U_lo)_h + c_h) * scale, a warp per 16-row tile
  auto logits = [&](int n) {
    const int hb = (lane & 7) + (lane >> 4) * 8, kb = ((lane >> 3) & 1) * 8;
    const bf16* bh = (hb < H ? Uh + hb * P : zr) + kb;
    const bf16* bl = (hb < H ? Ul + hb * P : zr) + kb;
    for (int t = warp; t * 16 < n; t += THREADS / 32) {
      float acc[2][2][4] = {};  // [hi, lo][heads 0-7, 8-15]: four independent chains
      const int ra = t * 16 + (lane & 15);
      const bf16* arow = (ra < n ? Xs + ra * P : zr) + (lane >> 4) * 8;
#pragma unroll 4
      for (int ks = 0; ks < D / 16; ++ks) {
        uint32_t a[4], b[4];
        ldmatrix_x4(a, arow + ks * 16);
        ldmatrix_x4(b, bh + ks * 16);
        mma_bf16(acc[0][0], a, b[0], b[1]);
        mma_bf16(acc[0][1], a, b[2], b[3]);
        ldmatrix_x4(b, bl + ks * 16);
        mma_bf16(acc[1][0], a, b[0], b[1]);
        mma_bf16(acc[1][1], a, b[2], b[3]);
      }
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = t * 16 + lane / 4 + 8 * (i / 2), h = nn * 8 + 2 * (lane % 4) + (i & 1);
          if (r < n && h < H) lg[h * LP + r] = (acc[0][nn][i] + acc[1][nn][i] + cg0[h]) * p.scale;
        }
      }
    }
  };
  // rows [lo, hi) of the chunk (first row r0 of the block, n rows) that belong
  // to group g of the block
  auto group_rows = [&](int g, int r0, int n, int& lo, int& hi) {
    lo = max(CL == 2 ? 0 : g * p.M, r0) - r0;
    hi = min(CL == 2 ? nrows : (g + 1) * p.M, r0 + n) - r0;
  };
  // the chunk's max and sum of exp per (group, head), folded into sm / ss
  auto fold = [&](int r0, int n) {
    for (int q = warp; q < ng * H; q += THREADS / 32) {
      const int g = q / H, h = q % H;
      int lo, hi;
      group_rows(g, r0, n, lo, hi);
      if (lo >= hi) continue;
      float m = -INFINITY;
      for (int r = lo + lane; r < hi; r += 32) m = fmaxf(m, lg[h * LP + r]);
      m = sft::warp_max(m);
      float s = 0.f;
      for (int r = lo + lane; r < hi; r += 32) s += __expf(lg[h * LP + r] - m);
      s = sft::warp_sum(s);
      if (lane == 0) {
        const int k = g * 16 + h;
        const float mo = sm[k], mn = fmaxf(mo, m);
        ss[k] = ss[k] * __expf(mo - mn) + s * __expf(m - mn);
        sm[k] = mn;
      }
    }
  };
  // rows [c * rows, ...) of the block into Xs, a commit group per 16-row
  // tile (the first chunk's followed by U's), each tile normalised as it
  // lands (while the later ones load), then the logits; returns the rows
  auto pass = [&](int c, bool first) {
    const int n = min(p.rows, nrows - c * p.rows), nt = (n + 15) / 16;
    const bf16* src = xs + (int64_t)c * p.rows * D;
    for (int t = 0; t < nt; ++t) {
      const int r0 = t * 16, rn = min(16, n - r0);
      for (int i = tid; i < rn * U; i += THREADS) {
        const int r = r0 + i / U, u = i % U;
        cp_async16(Xs + r * P + u * 8, src + (int64_t)r * D + u * 8);
      }
      cp_async_commit();
    }
    if (first) stage_u();
    for (int t = 0; t < nt; ++t) {
      cp_async_wait_upto(nt - 1 - t + first);
      __syncthreads();
      const int r = t * 16 + warp;  // a warp's rows of the tile: r and r + 8
      if (r < n) normalise(r, r + 8 < n);
    }
    cp_async_wait<0>();
    __syncthreads();
    logits(n);
    __syncthreads();
    return n;
  };

  // pass 1: the softmax statistics over every chunk
  int n = 0;
  for (int c = 0; c < nch; ++c) {
    if (c > 0) __syncthreads();
    n = pass(c, c == 0);
    fold(c * p.rows, n);
  }
  __syncthreads();
  if (CL == 2) {  // the two halves' statistics, combined in rank order by both
    cg::cluster_group cluster = cg::this_cluster();
    if (tid < H) {
      xch[tid] = sm[tid];
      xch[MAXH + tid] = ss[tid];
    }
    cluster.sync();
    if (tid < H) {
      const float* peer = cluster.map_shared_rank(xch, rank ^ 1);
      const float* x0 = rank == 0 ? xch : peer;
      const float* x1 = rank == 0 ? peer : xch;
      const float m0 = x0[tid], m1 = x1[tid], m = fmaxf(m0, m1);
      sm[tid] = m;
      ss[tid] = x0[MAXH + tid] * __expf(m0 - m) + x1[MAXH + tid] * __expf(m1 - m);
    }
    __syncthreads();
  }
  for (int q = tid; q < ng * H; q += THREADS) {
    const int g = q / H, h = q % H, k = g * 16 + h;
    float m = sm[k], s = ss[k];
    if (TOKENS) {  // the CLS key: one more column of the softmax
      const float l = p.lc[h] * p.scale, mn = fmaxf(m, l);
      s = s * __expf(m - mn) + __expf(l - mn);
      m = mn;
      if (rank == 0) p.pc[(int64_t)(g0 + g) * H + h] = sft::bf16r(__expf(l - m) * (1.f / s));
    }
    sm[k] = m;
    ss[k] = 1.f / s;
  }
  __syncthreads();

  // pass 2, last chunk first (still resident): P = bf16(exp(l - m) / sum),
  // ptok, Z += P^T LN(X)
  for (int c = nch - 1; c >= 0; --c) {
    if (c != nch - 1) {
      __syncthreads();
      n = pass(c, false);
    }
    const int r0 = c * p.rows, w = (n + 15) / 16 * 16;
    for (int h = warp; h < H; h += THREADS / 32) {  // a warp per head, a lane per row
      for (int j = lane; j < w; j += 32) {
        float v = 0.f;
        if (j < n) {
          const int k = (CL == 2 || p.G == 1 ? 0 : (r0 + j) / p.M) * 16 + h;
          v = __expf(lg[h * LP + j] - sm[k]) * ss[k];
        }
        PT[h * PTP + j] = __float2bfloat16(v);
      }
    }
    __syncthreads();
    for (int q = warp; q < ng * H; q += THREADS / 32) {
      const int g = q / H, h = q % H;
      int lo, hi;
      group_rows(g, r0, n, lo, hi);
      float s = 0.f;
      for (int r = lo + lane; r < hi; r += 32) s += __bfloat162float(PT[h * PTP + r]);
      s = sft::warp_sum(s);
      if (lane == 0) st[g * 16 + h] += s;
    }
    for (int g = 0; g < ng; ++g) {
      int lo, hi;
      group_rows(g, r0, n, lo, hi);
      if (lo >= hi) continue;
      float* zg = p.z + ((int64_t)(g0 + g) * CL + rank) * H * D;
      for (int u0 = 0; u0 < D / 16; u0 += ZU * (THREADS / 32)) {
        float acc[ZU][2][4] = {};
        for (int t = lo / 16; t * 16 < hi; ++t) {
          uint32_t a[4];
          ldmatrix_x4(a, PT + (lane & 15) * PTP + t * 16 + (lane >> 4) * 8);
          // the other groups' columns (rows of x) out of the A fragments
          const int j = t * 16 + 2 * (lane % 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int jj = j + 8 * (i >> 1);
            const uint32_t keep = (jj >= lo && jj < hi ? 0xFFFFu : 0u) |
                                  (jj + 1 >= lo && jj + 1 < hi ? 0xFFFF0000u : 0u);
            a[i] &= keep;
          }
          const int rb = t * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
          const bf16* brow = (rb < n ? Xs + rb * P : zr) + (lane >> 4) * 8;
#pragma unroll
          for (int i = 0; i < ZU; ++i) {
            const int u = u0 + warp + (THREADS / 32) * i;
            if (u < D / 16) {
              uint32_t b[4];
              ldmatrix_x4_trans(b, brow + u * 16);
              mma_bf16(acc[i][0], a, b[0], b[1]);
              mma_bf16(acc[i][1], a, b[2], b[3]);
            }
          }
        }
        // rows: heads lane / 4 (+ 8); the first chunk processed stores, the
        // others add (the same thread owns the same elements every chunk)
#pragma unroll
        for (int i = 0; i < ZU; ++i) {
          const int u = u0 + warp + (THREADS / 32) * i;
          if (u >= D / 16) continue;
#pragma unroll
          for (int nn = 0; nn < 2; ++nn) {
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int h = lane / 4 + 8 * hf;
              if (h >= H) continue;
              const int col = u * 16 + nn * 8 + 2 * (lane % 4);
              float2* dst = reinterpret_cast<float2*>(zg + (int64_t)h * D + col);
              float2 v = make_float2(acc[i][nn][2 * hf], acc[i][nn][2 * hf + 1]);
              if (c != nch - 1) {
                const float2 o = *dst;
                v.x += o.x;
                v.y += o.y;
              }
              *dst = v;
            }
          }
        }
      }
    }
  }
  __syncthreads();
  for (int q = tid; q < ng * H; q += THREADS) {
    const int g = q / H, h = q % H;
    p.pt[((int64_t)(g0 + g) * CL + rank) * H + h] = st[g * 16 + h];
  }
  if (CL == 2) cg::this_cluster().sync();  // the peer has read this block's xch
}

// att[b][e] = bf16(Z_b,h . Wv[e] + ptok_b,h bv[e] (+ pc_b,h vc[e])), h = e / dh.
// Grid (groups / ATT_ROWS, H, dh / 64): a block's 64 groups x 64 columns of
// one head (columns past the head are computed and dropped, Wv rows past D
// read as zeros); 4 warps, 16 groups each; Z (the partials summed in f32)
// enters as bf16 hi + lo, Wv by ldmatrix; k-steps of ATT_KB, double-buffered
// by cp.async.
template <bool TOKENS, int PARTS>
__global__ void __launch_bounds__(128)
att_kernel(const float* __restrict__ z, const float* __restrict__ pt,
           const float* __restrict__ pc, const bf16* __restrict__ wqkv,
           const float* __restrict__ bqkv, const bf16* __restrict__ vc, bf16* __restrict__ att,
           int B, int D, int H) {
  constexpr int AP = ATT_KB + 8, BP = ATT_KB + 8;  // conflict-free float2 / ldmatrix
  extern __shared__ __align__(16) unsigned char smem[];
  float* As = reinterpret_cast<float*>(smem);                      // 2 x PARTS x 64 x AP
  bf16* Bs = reinterpret_cast<bf16*>(As + 2 * PARTS * ATT_ROWS * AP);  // 2 x 64 x BP
  const int dh = D / H, h = blockIdx.y;
  const int b0 = blockIdx.x * ATT_ROWS, e0 = h * dh + blockIdx.z * 64;
  const int e1 = min(e0 + 64, (h + 1) * dh);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const bf16* wv = wqkv + (int64_t)2 * D * D;
  auto stage = [&](int s, int k0) {
    for (int i = tid; i < PARTS * ATT_ROWS * (ATT_KB / 4); i += 128) {
      const int part = i / (ATT_ROWS * (ATT_KB / 4)), r = i / (ATT_KB / 4) % ATT_ROWS;
      const int u = i % (ATT_KB / 4), b = b0 + r;
      cp_async16(As + ((s * PARTS + part) * ATT_ROWS + r) * AP + u * 4,
                 b < B ? z + (((int64_t)b * PARTS + part) * H + h) * D + k0 + u * 4 : z, b < B);
    }
    for (int i = tid; i < 64 * (ATT_KB / 8); i += 128) {
      const int r = i / (ATT_KB / 8), u = i % (ATT_KB / 8), e = e0 + r;
      cp_async16(Bs + (s * 64 + r) * BP + u * 8, e < D ? wv + (int64_t)e * D + k0 + u * 8 : wv,
                 e < D);
    }
    cp_async_commit();
  };
  float acc[8][4] = {};
  const int nk = D / ATT_KB;
  stage(0, 0);
  for (int kb = 0; kb < nk; ++kb) {
    if (kb + 1 < nk) {
      stage((kb + 1) & 1, (kb + 1) * ATT_KB);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int s = kb & 1;
#pragma unroll
    for (int ks = 0; ks < ATT_KB / 16; ++ks) {
      uint32_t ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = warp * 16 + lane / 4 + 8 * (i & 1);
        const int col = ks * 16 + 2 * (lane % 4) + 8 * (i >> 1);
        float2 v = *reinterpret_cast<const float2*>(As + ((s * PARTS) * ATT_ROWS + r) * AP + col);
        if (PARTS == 2) {
          const float2 w =
              *reinterpret_cast<const float2*>(As + ((s * PARTS + 1) * ATT_ROWS + r) * AP + col);
          v.x += w.x;
          v.y += w.y;
        }
        const __nv_bfloat162 hi = __floats2bfloat162_rn(v.x, v.y);
        const float2 hf = __bfloat1622float2(hi);
        ah[i] = *reinterpret_cast<const uint32_t*>(&hi);
        al[i] = pack_bf16(v.x - hf.x, v.y - hf.y);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t b[4];
        ldmatrix_x4(b, Bs + (s * 64 + j * 16 + (lane & 7) + (lane >> 4) * 8) * BP + ks * 16 +
                           ((lane >> 3) & 1) * 8);
        mma_bf16(acc[2 * j], ah, b[0], b[1]);
        mma_bf16(acc[2 * j + 1], ah, b[2], b[3]);
        mma_bf16(acc[2 * j], al, b[0], b[1]);
        mma_bf16(acc[2 * j + 1], al, b[2], b[3]);
      }
    }
    __syncthreads();
  }
  const float* bv = bqkv + 2 * D;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int b = b0 + warp * 16 + lane / 4 + 8 * hf;
    if (b >= B) continue;
    float ptk = pt[(int64_t)b * PARTS * H + h];
    if (PARTS == 2) ptk += pt[((int64_t)b * PARTS + 1) * H + h];
    const float pcl = TOKENS ? pc[(int64_t)b * H + h] : 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = e0 + j * 8 + 2 * (lane % 4);
      if (col >= e1) continue;
      float v0 = acc[j][2 * hf] + ptk * bv[col], v1 = acc[j][2 * hf + 1] + ptk * bv[col + 1];
      if (TOKENS) {
        v0 += pcl * __bfloat162float(vc[col]);
        v1 += pcl * __bfloat162float(vc[col + 1]);
      }
      *reinterpret_cast<__nv_bfloat162*>(att + (int64_t)b * D + col) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
}

// att at SKINNY_ROWS groups or fewer: skinny_kernel's split of the work
// (one block per output column e, its warps a quarter of D each), A the
// group's Z row of e's head in f32 (the partials summed), W Wv's row e;
// f32 sums, one rounding.
template <bool TOKENS, int PARTS, int RM>
__global__ void __launch_bounds__(SKINNY_WARPS * 32)
att_skinny_kernel(const float* __restrict__ z, const float* __restrict__ pt,
                  const float* __restrict__ pc, const bf16* __restrict__ wqkv,
                  const float* __restrict__ bqkv, const bf16* __restrict__ vc,
                  bf16* __restrict__ att, int B, int D, int H) {
  __shared__ float part[SKINNY_WARPS][RM];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int e = blockIdx.x, h = e / (D / H), kw = D / SKINNY_WARPS, k0 = warp * kw;
  const bf16* wr = wqkv + (int64_t)(2 * D + e) * D;
  float acc[RM];
#pragma unroll
  for (int r = 0; r < RM; ++r) acc[r] = 0.f;
#pragma unroll 2
  for (int k = k0 + lane * 8; k < k0 + kw; k += 256) {
    float w[8];
    unpack8(__ldg(reinterpret_cast<const uint4*>(wr + k)), w);
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      if (r < B) {
        const float* zr = z + ((int64_t)r * PARTS * H + h) * D + k;
        float4 a0 = __ldg(reinterpret_cast<const float4*>(zr));
        float4 a1 = __ldg(reinterpret_cast<const float4*>(zr + 4));
        if (PARTS == 2) {
          const float4 c0 = __ldg(reinterpret_cast<const float4*>(zr + (int64_t)H * D));
          const float4 c1 = __ldg(reinterpret_cast<const float4*>(zr + (int64_t)H * D + 4));
          a0 = make_float4(a0.x + c0.x, a0.y + c0.y, a0.z + c0.z, a0.w + c0.w);
          a1 = make_float4(a1.x + c1.x, a1.y + c1.y, a1.z + c1.z, a1.w + c1.w);
        }
        acc[r] += a0.x * w[0] + a0.y * w[1] + a0.z * w[2] + a0.w * w[3] + a1.x * w[4] +
                  a1.y * w[5] + a1.z * w[6] + a1.w * w[7];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    if (r < B) {
      const float v = sft::warp_sum(acc[r]);
      if (lane == 0) part[warp][r] = v;
    }
  }
  __syncthreads();
  if (warp != 0) return;
  for (int r = lane; r < B; r += 32) {
    float v = part[0][r];
#pragma unroll
    for (int w = 1; w < SKINNY_WARPS; ++w) v += part[w][r];
    float ptk = pt[(int64_t)r * PARTS * H + h];
    if (PARTS == 2) ptk += pt[((int64_t)r * PARTS + 1) * H + h];
    v += ptk * bqkv[2 * D + e];
    if (TOKENS) v += pc[(int64_t)r * H + h] * __bfloat162float(vc[e]);
    att[(int64_t)r * D + e] = __float2bfloat16(v);
  }
}

// att_skinny_kernel with the least power of two >= B (from RT) as its rows
template <bool TOKENS, int PARTS, int RT>
int att_skinny(const Pool& p, const bf16* wqkv, const float* bqkv, const bf16* vc, bf16* att,
               cudaStream_t s) {
  if constexpr (RT < SKINNY_ROWS) {
    if (p.B > RT) return att_skinny<TOKENS, PARTS, 2 * RT>(p, wqkv, bqkv, vc, att, s);
  }
  att_skinny_kernel<TOKENS, PARTS, RT><<<p.D, SKINNY_WARPS * 32, 0, s>>>(p.z, p.pt, p.pc, wqkv,
                                                                       bqkv, vc, att, p.B, p.D,
                                                                       p.H);
  SFT_CHECK_LAUNCH();
  return 0;
}

// U, pool pass and Wv product for B groups of M rows; TOKENS: U, c and the
// CLS logits shared (u_stride / c_stride 0), vc the CLS value.
template <bool TOKENS>
int launch_pool(Pool p, int CL, const bf16* wqkv, const float* bqkv, const bf16* vc, bf16* att,
                cudaStream_t s) {
  const size_t smem = pool_smem(p.rows, p.D, p.H);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  const int blocks = (p.B + p.G - 1) / p.G * CL;
  static const bool attrs = [] {
    for (const void* k : {(const void*)pool_kernel<TOKENS, 1>, (const void*)pool_kernel<TOKENS, 2>,
                          (const void*)att_kernel<TOKENS, 1>, (const void*)att_kernel<TOKENS, 2>})
      cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    return true;
  }();
  (void)attrs;
  SFT_CHECK_LAUNCH();
  if (CL == 1) {
    pool_kernel<TOKENS, 1><<<blocks, THREADS, smem, s>>>(p);
  } else {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 2;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, pool_kernel<TOKENS, 2>, p);
    if (e != cudaSuccess) return (int)e;
  }
  SFT_CHECK_LAUNCH();
  if (p.B <= SKINNY_ROWS) {
    return CL == 1 ? att_skinny<TOKENS, 1, 2>(p, wqkv, bqkv, vc, att, s)
                      : att_skinny<TOKENS, 2, 2>(p, wqkv, bqkv, vc, att, s);
  }
  const int dh = p.D / p.H;
  const dim3 grid((p.B + ATT_ROWS - 1) / ATT_ROWS, p.H, (dh + 63) / 64);
  const size_t asmem =
      (size_t)2 * CL * ATT_ROWS * (ATT_KB + 8) * 4 + 2 * 64 * (ATT_KB + 8) * 2;
  if (CL == 1) {
    att_kernel<TOKENS, 1><<<grid, 128, asmem, s>>>(p.z, p.pt, p.pc, wqkv, bqkv, vc, att, p.B,
                                                   p.D, p.H);
  } else {
    att_kernel<TOKENS, 2><<<grid, 128, asmem, s>>>(p.z, p.pt, p.pc, wqkv, bqkv, vc, att, p.B,
                                                   p.D, p.H);
  }
  SFT_CHECK_LAUNCH();
  return 0;
}

// proj + residual (row r of R at R + r * r_stride), LN2, fc1 + GELU, fc2 +
// residual, with the groups as rows
int launch_tail(const bf16* att, const bf16* R, int64_t r_stride, const bf16* wp,
                const float* bp, const float* g2, const float* b2, const bf16* w1,
                const float* fb1, const bf16* w2, const float* fb2, bf16* y, bf16* ln2,
                bf16* hbuf, bf16* out, int B, int D, int hidden, float eps, cudaStream_t s) {
  int rc = product<sft::EPI_BIAS_RESIDUAL>(att, wp, bp, R, r_stride, y, B, D, D, s);
  if (rc != 0) return rc;
  sft::ln_rows(y, nullptr, g2, b2, ln2, B, D, eps, s);
  SFT_CHECK_LAUNCH();
  rc = product<sft::EPI_BIAS_GELU>(ln2, w1, fb1, nullptr, 0, hbuf, B, hidden, D, s);
  if (rc != 0) return rc;
  return product<sft::EPI_BIAS_RESIDUAL>(hbuf, w2, fb2, y, D, out, B, D, hidden, s);
}

// The plan's checks: G groups a block (CL 1; more than one only with a shared
// U), CL 1 or 2, rows >= 1, the shapes every kernel takes, and grids
// (pool_kernel's and u_kernel's, on gridDim.x) within 2^31 - 1 blocks.
bool bad_plan(int B, int M, int D, int H, int hidden, int G, int CL, int rows, bool shared_u) {
  return B < 1 || M < 1 || H < 1 || H > MAXH || D % H != 0 || D % 64 != 0 || hidden % 8 != 0 ||
         G < 1 || G > GMAX || (G > 1 && (!shared_u || CL != 1)) || (CL != 1 && CL != 2) ||
         (CL == 2 && M < 2) || rows < 1 || (int64_t)(B + G - 1) / G * CL > INT_MAX ||
         (int64_t)(B + U_ROWS - 1) / U_ROWS * (D / U_COLS) > INT_MAX;
}

}  // namespace

// K4. Scratch: wb bf16 [LN1(cls) D | q, k_cls, v_cls 3D | U hi H*D | U lo
// H*D]; wf f32 [Z B*CL*H*D | c H | lc H | ptok B*CL*H | p_cls B*H]; att, y,
// ln2 bf16 (B, D); hbuf bf16 (B, hidden). The plan: G, CL, rows
// (ops/kernels/_build.py::cls_pool_plan).
extern "C" int sft_cls_pool_tokens(const void* x, const void* cls, const void* g1,
                                   const void* b1, const void* wqkv, const void* bqkv,
                                   const void* wp, const void* bp, const void* g2,
                                   const void* b2, const void* w1, const void* fb1,
                                   const void* w2, const void* fb2, void* wb, void* wf,
                                   void* att, void* y, void* ln2, void* hbuf, void* out, int B,
                                   int M, int D, int H, int hidden, int G, int CL, int rows,
                                   float eps, void* stream) {
  if (bad_plan(B, M, D, H, hidden, G, CL, rows, true)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* wq = static_cast<const bf16*>(wqkv);
  const float* bq = static_cast<const float*>(bqkv);
  bf16* lnc = static_cast<bf16*>(wb);
  bf16* qkvc = lnc + D;
  bf16* uhi = qkvc + 3 * D;
  bf16* ulo = uhi + (int64_t)H * D;
  float* z = static_cast<float*>(wf);
  float* c = z + (int64_t)B * CL * H * D;
  float* lc = c + H;
  float* pt = lc + H;
  float* pc = pt + (int64_t)B * CL * H;

  ln_row0_kernel<<<1, THREADS, 0, s>>>(static_cast<const bf16*>(cls), 0,
                                       static_cast<const float*>(g1),
                                       static_cast<const float*>(b1), lnc, 1, D, eps);
  SFT_CHECK_LAUNCH();
  int rc = product<sft::EPI_BIAS>(lnc, wq, bq, nullptr, 0, qkvc, 1, 3 * D, D, s);
  if (rc != 0) return rc;
  u_kernel<<<dim3(D / U_COLS, H), 128, 0, s>>>(qkvc, 0, wq, bq, qkvc + D, uhi, ulo, c, lc, 1, D,
                                               H);
  SFT_CHECK_LAUNCH();
  const Pool p{static_cast<const bf16*>(x), static_cast<const float*>(g1),
               static_cast<const float*>(b1), uhi, ulo, 0, c, 0, lc, z, pt, pc, B, M, D, H, G,
               rows, eps, 1.0f / sqrtf((float)(D / H))};
  rc = launch_pool<true>(p, CL, wq, bq, qkvc + 2 * D, static_cast<bf16*>(att), s);
  if (rc != 0) return rc;
  return launch_tail(static_cast<const bf16*>(att), static_cast<const bf16*>(cls), 0,
                     static_cast<const bf16*>(wp), static_cast<const float*>(bp),
                     static_cast<const float*>(g2), static_cast<const float*>(b2),
                     static_cast<const bf16*>(w1), static_cast<const float*>(fb1),
                     static_cast<const bf16*>(w2), static_cast<const float*>(fb2),
                     static_cast<bf16*>(y), static_cast<bf16*>(ln2), static_cast<bf16*>(hbuf),
                     static_cast<bf16*>(out), B, D, hidden, eps, s);
}

// K4b. Scratch: wb bf16 [LN1(x_0) B*D | q B*D | U hi B*H*D | U lo B*H*D]; wf
// f32 [Z B*CL*H*D | c B*H | ptok B*CL*H]; att, y, ln2 bf16 (B, D); hbuf bf16
// (B, hidden). The plan as K4's, with G = 1.
extern "C" int sft_cls_pool(const void* x, const void* g1, const void* b1, const void* wqkv,
                            const void* bqkv, const void* wp, const void* bp, const void* g2,
                            const void* b2, const void* w1, const void* fb1, const void* w2,
                            const void* fb2, void* wb, void* wf, void* att, void* y, void* ln2,
                            void* hbuf, void* out, int B, int N, int D, int H, int hidden, int G,
                            int CL, int rows, float eps, void* stream) {
  if (bad_plan(B, N, D, H, hidden, G, CL, rows, false)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wq = static_cast<const bf16*>(wqkv);
  const float* bq = static_cast<const float*>(bqkv);
  bf16* ln0 = static_cast<bf16*>(wb);
  bf16* q = ln0 + (int64_t)B * D;
  bf16* uhi = q + (int64_t)B * D;
  bf16* ulo = uhi + (int64_t)B * H * D;
  float* z = static_cast<float*>(wf);
  float* c = z + (int64_t)B * CL * H * D;
  float* pt = c + (int64_t)B * H;
  const int64_t gstride = (int64_t)N * D;

  ln_row0_kernel<<<(B + THREADS / 32 - 1) / (THREADS / 32), THREADS, 0, s>>>(
      xb, gstride, static_cast<const float*>(g1), static_cast<const float*>(b1), ln0, B, D, eps);
  SFT_CHECK_LAUNCH();
  int rc = product<sft::EPI_BIAS>(ln0, wq, bq, nullptr, 0, q, B, D, D, s);
  if (rc != 0) return rc;
  u_kernel<<<dim3((B + U_ROWS - 1) / U_ROWS * (D / U_COLS), H), 128, 0, s>>>(
      q, D, wq, bq, nullptr, uhi, ulo, c, nullptr, B, D, H);
  SFT_CHECK_LAUNCH();
  const Pool p{xb, static_cast<const float*>(g1), static_cast<const float*>(b1), uhi, ulo,
               (int64_t)H * D, c, H, nullptr, z, pt, nullptr, B, N, D, H, G, rows, eps,
               1.0f / sqrtf((float)(D / H))};
  rc = launch_pool<false>(p, CL, wq, bq, nullptr, static_cast<bf16*>(att), s);
  if (rc != 0) return rc;
  return launch_tail(static_cast<const bf16*>(att), xb, gstride, static_cast<const bf16*>(wp),
                     static_cast<const float*>(bp), static_cast<const float*>(g2),
                     static_cast<const float*>(b2), static_cast<const bf16*>(w1),
                     static_cast<const float*>(fb1), static_cast<const bf16*>(w2),
                     static_cast<const float*>(fb2), static_cast<bf16*>(y),
                     static_cast<bf16*>(ln2), static_cast<bf16*>(hbuf), static_cast<bf16*>(out),
                     B, D, hidden, eps, s);
}
