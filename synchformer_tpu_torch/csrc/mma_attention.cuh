// Tensor-core attention over rows read in place from a packed [q|k|v]
// projection: the kernel of K3 (csrc/standard_attention.cu) and of the space
// pass of the divided attention (csrc/divided_attention.cuh, mode 0), which
// K1, K5, K7a/K7b and K8a share.
//
// It replaces the CUDA-core bodies the first ports had (each warp one query
// row at a time, scalar logits, P @ V two columns a lane: about 8-9 TFLOP/s,
// slower than one scaled_dot_product_attention call). Both products run on
// mma.sync.m16n8k16 (bf16 in, f32 accumulation). The attentions here are
// short: N = 74 keys for the AST, 197 for a frame. mma.sync's 16-row tiles
// pad them by 8% and 6%; wgmma's 64-row tiles would pad 197 to 256.
//
// One block per (head, group, segment) and part of the group's query tiles
// (at most MAX_WARPS; a group of 196 queries is 13 tiles, two blocks of 7):
// - every thread stages the block's query rows, then a chunk of up to 16 * KT
//   key and value rows, into shared memory with 16-byte cp.async (rows past
//   the last are zero-filled, never read); V arrives in its own group, so
//   Q K^T runs while it is in flight;
// - each warp owns one 16-row query tile: Q fragments by ldmatrix (scaled in
//   f32 and rounded to bf16 there), K fragments by ldmatrix, V by
//   ldmatrix.trans; S = Q K^T for the whole chunk stays in registers (key
//   columns past the last are -inf), the row max and sum go by quad shuffles,
//   and the probabilities are packed from the S accumulators straight into the
//   A fragments of P V: nothing round-trips shared memory;
// - a group with more keys than a chunk (more than 207 patches a frame, or K3
//   past 80 tokens) takes two sweeps over the chunks: the first for the exact
//   row max (K3: also the row sum, rescaled as the max grows), the second for
//   P V with the same numerics as one sweep. There is no cap on the keys.
//
// Head widths: DH, the template parameter, is the width the tiles are built
// for (a multiple of 16: mma.sync's k-step); the true head_dim dh (a multiple
// of 8, at most DH) is a runtime value. Rows are read at dh's stride and each
// row is staged with its columns past dh zero-filled by cp.async (nothing is
// read there, so no lane of the next head enters), which adds nothing to
// Q K^T and gives zero output columns, which are not stored. The callers
// instantiate a few widths and round dh up to the next one
// (divided_attention.cuh::dispatch_attention, standard_attention.cu).
//
// Numerics, two recipes:
// - CLS_KEY (divided attention, synchformer_tpu/ops/pallas/divided_attention.py
//   :60-72, _space_segment; :254-283, _space_pair_v3): key 0 is the CLS row;
//   the row max is taken over [CLS; group]; ep = exp(s - m) is rounded to
//   bf16 unnormalised for P V; the CLS key's term ec * v0 stays f32, outside
//   the product; one division by sum(ep) + ec (f32) at the end.
// - otherwise (K3, synchformer_tpu/ops/pallas/standard_attention.py:44-57):
//   the softmax is normalised in f32, then rounded to bf16 for P V.
// Both scale q by its dh^-0.5 in f32 and round it to bf16, and take f32
// logits.
#pragma once

#include "tile_gemm.cuh"

namespace sft {

// 16 bytes global -> shared, asynchronous; with valid false the 16 bytes are
// zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid = true) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

namespace tc {

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t x, float s) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
  return pack_bf16(f.x * s, f.y * s);
}

// the max / sum over the four lanes that hold one accumulator row
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

constexpr int MAX_WARPS = 8;  // query tiles of 16 rows a block, a warp each

// The widths the attention kernels (this one, the divided attention's time
// pass and CLS rows, their backward) are built for: a head_dim dh, a
// multiple of 8 up to 256, runs at the least of them that holds it (0: none
// does). Multiples of 32, for the time pass's four lanes of 16-byte pieces.
constexpr int MAX_DH = 256;

inline int padded_width(int dh) {
  if (dh < 8 || dh % 8 != 0) return 0;
  const int widths[] = {32, 64, 96, 128, 192, 256};
  for (int w : widths)
    if (dh <= w) return w;
  return 0;
}

// One launch: per segment (grid z) and group (grid y) of each head, nq query
// rows against [CLS;] nq key / value rows. Query / key / value i of a group
// is row qkv_p + (seg * in_seg + grp * grp_rows + i) * 3D (+0 / +D / +2D,
// + h * dh), D = H * dh; with CLS_KEY, key 0 is qkv_c + seg * in_c * 3D.
// Output row i: out + (seg * out_seg + grp * grp_rows + i) * D + h * dh.
// parts, tiles and kv_rows are set by launch().
struct Problem {
  const bf16* qkv_p;
  const bf16* qkv_c;
  bf16* out;
  long long in_seg, in_c, out_seg;
  int grp_rows, nq, H;
  int dh;  // the head_dim: a multiple of 8, at most the kernel's DH
  int parts;  // blocks over a group's query tiles (grid x = H * parts)
  int tiles;    // query tiles of a block = its warps
  int kv_rows;  // rows of each key / value chunk buffer
  float scale;
};

template <int DH, int KT>
__device__ __forceinline__ void qk_chunk(float (&s)[2 * KT][4], const bf16* qw, const bf16* Ks,
                                         int ntk, float scale, int lane) {
  constexpr int PITCH = DH + 8;
#pragma unroll
  for (int n = 0; n < 2 * KT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks) {
    uint32_t a[4];
    ldmatrix_x4(a, qw + (lane & 15) * PITCH + ks * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = scale_bf16x2(a[i], scale);
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      if (kt < ntk) {
        uint32_t b[4];
        ldmatrix_x4(b, Ks + (kt * 16 + (lane & 7) + (lane >> 4) * 8) * PITCH + ks * 16 +
                           ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * kt], a, b[0], b[1]);
        mma_bf16(s[2 * kt + 1], a, b[2], b[3]);
      }
    }
  }
}

template <int DH, int KT>
__device__ __forceinline__ void pv_chunk(float (&o)[DH / 8][4], const float (&s)[2 * KT][4],
                                         const bf16* Vs, int ntk, int lane) {
  constexpr int PITCH = DH + 8;
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    if (kk < ntk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int jj = 0; jj < DH / 16; ++jj) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, Vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * PITCH +
                                 jj * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * jj], a, b[0], b[1]);
        mma_bf16(o[2 * jj + 1], a, b[2], b[3]);
      }
    }
  }
}

// EXACT: p.dh == DH, compiled as a constant (the main path's head widths).
template <int DH, int KT, bool CLS_KEY, bool EXACT>
__global__ void __launch_bounds__(MAX_WARPS * 32)
attention_kernel(const Problem p) {
  constexpr int PITCH = DH + 8;  // bf16; an odd count of 16-byte units: ldmatrix conflict-free
  constexpr int KC = 16 * KT;    // keys of a chunk
  constexpr int CPR = DH / 8;    // 16-byte pieces of a staged row
  constexpr int NC = CLS_KEY ? 1 : 0;
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x / p.parts, part = blockIdx.x % p.parts;
  const int dh = EXACT ? DH : p.dh, D = p.H * dh;
  const int cpr = dh / 8;  // pieces of a row that hold the head's columns
  const int nk = p.nq + NC;
  const int q0 = part * p.tiles * 16;  // the block's first query row
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + p.tiles * 16 * PITCH;
  bf16* Vs = Ks + p.kv_rows * PITCH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long long grp0 = (long long)blockIdx.y * p.grp_rows;
  const bf16* pin = p.qkv_p + ((long long)blockIdx.z * p.in_seg + grp0) * 3 * D + h * dh;
  const bf16* crow = CLS_KEY ? p.qkv_c + (long long)blockIdx.z * p.in_c * 3 * D + h * dh : pin;
  bf16* pout = p.out + ((long long)blockIdx.z * p.out_seg + grp0) * D + h * dh;

  // key / value rows [k0, k0 + rows) of the group into the chunk buffers,
  // zero past the last row and past column dh
  auto stage_kv = [&](bf16* dst, int off, int k0, int rows) {
    for (int idx = tid; idx < rows * CPR; idx += blockDim.x) {
      const int r = idx / CPR, c = idx % CPR, j = k0 + r;
      const bool ok = j < nk && c < cpr;
      const bf16* src = j < NC ? crow : pin + (long long)(j - NC) * 3 * D;
      cp_async16(dst + r * PITCH + c * 8, ok ? src + off + c * 8 : pin, ok);
    }
  };

  const bool active = q0 + warp * 16 < p.nq;
  const bf16* qw = Qs + warp * 16 * PITCH;
  const int nch = (nk + KC - 1) / KC;
  float s[2 * KT][4];
  float o[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  // rows g and g + 8 of the warp's tile: max, sum (per lane until reduced)
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int idx = tid; idx < p.tiles * 16 * CPR; idx += blockDim.x) {
    const int r = idx / CPR, c = idx % CPR, i = q0 + r;
    const bool ok = i < p.nq && c < cpr;
    cp_async16(Qs + r * PITCH + c * 8, ok ? pin + (long long)i * 3 * D + c * 8 : pin, ok);
  }
  // sweep 0 (more than one chunk only): the row max (K3: and sum);
  // sweep 1: the probabilities and P V
  for (int sweep = nch > 1 ? 0 : 1; sweep < 2; ++sweep) {
    for (int c = 0; c < nch; ++c) {
      const int k0 = c * KC, ntk = (min(KC, nk - k0) + 15) / 16;
      __syncthreads();  // the chunk buffers' last readers are done
      stage_kv(Ks, D, k0, ntk * 16);
      cp_async_commit();
      if (sweep == 1) {
        stage_kv(Vs, 2 * D, k0, ntk * 16);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      float ec0 = 0.f, ec1 = 0.f;
      if (active) {
        qk_chunk<DH, KT>(s, qw, Ks, ntk, p.scale, lane);
        float cm0 = -INFINITY, cm1 = -INFINITY;
#pragma unroll
        for (int n = 0; n < 2 * KT; ++n) {
          const int j = k0 + 8 * n + 2 * t;
          if (j >= nk) s[n][0] = s[n][2] = -INFINITY;
          if (j + 1 >= nk) s[n][1] = s[n][3] = -INFINITY;
          cm0 = fmaxf(cm0, fmaxf(s[n][0], s[n][1]));
          cm1 = fmaxf(cm1, fmaxf(s[n][2], s[n][3]));
        }
        cm0 = quad_max(cm0);
        cm1 = quad_max(cm1);
        if (sweep == 0) {
          const float n0 = fmaxf(m0, cm0), n1 = fmaxf(m1, cm1);
          if (!CLS_KEY) {  // the sum, rescaled to the new max (f32)
            float e0 = 0.f, e1 = 0.f;
#pragma unroll
            for (int n = 0; n < 2 * KT; ++n) {
              e0 += __expf(s[n][0] - n0) + __expf(s[n][1] - n0);
              e1 += __expf(s[n][2] - n1) + __expf(s[n][3] - n1);
            }
            l0 = l0 * __expf(m0 - n0) + e0;
            l1 = l1 * __expf(m1 - n1) + e1;
          }
          m0 = n0;
          m1 = n1;
        } else {
          if (nch == 1) {
            m0 = cm0;
            m1 = cm1;
          }
          float e0 = 0.f, e1 = 0.f;
#pragma unroll
          for (int n = 0; n < 2 * KT; ++n) {
            s[n][0] = __expf(s[n][0] - m0);
            s[n][1] = __expf(s[n][1] - m0);
            s[n][2] = __expf(s[n][2] - m1);
            s[n][3] = __expf(s[n][3] - m1);
            e0 += s[n][0] + s[n][1];
            e1 += s[n][2] + s[n][3];
          }
          if (CLS_KEY) {
            l0 += e0;  // the CLS key's ec included
            l1 += e1;
            if (c == 0) {  // key 0 is the CLS row: lane 4g holds its ec
              ec0 = __shfl_sync(0xffffffffu, s[0][0], lane & ~3);
              ec1 = __shfl_sync(0xffffffffu, s[0][2], lane & ~3);
              if (t == 0) s[0][0] = s[0][2] = 0.f;
            }
          } else {
            if (nch == 1) {
              l0 = quad_sum(e0);
              l1 = quad_sum(e1);
            }
            const float i0 = 1.f / l0, i1 = 1.f / l1;
#pragma unroll
            for (int n = 0; n < 2 * KT; ++n) {
              s[n][0] *= i0;
              s[n][1] *= i0;
              s[n][2] *= i1;
              s[n][3] *= i1;
            }
          }
        }
      }
      if (sweep == 1) {
        cp_async_wait<0>();
        __syncthreads();
        if (active) {
          if (CLS_KEY && c == 0) {  // o = ec * v0 in f32, then += P V
#pragma unroll
            for (int j = 0; j < DH / 8; ++j) {
              const float2 v0 = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(Vs + 8 * j + 2 * t));
              o[j][0] += ec0 * v0.x;
              o[j][1] += ec0 * v0.y;
              o[j][2] += ec1 * v0.x;
              o[j][3] += ec1 * v0.y;
            }
          }
          pv_chunk<DH, KT>(o, s, Vs, ntk, lane);
        }
      }
    }
    if (sweep == 0 && !CLS_KEY) {
      l0 = quad_sum(l0);
      l1 = quad_sum(l1);
    }
  }
  if (!active) return;
  float i0 = 1.f, i1 = 1.f;
  if (CLS_KEY) {  // the one division, by sum(ep) + ec
    i0 = 1.f / quad_sum(l0);
    i1 = 1.f / quad_sum(l1);
  }
  const int r0 = q0 + warp * 16 + g;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    if (j >= cpr) continue;  // the zero columns past dh
    if (r0 < p.nq)
      *reinterpret_cast<__nv_bfloat162*>(pout + (long long)r0 * D + 8 * j + 2 * t) =
          __floats2bfloat162_rn(o[j][0] * i0, o[j][1] * i0);
    if (r0 + 8 < p.nq)
      *reinterpret_cast<__nv_bfloat162*>(pout + (long long)(r0 + 8) * D + 8 * j + 2 * t) =
          __floats2bfloat162_rn(o[j][2] * i1, o[j][3] * i1);
  }
}

// Launches attention_kernel over ``groups`` groups of ``segs`` segments; sets
// p.parts, p.tiles and p.kv_rows. Returns cudaGetLastError().
template <int DH, int KT, bool CLS_KEY>
int launch(Problem p, int groups, int segs, cudaStream_t s) {
  const int ntq = (p.nq + 15) / 16;
  p.parts = (ntq + MAX_WARPS - 1) / MAX_WARPS;
  p.tiles = (ntq + p.parts - 1) / p.parts;
  const int nk = p.nq + (CLS_KEY ? 1 : 0);
  p.kv_rows = nk < 16 * KT ? (nk + 15) / 16 * 16 : 16 * KT;
  const size_t smem = (size_t)(p.tiles * 16 + 2 * p.kv_rows) * (DH + 8) * sizeof(bf16);
  auto kern = p.dh == DH ? attention_kernel<DH, KT, CLS_KEY, true>
                         : attention_kernel<DH, KT, CLS_KEY, false>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  SFT_CHECK_LAUNCH();
  kern<<<dim3(p.H * p.parts, groups, segs), p.tiles * 32, smem, s>>>(p);
  SFT_CHECK_LAUNCH();
  return 0;
}

}  // namespace tc
}  // namespace sft
