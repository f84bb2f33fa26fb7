// K6: backward of K5, the split-layout divided space-time attention; K7c:
// the same backward on the packed layout.
//
// K6 replaces synchformer_tpu/ops/pallas/divided_attention_bwd.py::
// _divided_attention_bwd_4d (body _bwd_kernel_4d with _cls_row_bwd_4d,
// _space_bwd_pair_4d, _time_bwd_pair_4d); K7c replaces
// _divided_attention_bwd_pallas (_space_bwd_kernel, _time_bwd_kernel,
// _cls_row_bwd), the backward of the Motionformer's packed flow.
// Recompute-based, as there: only the qkv inputs are saved by the forward,
// the softmax is rebuilt in f32.
//
// Layouts, as the forward (divided_attention.cu): split patches (B, f, n, 3D)
// and CLS (B, 1, 3D) with cotangents (B, f, n, D) and (B, 1, D); packed qkv
// (B, 1 + f*n, 3D) with cotangent (B, 1 + f*n, D). dqkv follows qkv's layout.
// Every kernel takes a patch base and a CLS base per tensor and the rows from
// one segment to the next, so the packed tensors are read and written in
// place; the packed dqkv is one buffer whose CLS and patch rows different
// kernels write, each only its own rows.
//
// Numerics, per head (head_dim DH in {32, 64, 96, 128}, a template
// parameter), as the JAX body:
// - q is pre-scaled by DH^-0.5 and rounded to bf16; dq is scaled once more
//   at the end;
// - p over [CLS; group] in f32, sigma = sum(p * dp) with dp = <do, v> in f32,
//   the CLS column included;
// - ds is rounded to bf16 before the dq / dk products, p to bf16 before the
//   dv product; the CLS key's ds and p stay f32;
// - every patch's dk / dv sums the group term and the CLS-query term in f32
//   and is rounded to bf16 once.
//
// The CLS token plays three roles: (a) a query over all 1 + f*n keys, (b) a
// key/value joined to every group, (c) through (a), a source of dk / dv on
// every patch. On the TPU one grid step held a whole segment, so the sums over
// groups stayed in VMEM; here blocks run in no order, so:
// (1) cls_bwd_kernel, one block per (head, batch): role (a), a thread per
//     key row for the logits and dp (16-byte loads). It writes dq of
//     the CLS row, its own dk/dv of the CLS key and value to an f32 scratch,
//     and, for every patch, the bf16-rounded ds and p of the CLS query over
//     that patch (two f32 scalars per (batch, head, patch)). Those are all
//     the (c) terms need: dk_j += ds_j q_cls, dv_j += p_j do_cls.
// (2) the group terms and role (b), in time mode by group_bwd_kernel on CUDA
//     cores, in space mode by space_bwd_tc_kernel on the tensor cores (its
//     comment below). group_bwd_kernel: one block per (head, chunk of GPB
//     groups, batch), as a time-mode group (8 queries over 9 keys) is too
//     small for a block of its own. The chunk's Q,
//     K, V and dO rows sit in shared memory with a padded pitch. Pass 1, one
//     warp per query row: logits and dp one key per lane, f32 softmax and
//     sigma by shuffles, dq in pairs of columns per lane; it keeps (max,
//     1/sum, sigma) of the row. Pass 2, one warp per key row: recomputes p
//     and ds one query per lane from those statistics, then dk / dv in pairs
//     of columns per lane, adds the (c) terms from (1) and rounds once. The
//     CLS key's partial dk / dv over the chunk go to an f32 scratch, one slot
//     per chunk.
// (3) cls_reduce_kernel, one block per (head, batch): sums the CLS key's
//     partials in a fixed order. No atomics: the gradient is deterministic.
// Bound at Stage I's 28 segments: the ~472 MB it moves (qkv and dO in, dqkv
// out), ~0.14 ms. The space call's ~67 GFLOP of products go to the tensor
// cores, through WMMA tiles staged in shared memory; the time call's ~3 GFLOP
// stay on CUDA cores.
#include "tile_gemm.cuh"

using sft::bf16;

namespace {

constexpr int CLS_THREADS = 256;
constexpr int KEYS_IN_FLIGHT = 4;  // loads a CLS-row warp starts before it sums
constexpr int WARPS = 16;
constexpr int GPB = 16;  // time-mode groups per block of group_bwd_kernel

template <int DH>
__device__ __forceinline__ float dot_smem_bf16(const float* __restrict__ a,
                                               const bf16* __restrict__ row) {
  const __nv_bfloat162* r = reinterpret_cast<const __nv_bfloat162*>(row);
  float s = 0.f;
#pragma unroll 8
  for (int t = 0; t < DH / 2; ++t) {
    const float2 v = __bfloat1622float2(r[t]);
    s += a[2 * t] * v.x + a[2 * t + 1] * v.y;
  }
  return s;
}

template <bool MAX>
__device__ float block_reduce(float v, float* red) {
  v = MAX ? sft::warp_max(v) : sft::warp_sum(v);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, nw = blockDim.x / 32;
  __syncthreads();  // earlier readers of red are done
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < nw; ++w) r = MAX ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

// Row strides between segments, in rows: p / c of the patch / CLS rows of
// qkv and dqkv, op / oc of the patch / CLS rows of the cotangent.
struct Strides {
  int p, c, op, oc;
};

// (1) The CLS query of (b, h) over [CLS; all f*n patches].
template <int DH>
__global__ void __launch_bounds__(CLS_THREADS)
cls_bwd_kernel(const bf16* __restrict__ qkv_p, const bf16* __restrict__ qkv_c,
               const bf16* __restrict__ doc, float* __restrict__ ds_cls,
               float* __restrict__ p_cls, float* __restrict__ cls_part,
               bf16* __restrict__ dqkv_c, int fn, int H, Strides st, float scale) {
  constexpr int NP = (DH / 2 + 31) / 32;  // bf16 pairs of a row per lane
  constexpr bool FULL = (DH / 2) % 32 == 0;  // every lane holds NP pairs
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int D = H * DH;
  const int nk = fn + 1;
  float* qs = reinterpret_cast<float*>(smem);  // DH
  float* dos = qs + DH;                         // DH
  float* red = dos + DH;                        // 32
  float* sc = red + 32;                         // 2: ds and p of the CLS key
  float* acc = sc + 2;                          // (CLS_THREADS / 32) x DH
  float* sv = acc + (CLS_THREADS / 32) * DH;    // nk: logits, then p, then ds
  float* dpv = sv + nk;                         // nk: dp
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const bf16* crow = qkv_c + (int64_t)b * st.c * 3 * D;
  const bf16* prow0 = qkv_p + (int64_t)b * st.p * 3 * D;
  const int64_t bh = (int64_t)b * H + h;

  if (tid < DH) {
    qs[tid] = sft::bf16r(__bfloat162float(crow[h * DH + tid]) * scale);
    dos[tid] = __bfloat162float(doc[(int64_t)b * st.oc * D + h * DH + tid]);
  }
  __syncthreads();

  float m = -INFINITY;
  for (int j = tid; j < nk; j += CLS_THREADS) {
    const bf16* row = j == 0 ? crow : prow0 + (int64_t)(j - 1) * 3 * D;
    const float s = sft::dot_row_bf16<DH>(qs, row + D + h * DH);
    sv[j] = s;
    dpv[j] = sft::dot_row_bf16<DH>(dos, row + 2 * D + h * DH);
    m = fmaxf(m, s);
  }
  m = block_reduce<true>(m, red);
  float sum = 0.f;
  for (int j = tid; j < nk; j += CLS_THREADS) {
    const float e = __expf(sv[j] - m);
    sv[j] = e;
    sum += e;
  }
  const float inv = 1.f / block_reduce<false>(sum, red);
  float sig = 0.f;
  for (int j = tid; j < nk; j += CLS_THREADS) {
    const float p = sv[j] * inv;
    sv[j] = p;
    sig += p * dpv[j];
  }
  sig = block_reduce<false>(sig, red);
  for (int j = tid; j < nk; j += CLS_THREADS) {
    const float p = sv[j];
    const float ds = p * (dpv[j] - sig);
    if (j == 0) {
      sc[0] = ds;
      sc[1] = p;
      sv[0] = ds;
    } else {
      const float dsr = sft::bf16r(ds);
      sv[j] = dsr;
      ds_cls[bh * fn + j - 1] = dsr;
      p_cls[bh * fn + j - 1] = sft::bf16r(p);
    }
  }
  __syncthreads();

  // dq of the CLS row: warps take keys j = warp, warp + 8, ...; each lane a
  // pair of columns, one sweep over the keys per pair, KEYS_IN_FLIGHT keys
  // loaded before they are summed (as the forward's CLS row)
#pragma unroll
  for (int u = 0; u < NP; ++u) {
    const int t = lane + 32 * u;
    if (FULL || t < DH / 2) {
      float a0 = 0.f, a1 = 0.f;
      constexpr int STEP = CLS_THREADS / 32;
      for (int j0 = warp; j0 < nk; j0 += STEP * KEYS_IN_FLIGHT) {
        float2 kv[KEYS_IN_FLIGHT];
#pragma unroll
        for (int k = 0; k < KEYS_IN_FLIGHT; ++k) {
          const int j = j0 + k * STEP;
          const bf16* row = j == 0 ? crow : prow0 + (int64_t)(j - 1) * 3 * D;
          kv[k] = j < nk ? __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(
                               row + D + h * DH)[t])
                         : make_float2(0.f, 0.f);
        }
#pragma unroll
        for (int k = 0; k < KEYS_IN_FLIGHT; ++k) {
          const int j = j0 + k * STEP;
          if (j < nk) {
            a0 += sv[j] * kv[k].x;
            a1 += sv[j] * kv[k].y;
          }
        }
      }
      acc[warp * DH + 2 * t] = a0;
      acc[warp * DH + 2 * t + 1] = a1;
    }
  }
  __syncthreads();
  if (tid < DH) {
    float s = 0.f;
    for (int w = 0; w < CLS_THREADS / 32; ++w) s += acc[w * DH + tid];
    dqkv_c[(int64_t)b * st.c * 3 * D + h * DH + tid] = __float2bfloat16(s * scale);
    cls_part[bh * 2 * DH + tid] = sc[0] * qs[tid];
    cls_part[bh * 2 * DH + DH + tid] = sc[1] * dos[tid];
  }
}

// (2) Time mode: groups [g0, g0 + GPB) of (b, h), a group per spatial
// position, its L = f members one per frame. Member i of group g is patch
// i*n + g of its segment; its key row in shared memory is 1 + (g - g0)*L + i,
// row 0 is the CLS key. Writes dq, dk, dv of every member.
template <int DH>
__global__ void __launch_bounds__(WARPS * 32)
group_bwd_kernel(const bf16* __restrict__ qkv_p, const bf16* __restrict__ qkv_c,
                 const bf16* __restrict__ dop, const bf16* __restrict__ doc,
                 const float* __restrict__ ds_cls, const float* __restrict__ p_cls,
                 float* __restrict__ cls_part_g, bf16* __restrict__ dqkv_p, int L, int n,
                 int H, Strides st, float scale) {
  constexpr int PITCH = DH + 2;  // bf16 row pitch: an odd number of words
  constexpr int NP = (DH / 2 + 31) / 32;  // bf16 pairs of a row per lane
  constexpr bool FULL = (DH / 2) % 32 == 0;  // every lane holds NP pairs
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x, chunk = blockIdx.y, b = blockIdx.z;
  const int D = H * DH;
  const int fn = L * n;
  const int g0 = chunk * GPB;
  const int ng = min(GPB, n - g0);
  const int rows = ng * L;  // queries, and patch keys
  const int nk = L + 1;
  const int cap = GPB * L;
  bf16* Ks = reinterpret_cast<bf16*>(smem);  // (1 + cap) x PITCH
  bf16* Vs = Ks + (1 + cap) * PITCH;
  bf16* Qs = Vs + (1 + cap) * PITCH;  // cap x PITCH, unscaled
  bf16* Os = Qs + cap * PITCH;        // cap x PITCH
  float* row_m = reinterpret_cast<float*>(Os + cap * PITCH);  // cap
  float* row_inv = row_m + cap;                               // cap
  float* row_sig = row_inv + cap;                             // cap
  float* row_dsc = row_sig + cap;                             // cap: ds of the CLS key
  float* row_pc = row_dsc + cap;                              // cap: p of the CLS key
  float* qcs = row_pc + cap;                                  // DH: scaled CLS query
  float* docs = qcs + DH;                                     // DH: CLS cotangent
  float* wbuf = docs + DH;                                    // WARPS x (2 DH + 2 nk)
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int64_t bh = (int64_t)b * H + h;
  const bf16* pin = qkv_p + (int64_t)b * st.p * 3 * D;
  const bf16* pdo = dop + (int64_t)b * st.op * D;
  bf16* pdq = dqkv_p + (int64_t)b * st.p * 3 * D;
  const bf16* crow = qkv_c + (int64_t)b * st.c * 3 * D;

  for (int idx = tid; idx < (1 + rows) * (DH / 2); idx += blockDim.x) {
    const int r = idx / (DH / 2), t = idx % (DH / 2);
    const bf16* row;
    if (r == 0) {
      row = crow;
    } else {
      const int gl = (r - 1) / L, i = (r - 1) % L;
      const int64_t li = (int64_t)i * n + g0 + gl;
      row = pin + li * 3 * D;
      reinterpret_cast<__nv_bfloat162*>(Qs + (r - 1) * PITCH)[t] =
          reinterpret_cast<const __nv_bfloat162*>(row + h * DH)[t];
      reinterpret_cast<__nv_bfloat162*>(Os + (r - 1) * PITCH)[t] =
          reinterpret_cast<const __nv_bfloat162*>(pdo + li * D + h * DH)[t];
    }
    reinterpret_cast<__nv_bfloat162*>(Ks + r * PITCH)[t] =
        reinterpret_cast<const __nv_bfloat162*>(row + D + h * DH)[t];
    reinterpret_cast<__nv_bfloat162*>(Vs + r * PITCH)[t] =
        reinterpret_cast<const __nv_bfloat162*>(row + 2 * D + h * DH)[t];
  }
  if (tid < DH) {
    qcs[tid] = sft::bf16r(__bfloat162float(crow[h * DH + tid]) * scale);
    docs[tid] = __bfloat162float(doc[(int64_t)b * st.oc * D + h * DH + tid]);
  }
  __syncthreads();

  float* va = wbuf + warp * (2 * DH + 2 * nk);  // DH
  float* vb = va + DH;                          // DH
  float* sa = vb + DH;                          // nk
  float* sb = sa + nk;                          // nk

  // pass 1: query rows
  for (int r = warp; r < rows; r += WARPS) {
    const int gl = r / L;
    const bf16* qrow = Qs + r * PITCH;
    const bf16* orow = Os + r * PITCH;
    for (int d = lane; d < DH; d += 32) {
      va[d] = sft::bf16r(__bfloat162float(qrow[d]) * scale);
      vb[d] = __bfloat162float(orow[d]);
    }
    __syncwarp();
    float m = -INFINITY;
    for (int kk = lane; kk < nk; kk += 32) {
      const int kr = kk == 0 ? 0 : 1 + gl * L + kk - 1;
      const float s = dot_smem_bf16<DH>(va, Ks + kr * PITCH);
      sa[kk] = s;
      sb[kk] = dot_smem_bf16<DH>(vb, Vs + kr * PITCH);
      m = fmaxf(m, s);
    }
    m = sft::warp_max(m);
    float sum = 0.f;
    for (int kk = lane; kk < nk; kk += 32) {
      const float e = __expf(sa[kk] - m);
      sa[kk] = e;
      sum += e;
    }
    const float inv = 1.f / sft::warp_sum(sum);
    float sig = 0.f;
    for (int kk = lane; kk < nk; kk += 32) {
      const float p = sa[kk] * inv;
      sa[kk] = p;
      sig += p * sb[kk];
    }
    sig = sft::warp_sum(sig);
    for (int kk = lane; kk < nk; kk += 32) {
      const float p = sa[kk];
      const float ds = p * (sb[kk] - sig);
      if (kk == 0) {
        row_dsc[r] = ds;
        row_pc[r] = p;
        sa[0] = ds;
      } else {
        sa[kk] = sft::bf16r(ds);
      }
    }
    __syncwarp();
    float a[NP][2] = {};
    for (int kk = 0; kk < nk; ++kk) {
      const int kr = kk == 0 ? 0 : 1 + gl * L + kk - 1;
      const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(Ks + kr * PITCH);
#pragma unroll
      for (int u = 0; u < NP; ++u) {
        const int t = lane + 32 * u;
        if (FULL || t < DH / 2) {
          const float2 k = __bfloat1622float2(k2[t]);
          a[u][0] += sa[kk] * k.x;
          a[u][1] += sa[kk] * k.y;
        }
      }
    }
    const int i = r % L;
    const int64_t li = (int64_t)i * n + g0 + gl;
    __nv_bfloat162* dq = reinterpret_cast<__nv_bfloat162*>(pdq + li * 3 * D + h * DH);
#pragma unroll
    for (int u = 0; u < NP; ++u) {
      const int t = lane + 32 * u;
      if (FULL || t < DH / 2) dq[t] = __floats2bfloat162_rn(a[u][0] * scale, a[u][1] * scale);
    }
    if (lane == 0) {
      row_m[r] = m;
      row_inv[r] = inv;
      row_sig[r] = sig;
    }
    __syncwarp();
  }
  __syncthreads();

  // the CLS key's partial dk / dv over this chunk
  for (int t = tid; t < 2 * DH; t += blockDim.x) {
    const int c = t % DH;
    float acc = 0.f;
    if (t < DH) {
      for (int r = 0; r < rows; ++r)
        acc += row_dsc[r] * sft::bf16r(__bfloat162float(Qs[r * PITCH + c]) * scale);
    } else {
      for (int r = 0; r < rows; ++r) acc += row_pc[r] * __bfloat162float(Os[r * PITCH + c]);
    }
    cls_part_g[(bh * gridDim.y + chunk) * 2 * DH + t] = acc;
  }

  // pass 2: patch key rows
  for (int r = warp; r < rows; r += WARPS) {
    const int gl = r / L, j = r % L;
    const bf16* krow = Ks + (1 + r) * PITCH;
    const bf16* vrow = Vs + (1 + r) * PITCH;
    for (int d = lane; d < DH; d += 32) {
      va[d] = __bfloat162float(krow[d]);
      vb[d] = __bfloat162float(vrow[d]);
    }
    __syncwarp();
    for (int i = lane; i < L; i += 32) {
      const int qr = gl * L + i;
      const bf16* qrow = Qs + qr * PITCH;
      // the logit as pass 1 formed it: scaled q (exact) times k, same order
      const __nv_bfloat162* q2 = reinterpret_cast<const __nv_bfloat162*>(qrow);
      float s = 0.f;
#pragma unroll 8
      for (int t = 0; t < DH / 2; ++t) {
        const float2 q = __bfloat1622float2(q2[t]);
        s += sft::bf16r(q.x * scale) * va[2 * t] + sft::bf16r(q.y * scale) * va[2 * t + 1];
      }
      const float p = __expf(s - row_m[qr]) * row_inv[qr];
      const float dp = dot_smem_bf16<DH>(vb, Os + qr * PITCH);
      sa[i] = sft::bf16r(p * (dp - row_sig[qr]));
      sb[i] = sft::bf16r(p);
    }
    __syncwarp();
    float kacc[NP][2] = {}, vacc[NP][2] = {};
    for (int i = 0; i < L; ++i) {
      const int qr = gl * L + i;
      const __nv_bfloat162* q2 = reinterpret_cast<const __nv_bfloat162*>(Qs + qr * PITCH);
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(Os + qr * PITCH);
#pragma unroll
      for (int u = 0; u < NP; ++u) {
        const int t = lane + 32 * u;
        if (FULL || t < DH / 2) {
          const float2 q = __bfloat1622float2(q2[t]);
          const float2 o = __bfloat1622float2(o2[t]);
          kacc[u][0] += sa[i] * sft::bf16r(q.x * scale);
          kacc[u][1] += sa[i] * sft::bf16r(q.y * scale);
          vacc[u][0] += sb[i] * o.x;
          vacc[u][1] += sb[i] * o.y;
        }
      }
    }
    const int64_t li = (int64_t)j * n + g0 + gl;
    const int64_t pi = bh * fn + li;
    const float dsa = ds_cls[pi], pa = p_cls[pi];
    bf16* out = pdq + li * 3 * D + h * DH;
#pragma unroll
    for (int u = 0; u < NP; ++u) {
      const int t = lane + 32 * u;
      if (FULL || t < DH / 2) {
        const float k0 = kacc[u][0] + dsa * qcs[2 * t], k1 = kacc[u][1] + dsa * qcs[2 * t + 1];
        const float v0 = vacc[u][0] + pa * docs[2 * t], v1 = vacc[u][1] + pa * docs[2 * t + 1];
        reinterpret_cast<__nv_bfloat162*>(out + D)[t] = __floats2bfloat162_rn(k0, k1);
        reinterpret_cast<__nv_bfloat162*>(out + 2 * D)[t] = __floats2bfloat162_rn(v0, v1);
      }
    }
    __syncwarp();
  }
}


// (2') Space mode on the tensor cores: one block per (h, group, b), one
// group of L queries over L + 1 keys ([CLS; members]), padded to 16-row
// tiles, one warp per tile. WMMA 16x16x16 bf16 products with f32 sums; every
// elementwise step goes through a per-warp f32 tile in shared memory, so no
// fragment layout is assumed. Pass 1, warp w on query tile w: a sweep over
// the key tiles for the row max, sum and sigma (online), a second sweep for
// p and ds (bf16) and dq += ds k. Pass 2, warp w on key tile w: a sweep over
// the query tiles for p^T and ds^T, dk += ds^T q, dv += p^T do. The CLS key
// keeps f32 ds and p as in the CUDA-core kernel: its column is left out of
// the products and added in f32. The whole group's Q, dO, K and V stay in
// shared memory: at n = 196 that is 173 KB at DH 96, and DH 128 fits n <= 175.
constexpr int TQ = 16;

template <int DH>
struct SpaceTile {
  static constexpr int QP = DH + 8;  // bf16 pitch of the staged rows: 32-byte aligned tiles
  // columns of dq / dk / dv a warp writes back per step of its epilogue: the
  // whole row up to DH 64, 16-column chunks above, which keeps the scratch small
  static constexpr int EPI = DH <= 64 ? DH : 16;
  // per-warp f32 scratch: the S and dP tiles and two bf16 tiles (3 x 256
  // floats), or a 16 x EPI epilogue chunk
  static constexpr int SCR = TQ * EPI > 3 * TQ * TQ ? TQ * EPI : 3 * TQ * TQ;

  static size_t smem(int QT, int KT) {
    const int warps = QT > KT ? QT : KT;
    return (size_t)(2 * QT + 2 * KT) * TQ * QP * sizeof(bf16) +
           (5 * (size_t)QT * TQ + (size_t)warps * SCR) * sizeof(float);
  }
};

template <int DH>
__global__ void __launch_bounds__(32 * 16)
space_bwd_tc_kernel(const bf16* __restrict__ qkv_p, const bf16* __restrict__ qkv_c,
                    const bf16* __restrict__ dop, const bf16* __restrict__ doc,
                    const float* __restrict__ ds_cls, const float* __restrict__ p_cls,
                    float* __restrict__ cls_part_g, bf16* __restrict__ dqkv_p, int fn, int L,
                    int H, int QT, int KT, Strides strd, float scale) {
  using namespace nvcuda;
  constexpr int QP = SpaceTile<DH>::QP, EPI = SpaceTile<DH>::EPI, SCR = SpaceTile<DH>::SCR;
  constexpr int NT = DH / 16;  // 16-column tiles of a row
  extern __shared__ __align__(128) unsigned char smem_tc[];
  const int h = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int D = H * DH;
  const int nk = L + 1;
  bf16* Qs = reinterpret_cast<bf16*>(smem_tc);  // QT*16 x QP, unscaled
  bf16* Os = Qs + QT * TQ * QP;              // QT*16 x QP
  bf16* Ks = Os + QT * TQ * QP;              // KT*16 x QP, row 0 the CLS key
  bf16* Vs = Ks + KT * TQ * QP;
  float* row_m = reinterpret_cast<float*>(Vs + KT * TQ * QP);  // QT*16 each
  float* row_inv = row_m + QT * TQ;
  float* row_sig = row_inv + QT * TQ;
  float* row_dsc = row_sig + QT * TQ;
  float* row_pc = row_dsc + QT * TQ;
  float* scratch = row_pc + QT * TQ;  // warps x SCR
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int64_t tok_g = (int64_t)g * L;  // the group's first patch in its segment
  const int64_t bh = (int64_t)b * H + h;
  const bf16* pin = qkv_p + (int64_t)b * strd.p * 3 * D;
  const bf16* pdo = dop + (int64_t)b * strd.op * D;
  bf16* pdq = dqkv_p + (int64_t)b * strd.p * 3 * D;
  const bf16* crow = qkv_c + (int64_t)b * strd.c * 3 * D;
  const bf16* docr = doc + (int64_t)b * strd.oc * D;

  // stage: query / cotangent rows 0..L-1, key / value rows 0 (CLS) .. L; zero padding
  const __nv_bfloat162 zero2 = __floats2bfloat162_rn(0.f, 0.f);
  for (int idx = tid; idx < QT * TQ * (DH / 2); idx += blockDim.x) {
    const int r = idx / (DH / 2), t = idx % (DH / 2);
    __nv_bfloat162 q = zero2, o = zero2;
    if (r < L) {
      const int64_t tok = tok_g + r;
      q = reinterpret_cast<const __nv_bfloat162*>(pin + tok * 3 * D + h * DH)[t];
      o = reinterpret_cast<const __nv_bfloat162*>(pdo + tok * D + h * DH)[t];
    }
    reinterpret_cast<__nv_bfloat162*>(Qs + r * QP)[t] = q;
    reinterpret_cast<__nv_bfloat162*>(Os + r * QP)[t] = o;
  }
  for (int idx = tid; idx < KT * TQ * (DH / 2); idx += blockDim.x) {
    const int r = idx / (DH / 2), t = idx % (DH / 2);
    __nv_bfloat162 k = zero2, v = zero2;
    if (r < nk) {
      const bf16* row = r == 0 ? crow : pin + (tok_g + r - 1) * 3 * D;
      k = reinterpret_cast<const __nv_bfloat162*>(row + D + h * DH)[t];
      v = reinterpret_cast<const __nv_bfloat162*>(row + 2 * D + h * DH)[t];
    }
    reinterpret_cast<__nv_bfloat162*>(Ks + r * QP)[t] = k;
    reinterpret_cast<__nv_bfloat162*>(Vs + r * QP)[t] = v;
  }
  __syncthreads();

  float* st = scratch + warp * SCR;  // S tile: [0, 256); dP tile: [256, 512)
  bf16* tb = reinterpret_cast<bf16*>(st + 2 * TQ * TQ);  // two bf16 16 x 16 tiles
  const int er = lane / 2, ec0 = (lane % 2) * 8;  // this lane's row and 8 columns of a tile

  // S = A_rows(16) . B_rows(16)^T over dh, into st[0..256); dP likewise into st[256..512)
  auto two_products = [&](const bf16* a1, const bf16* b1, const bf16* a2, const bf16* b2) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      wmma::load_matrix_sync(fa, a1 + kk * 16, QP);
      wmma::load_matrix_sync(fb, b1 + kk * 16, QP);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(st, acc, TQ, wmma::mem_row_major);
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      wmma::load_matrix_sync(fa, a2 + kk * 16, QP);
      wmma::load_matrix_sync(fb, b2 + kk * 16, QP);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(st + TQ * TQ, acc, TQ, wmma::mem_row_major);
    __syncwarp();
  };

  // pass 1: query tile w
  if (warp < QT) {
    const int w = warp;
    const int qrow = w * TQ + er;
    float m = -INFINITY, l = 0.f, sp = 0.f;
    for (int kt = 0; kt < KT; ++kt) {
      two_products(Qs + w * TQ * QP, Ks + kt * TQ * QP, Os + w * TQ * QP, Vs + kt * TQ * QP);
      float s[8], mt = -INFINITY;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int key = kt * TQ + ec0 + e;
        s[e] = key < nk ? st[er * TQ + ec0 + e] * scale : -INFINITY;
        mt = fmaxf(mt, s[e]);
      }
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      const float m_new = fmaxf(m, mt);
      float es = 0.f, eps = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float ex = s[e] == -INFINITY ? 0.f : __expf(s[e] - m_new);
        es += ex;
        eps += ex * st[TQ * TQ + er * TQ + ec0 + e];
      }
      es += __shfl_xor_sync(0xffffffffu, es, 1);
      eps += __shfl_xor_sync(0xffffffffu, eps, 1);
      const float c = m == -INFINITY ? 0.f : __expf(m - m_new);
      l = l * c + es;
      sp = sp * c + eps;
      m = m_new;
      __syncwarp();
    }
    const float inv = 1.f / l, sig = sp * inv;
    if (lane % 2 == 0) {
      row_m[qrow] = m;
      row_inv[qrow] = inv;
      row_sig[qrow] = sig;
    }
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> dq[NT];
#pragma unroll
    for (int n = 0; n < NT; ++n) wmma::fill_fragment(dq[n], 0.f);
    for (int kt = 0; kt < KT; ++kt) {
      two_products(Qs + w * TQ * QP, Ks + kt * TQ * QP, Os + w * TQ * QP, Vs + kt * TQ * QP);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int key = kt * TQ + ec0 + e;
        float ds = 0.f;
        if (key < nk) {
          const float p = __expf(st[er * TQ + ec0 + e] * scale - m) * inv;
          ds = p * (st[TQ * TQ + er * TQ + ec0 + e] - sig);
          if (key == 0) {
            row_dsc[qrow] = ds;
            row_pc[qrow] = p;
            ds = 0.f;  // the CLS key's term is added in f32 below
          }
        }
        tb[er * TQ + ec0 + e] = __float2bfloat16(ds);
      }
      __syncwarp();
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fa, tb, TQ);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        wmma::load_matrix_sync(fb, Ks + kt * TQ * QP + n * 16, QP);
        wmma::mma_sync(dq[n], fa, fb, dq[n]);
      }
      __syncwarp();
    }
    // dq = scale * (sum ds k + ds_cls k_cls), EPI columns at a time
#pragma unroll
    for (int c0 = 0; c0 < DH; c0 += EPI) {
#pragma unroll
      for (int n = c0 / 16; n < (c0 + EPI) / 16; ++n)
        wmma::store_matrix_sync(st + n * 16 - c0, dq[n], EPI, wmma::mem_row_major);
      __syncwarp();
      for (int idx = lane; idx < TQ * EPI / 2; idx += 32) {
        const int r = idx / (EPI / 2), c = 2 * (idx % (EPI / 2));
        const int q = w * TQ + r;
        if (q >= L) continue;
        const float dsc = row_dsc[q];
        const float d0 = (st[r * EPI + c] + dsc * __bfloat162float(Ks[c0 + c])) * scale;
        const float d1 = (st[r * EPI + c + 1] + dsc * __bfloat162float(Ks[c0 + c + 1])) * scale;
        reinterpret_cast<__nv_bfloat162*>(pdq + (tok_g + q) * 3 * D + h * DH + c0)[c / 2] =
            __floats2bfloat162_rn(d0, d1);
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // the CLS key's partial dk / dv over the group, in f32
  for (int t = tid; t < 2 * DH; t += blockDim.x) {
    const int c = t % DH;
    float acc = 0.f;
    if (t < DH) {
      for (int r = 0; r < L; ++r)
        acc += row_dsc[r] * sft::bf16r(__bfloat162float(Qs[r * QP + c]) * scale);
    } else {
      for (int r = 0; r < L; ++r) acc += row_pc[r] * __bfloat162float(Os[r * QP + c]);
    }
    cls_part_g[(bh * gridDim.y + g) * 2 * DH + t] = acc;
  }

  // pass 2: key tile w
  if (warp < KT) {
    const int w = warp;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> dk[NT], dv[NT];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      wmma::fill_fragment(dk[n], 0.f);
      wmma::fill_fragment(dv[n], 0.f);
    }
    bf16* pt = tb;             // P tile [query][key], bf16
    bf16* dst = tb + TQ * TQ;  // dS tile [query][key], bf16
    for (int qt = 0; qt < QT; ++qt) {
      two_products(Qs + qt * TQ * QP, Ks + w * TQ * QP, Os + qt * TQ * QP, Vs + w * TQ * QP);
      const int q = qt * TQ + er;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int key = w * TQ + ec0 + e;
        float p = 0.f, ds = 0.f;
        if (q < L && key < nk && key > 0) {  // the CLS key's column is done in f32 above
          p = __expf(st[er * TQ + ec0 + e] * scale - row_m[q]) * row_inv[q];
          ds = p * (st[TQ * TQ + er * TQ + ec0 + e] - row_sig[q]);
        }
        pt[er * TQ + ec0 + e] = __float2bfloat16(p);
        dst[er * TQ + ec0 + e] = __float2bfloat16(ds);
      }
      __syncwarp();
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fa, pt, TQ);  // P^T
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        wmma::load_matrix_sync(fb, Os + qt * TQ * QP + n * 16, QP);
        wmma::mma_sync(dv[n], fa, fb, dv[n]);
      }
      wmma::load_matrix_sync(fa, dst, TQ);  // dS^T
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        wmma::load_matrix_sync(fb, Qs + qt * TQ * QP + n * 16, QP);
        wmma::mma_sync(dk[n], fa, fb, dk[n]);
      }
      __syncwarp();
    }
    // dk = scale * sum ds q_raw + ds_cls q_cls; dv = sum p do + p_cls do_cls,
    // EPI columns at a time
#pragma unroll
    for (int which = 0; which < 2; ++which) {
#pragma unroll
      for (int c0 = 0; c0 < DH; c0 += EPI) {
#pragma unroll
        for (int n = c0 / 16; n < (c0 + EPI) / 16; ++n)
          wmma::store_matrix_sync(st + n * 16 - c0, which == 0 ? dk[n] : dv[n], EPI,
                                  wmma::mem_row_major);
        __syncwarp();
        for (int idx = lane; idx < TQ * EPI / 2; idx += 32) {
          const int r = idx / (EPI / 2), c = 2 * (idx % (EPI / 2));
          const int key = w * TQ + r;
          if (key < 1 || key >= nk) continue;
          const int64_t tok = tok_g + key - 1;
          const int64_t pi = bh * fn + tok;
          const int col = h * DH + c0 + c;
          float d0, d1;
          if (which == 0) {
            const float dsa = ds_cls[pi];
            const float q0 = sft::bf16r(__bfloat162float(crow[col]) * scale);
            const float q1 = sft::bf16r(__bfloat162float(crow[col + 1]) * scale);
            d0 = st[r * EPI + c] * scale + dsa * q0;
            d1 = st[r * EPI + c + 1] * scale + dsa * q1;
          } else {
            const float pa = p_cls[pi];
            d0 = st[r * EPI + c] + pa * __bfloat162float(docr[col]);
            d1 = st[r * EPI + c + 1] + pa * __bfloat162float(docr[col + 1]);
          }
          reinterpret_cast<__nv_bfloat162*>(pdq + tok * 3 * D + (1 + which) * D + col)[0] =
              __floats2bfloat162_rn(d0, d1);
        }
        __syncwarp();
      }
    }
  }
}

// (3) dk / dv of the CLS key: its own term plus every chunk's, in order.
template <int DH>
__global__ void __launch_bounds__(2 * DH)
cls_reduce_kernel(const float* __restrict__ cls_part, const float* __restrict__ cls_part_g,
                  bf16* __restrict__ dqkv_c, int H, int nchunks, int cstride) {
  const int h = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
  const int D = H * DH;
  const int64_t bh = (int64_t)b * H + h;
  float acc = cls_part[bh * 2 * DH + t];
  for (int c = 0; c < nchunks; ++c) acc += cls_part_g[(bh * nchunks + c) * 2 * DH + t];
  const int which = t / DH, col = t % DH;
  dqkv_c[(int64_t)b * cstride * 3 * D + (1 + which) * D + h * DH + col] = __float2bfloat16(acc);
}

// launch_bwd's return code when a space-mode group does not fit one block
// (more than 16 tiles of keys, or more shared memory than a block may opt
// into); it launches nothing then. The wrappers name the shape.
constexpr int kGroupTooLarge = -2;

// mode 0 = space (groups are frames, one a block; n <= 255, and less at DH
// 128, see SpaceTile), 1 = time (groups are spatial positions, GPB a block).
// Scratch (f32, written before read): ds_cls and p_cls B*H*f*n each,
// cls_part B*H*2*DH, cls_part_g B*H*G*2*DH with G the group count of the
// mode (time mode fills the first B*H*ceil(n/GPB)*2*DH).
template <int DH>
int launch_bwd(const bf16* qkv_p, const bf16* qkv_c, const bf16* dop, const bf16* doc,
               float* ds_cls, float* p_cls, float* cls_part, float* cls_part_g, bf16* dqkv_p,
               bf16* dqkv_c, int B, int f, int n, int H, int mode, Strides strd,
               cudaStream_t s) {
  const int L = mode == 0 ? n : f;
  const int QT = (L + TQ - 1) / TQ, KT = (L + 1 + TQ - 1) / TQ;  // space-mode tiles
  if (mode == 0) {
    int dev = 0, optin = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return (int)e;
    if (KT > 16 || SpaceTile<DH>::smem(QT, KT) > (size_t)optin) return kGroupTooLarge;
  }
  const int fn = f * n;
  const float scale = (float)pow((double)DH, -0.5);
  const int nchunks = mode == 0 ? f : (n + GPB - 1) / GPB;

  const size_t smem_c = (2 * DH + 32 + 2 + (CLS_THREADS / 32) * DH + 2 * (size_t)(fn + 1)) *
                        sizeof(float);
  cudaFuncSetAttribute(cls_bwd_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem_c);
  SFT_CHECK_LAUNCH();
  cls_bwd_kernel<DH><<<dim3(H, B), CLS_THREADS, smem_c, s>>>(
      qkv_p, qkv_c, doc, ds_cls, p_cls, cls_part, dqkv_c, fn, H, strd, scale);
  SFT_CHECK_LAUNCH();

  if (mode == 0) {
    const int warps = QT > KT ? QT : KT;
    const size_t smem_t = SpaceTile<DH>::smem(QT, KT);
    cudaFuncSetAttribute(space_bwd_tc_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem_t);
    SFT_CHECK_LAUNCH();
    space_bwd_tc_kernel<DH><<<dim3(H, f, B), warps * 32, smem_t, s>>>(
        qkv_p, qkv_c, dop, doc, ds_cls, p_cls, cls_part_g, dqkv_p, fn, L, H, QT, KT, strd,
        scale);
    SFT_CHECK_LAUNCH();
  } else {
    const size_t cap = (size_t)GPB * L;
    const size_t smem_g = (2 * (1 + cap) + 2 * cap) * (DH + 2) * sizeof(bf16) +
                          (5 * cap + 2 * DH + WARPS * (2 * DH + 2 * (size_t)(L + 1))) *
                              sizeof(float);
    cudaFuncSetAttribute(group_bwd_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem_g);
    SFT_CHECK_LAUNCH();
    group_bwd_kernel<DH><<<dim3(H, nchunks, B), WARPS * 32, smem_g, s>>>(
        qkv_p, qkv_c, dop, doc, ds_cls, p_cls, cls_part_g, dqkv_p, L, n, H, strd, scale);
    SFT_CHECK_LAUNCH();
  }

  cls_reduce_kernel<DH><<<dim3(H, B), 2 * DH, 0, s>>>(cls_part, cls_part_g, dqkv_c, H, nchunks,
                                                      strd.c);
  SFT_CHECK_LAUNCH();
  return 0;
}

// launch_bwd at the head_dim of the call; the instantiated set is {32, 64,
// 96, 128}, and the wrappers refuse any other before they launch.
int dispatch_bwd(int dh, const void* qkv_p, const void* qkv_c, const void* dop, const void* doc,
                 void* ds_cls, void* p_cls, void* cls_part, void* cls_part_g, void* dqkv_p,
                 void* dqkv_c, int B, int f, int n, int H, int mode, Strides strd,
                 void* stream) {
#define SFT_BWD(DH_)                                                                          \
  launch_bwd<DH_>(static_cast<const bf16*>(qkv_p), static_cast<const bf16*>(qkv_c),           \
                  static_cast<const bf16*>(dop), static_cast<const bf16*>(doc),               \
                  static_cast<float*>(ds_cls), static_cast<float*>(p_cls),                    \
                  static_cast<float*>(cls_part), static_cast<float*>(cls_part_g),             \
                  static_cast<bf16*>(dqkv_p), static_cast<bf16*>(dqkv_c), B, f, n, H, mode,   \
                  strd, static_cast<cudaStream_t>(stream))
  switch (dh) {
    case 32:
      return SFT_BWD(32);
    case 64:
      return SFT_BWD(64);
    case 96:
      return SFT_BWD(96);
    case 128:
      return SFT_BWD(128);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SFT_BWD
}

}  // namespace

// K6 on the split layout.
extern "C" int sft_divided_attention_bwd(const void* qkv_p, const void* qkv_c,
                                         const void* dop, const void* doc, void* ds_cls,
                                         void* p_cls, void* cls_part, void* cls_part_g,
                                         void* dqkv_p, void* dqkv_c, int B, int f, int n,
                                         int H, int dh, int mode, void* stream) {
  const int fn = f * n;
  return dispatch_bwd(dh, qkv_p, qkv_c, dop, doc, ds_cls, p_cls, cls_part, cls_part_g, dqkv_p,
                      dqkv_c, B, f, n, H, mode, Strides{fn, 1, fn, 1}, stream);
}

// K7c on the packed layout: dqkv (B, 1 + f*n, 3D) from qkv of that shape and
// the cotangent dout (B, 1 + f*n, D). Scratch as K6's.
extern "C" int sft_divided_attention_packed_bwd(const void* qkv, const void* dout,
                                                void* ds_cls, void* p_cls, void* cls_part,
                                                void* cls_part_g, void* dqkv, int B, int f,
                                                int n, int H, int dh, int mode, void* stream) {
  const int seq = 1 + f * n, D = H * dh;
  const bf16* q = static_cast<const bf16*>(qkv);
  const bf16* o = static_cast<const bf16*>(dout);
  bf16* dq = static_cast<bf16*>(dqkv);
  return dispatch_bwd(dh, q + 3 * D, q, o + D, o, ds_cls, p_cls, cls_part, cls_part_g,
                      dq + 3 * D, dq, B, f, n, H, mode, Strides{seq, seq, seq, seq}, stream);
}
