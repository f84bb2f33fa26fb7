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
// Numerics, per head (any head_dim dh that is a multiple of 8 up to 256,
// run at the least width of mma_attention.cuh's padded_width that holds it,
// the template parameter DHP: staged columns past dh are zero and no output
// column past dh is written), as the JAX body:
// - q is pre-scaled by dh^-0.5 and rounded to bf16 wherever it is an
//   operand; dq is scaled once more at the end;
// - p over [CLS; group] in f32, sigma = sum(p * dp) with dp = <do, v> in f32,
//   the CLS column included. The space pass accumulates the row sum and
//   sigma online over 16-key tiles (both rescaled by exp(m_old - m_new) as
//   the row max grows), the time pass and the CLS row in one piece;
// - ds is rounded to bf16 before the dq / dk products, p to bf16 before the
//   dv product; the CLS key's ds and p stay f32;
// - every patch's dk / dv sums the group term and the CLS-query term in f32
//   and is rounded to bf16 once.
//
// The CLS token plays three roles: (a) a query over all 1 + f*n keys, (b) a
// key/value joined to every group, (c) through (a), a source of dk / dv on
// every patch. On the TPU one grid step held a whole segment, so the sums over
// groups stayed in VMEM; here blocks run in no order, so four launches:
// (1) cls_bwd_kernel, one block per (head, batch): role (a), a thread per
//     key row for the logits and dp (16-byte loads). It writes dq of
//     the CLS row, its own dk/dv of the CLS key and value to an f32 scratch,
//     and, for every patch, the bf16-rounded ds and p of the CLS query over
//     that patch (two f32 scalars per (batch, head, patch)). Those are all
//     the (c) terms need: dk_j += ds_j q_cls, dv_j += p_j do_cls.
// (2) the group terms and role (b): in space mode space_bwd_mma_kernel on the
//     tensor cores, in time mode time_bwd_kernel, which reads and writes
//     every row once (their comments below). Each writes the CLS key's
//     partial dk / dv over its groups to an f32 scratch, one slot per block.
// (3) cls_reduce_kernel, one block per (head, batch): sums the CLS key's
//     partials in a fixed order. No atomics: the gradient is deterministic.
// Bound at Stage I's 28 segments (12 heads of 64): the ~472 MB a call moves
// (qkv and dO in, dqkv out), ~0.14 ms at 3.35 TB/s; the space call's
// products (~67 GFLOP counted as five, nine as run: S and dP twice for the
// query-major part, once more transposed for the key-major part) take
// ~0.07 ms at the dense bf16 peak; the time call's ~3 GFLOP run on CUDA
// cores with every bf16 operand unpacked, which takes longer than its bytes
// (PERF.md has the times).
#include "mma_attention.cuh"

using sft::bf16;
using sft::cp_async16;
using sft::cp_async_commit;
using sft::cp_async_wait;
namespace tc = sft::tc;

namespace {

constexpr int CLS_THREADS = 512;
constexpr int KEYS_IN_FLIGHT = 8;  // loads a CLS-row warp starts before it sums
// the space pass: warps of a block at most (a 16-row tile each), and the
// 16-row tiles of a streamed chunk (208 rows up to width 128; fewer at 192
// and 256, whose rows are longer); ops/kernels/_build.py::space_bwd_plan
// mirrors the plan
constexpr int SPACE_WARPS = 8;
constexpr int SPACE_CHUNK_TILES = 13;
__host__ __device__ constexpr int chunk_tiles(int DHP) {
  return DHP <= 128 ? SPACE_CHUNK_TILES : (DHP <= 192 ? 8 : 4);
}
// the time pass: warps of a block at most, and the shared memory its rows
// may take (time_bwd_plan below; _build.py::time_bwd_plan mirrors it)
constexpr int WARPS = 8;
constexpr int TIME_THREADS = WARPS * 32;
constexpr size_t TIME_BWD_SMEM_TARGET = 114688;
constexpr size_t MAX_SMEM = 232448;

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

// The arguments of the group kernels (space and time mode). dh: the head
// dim (D = H * dh); HG: heads a time-mode block; P: positions a time-mode
// block; warps: warps a space-mode block; stats: (m, 1/l, sigma, 0) of every
// query of the space pass (B x H x f*n float4).
struct BwdArgs {
  const bf16 *qkv_p, *qkv_c, *dop, *doc;
  const float *ds_cls, *p_cls;
  float *stats, *cls_part_g;
  bf16* dqkv_p;
  int fn, f, n, H, dh, HG, P, warps;
  Strides st;
  float scale;
};


// (1) The CLS query of (b, h) over [CLS; all f*n patches]; D = H * dh
// (EXACT: dh == DHP, compiled as a constant).
template <int DHP, bool EXACT>
__global__ void __launch_bounds__(CLS_THREADS)
cls_bwd_kernel(const bf16* __restrict__ qkv_p, const bf16* __restrict__ qkv_c,
               const bf16* __restrict__ doc, float* __restrict__ ds_cls,
               float* __restrict__ p_cls, float* __restrict__ cls_part,
               bf16* __restrict__ dqkv_c, int fn, int H, int dh_arg, Strides st, float scale) {
  constexpr int NP = (DHP / 2 + 31) / 32;  // bf16 pairs of a row per lane, at most
  extern __shared__ __align__(16) unsigned char smem[];
  const int dh = EXACT ? DHP : dh_arg;
  const int h = blockIdx.x, b = blockIdx.y;
  const int D = H * dh;
  const int nk = fn + 1;
  float* qs = reinterpret_cast<float*>(smem);  // DHP
  float* dos = qs + DHP;                        // DHP
  float* red = dos + DHP;                       // 32
  float* sc = red + 32;                         // 2: ds and p of the CLS key
  float* acc = sc + 2;                          // (CLS_THREADS / 32) x DHP
  float* sv = acc + (CLS_THREADS / 32) * DHP;   // nk: logits, then p, then ds
  float* dpv = sv + nk;                         // nk: dp
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const bf16* crow = qkv_c + (int64_t)b * st.c * 3 * D;
  const bf16* prow0 = qkv_p + (int64_t)b * st.p * 3 * D;
  const int64_t bh = (int64_t)b * H + h;

  if (tid < DHP) {
    const bool in = tid < dh;
    qs[tid] = in ? sft::bf16r(__bfloat162float(crow[h * dh + tid]) * scale) : 0.f;
    dos[tid] = in ? __bfloat162float(doc[(int64_t)b * st.oc * D + h * dh + tid]) : 0.f;
  }
  __syncthreads();

  float m = -INFINITY;
  for (int j = tid; j < nk; j += CLS_THREADS) {
    const bf16* row = j == 0 ? crow : prow0 + (int64_t)(j - 1) * 3 * D;
    const float s = sft::dot_row_bf16<DHP>(qs, row + D + h * dh, dh);
    sv[j] = s;
    dpv[j] = sft::dot_row_bf16<DHP>(dos, row + 2 * D + h * dh, dh);
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
    if (t < dh / 2) {
      float a0 = 0.f, a1 = 0.f;
      constexpr int STEP = CLS_THREADS / 32;
      for (int j0 = warp; j0 < nk; j0 += STEP * KEYS_IN_FLIGHT) {
        float2 kv[KEYS_IN_FLIGHT];
#pragma unroll
        for (int k = 0; k < KEYS_IN_FLIGHT; ++k) {
          const int j = j0 + k * STEP;
          const bf16* row = j == 0 ? crow : prow0 + (int64_t)(j - 1) * 3 * D;
          kv[k] = j < nk ? __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(
                               row + D + h * dh)[t])
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
      acc[warp * DHP + 2 * t] = a0;
      acc[warp * DHP + 2 * t + 1] = a1;
    }
  }
  __syncthreads();
  if (tid < dh) {
    float s = 0.f;
    for (int w = 0; w < CLS_THREADS / 32; ++w) s += acc[w * DHP + tid];
    dqkv_c[(int64_t)b * st.c * 3 * D + h * dh + tid] = __float2bfloat16(s * scale);
    cls_part[bh * 2 * dh + tid] = sc[0] * qs[tid];
    cls_part[bh * 2 * dh + dh + tid] = sc[1] * dos[tid];
  }
}

// (2) Time mode: block (x, b, z) owns positions g0 = x * P .. g0 + P - 1
// (those below n) of segment b and heads h0 = z * HG .. h0 + HG - 1. Staged
// row 0 is the segment's CLS row, row 1 + i * P + p frame i at position g0 +
// p: its q, k and v columns of the HG heads ([q | k | v], DHP columns a head,
// zero past dh) and its cotangent columns of the HG heads, with 16-byte
// cp.async. A warp takes (position, head) items; four lanes a query (a quad),
// each lane C = DHP / 4 columns:
// A. query i: f32 logits and dp over [CLS; the f frames] by quad shuffles, the
//    softmax and sigma in f32, ds and p of the patch keys rounded to bf16 into
//    the warp's scratch, the CLS key's kept f32; dq = (ds_c k_c + sum ds k)
//    * scale, written with 16-byte stores;
// B. the quad turns to patch key j: dk = sum_i ds_ij q_i + ds_cls_j q_cls,
//    dv = sum_i p_ij do_i + p_cls_j do_cls in f32, rounded once, written
//    with 16-byte stores.
// The CLS key's partial dk / dv over the block's positions, from each
// query's f32 ds_c and p_c, goes to cls_part_g slot x. Every byte of qkv and
// of the cotangent is read once, every dqkv row written once. The plan
// (time_bwd_plan: P, HG and the warps, blockDim.x / 32) keeps f frames'
// rows and each warp's f x (f + 1) scratch within a block. DIRECT: dh ==
// DHP, HG == H and WARPS warps, so a staged row is the device row as it lies
// (the main path's plan, compiled without the head-group arithmetic).
template <int DHP, bool DIRECT>
__global__ void __launch_bounds__(TIME_THREADS)
time_bwd_kernel(const BwdArgs a) {
  constexpr int C = DHP / 4;   // columns a lane owns
  constexpr int V = C / 8;     // its 16-byte pieces
  constexpr int HP = DHP / 8;  // 16-byte pieces of a staged head
  static_assert(C % 8 == 0, "the time pass takes widths that are multiples of 32");
  extern __shared__ __align__(16) unsigned char smem[];
  const int f = a.f, n = a.n, H = a.H, P = a.P;
  const int dh = DIRECT ? DHP : a.dh, HG = DIRECT ? H : a.HG;
  const int D = H * dh, D3 = 3 * D;
  const int W = HG * DHP, W3 = 3 * W;  // staged widths: q (or k, v, the cotangent), qkv
  const int nw = DIRECT ? WARPS : (int)blockDim.x / 32;
  const int nthreads = DIRECT ? TIME_THREADS : (int)blockDim.x;
  const int g0 = blockIdx.x * P, b = blockIdx.y, h0 = blockIdx.z * HG;
  const int np = min(P, n - g0);
  const int rows = 1 + f * P;
  const int cpr = dh / 8;
  bf16* QKV = reinterpret_cast<bf16*>(smem);    // rows x 3W
  bf16* DO = QKV + (size_t)rows * W3;            // rows x W
  float* cls_w = reinterpret_cast<float*>(DO + (size_t)rows * W);  // P x HG x f x (ds_c, p_c)
  float* scr = cls_w + (size_t)P * HG * f * 2;  // warps x 2 x f x (f + 1)
  const bf16* pin = a.qkv_p + (int64_t)b * a.st.p * D3;
  const bf16* pdo = a.dop + (int64_t)b * a.st.op * D;
  bf16* pdq = a.dqkv_p + (int64_t)b * a.st.p * D3;
  const int fn = f * n;

  // stage: qkv rows (3 x HG heads of HP pieces each), then cotangent rows
  // (HG heads)
  for (int idx = threadIdx.x; idx < rows * (W3 / 8); idx += nthreads) {
    const int r = idx / (W3 / 8), c = idx % (W3 / 8);
    const bf16* src = a.qkv_c + (int64_t)b * a.st.c * D3;
    bool valid = true;
    if (r > 0) {
      const int i = (r - 1) / P, p = (r - 1) % P;
      valid = p < np;
      src = pin + ((int64_t)i * n + g0 + (valid ? p : 0)) * D3;
    }
    if (DIRECT) {
      cp_async16(QKV + (size_t)r * W3 + c * 8, src + c * 8, valid);
    } else {
      const int part3 = c / (HG * HP), hh = (c - part3 * HG * HP) / HP, cc = c % HP;
      valid = valid && cc < cpr;
      cp_async16(QKV + (size_t)r * W3 + c * 8,
                 valid ? src + part3 * D + (h0 + hh) * dh + cc * 8 : a.qkv_c, valid);
    }
  }
  for (int idx = threadIdx.x; idx < rows * (W / 8); idx += nthreads) {
    const int r = idx / (W / 8), c = idx % (W / 8);
    const bf16* src = a.doc + (int64_t)b * a.st.oc * D;
    bool valid = true;
    if (r > 0) {
      const int i = (r - 1) / P, p = (r - 1) % P;
      valid = p < np;
      src = pdo + ((int64_t)i * n + g0 + (valid ? p : 0)) * D;
    }
    if (DIRECT) {
      cp_async16(DO + (size_t)r * W + c * 8, src + c * 8, valid);
    } else {
      const int hh = c / HP, cc = c % HP;
      valid = valid && cc < cpr;
      cp_async16(DO + (size_t)r * W + c * 8, valid ? src + (h0 + hh) * dh + cc * 8 : a.doc,
                 valid);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // every staged q (the CLS row's too) scaled by dh^-0.5 and rounded, once
  for (int idx = threadIdx.x; idx < rows * (W / 2); idx += nthreads) {
    uint32_t* x = reinterpret_cast<uint32_t*>(QKV + (size_t)(idx / (W / 2)) * W3) + idx % (W / 2);
    *x = tc::scale_bf16x2(*x, a.scale);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int quad = lane / 4, part = lane % 4;
  float* sp = scr + (size_t)warp * 2 * f * (f + 1);  // s, then p (bf16-rounded), [i][j]
  float* sd = sp + f * (f + 1);                      // dp, then ds (bf16-rounded), [i][j]
  const float scale = a.scale;

  // the C columns of a staged row from ``row`` on, as f32
  auto load_row = [&](float (&x)[C], const bf16* row) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const uint4 raw = reinterpret_cast<const uint4*>(row)[v];
      const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float2 y = __bfloat1622float2(e[u]);
        x[8 * v + 2 * u] = y.x;
        x[8 * v + 2 * u + 1] = y.y;
      }
    }
  };
  auto dot = [&](const float (&x)[C], const bf16* row) {
    float s = 0.f;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const uint4 raw = reinterpret_cast<const uint4*>(row)[v];
      const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float2 y = __bfloat1622float2(e[u]);
        s += x[8 * v + 2 * u] * y.x + x[8 * v + 2 * u + 1] * y.y;
      }
    }
    return s;
  };
  auto axpy = [&](float (&acc)[C], float w, const bf16* row) {
    float x[C];
    load_row(x, row);
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] += w * x[c];
  };
  // the lane's columns below dh to device memory, 16 bytes at a time
  auto store_row = [&](bf16* dst, const float (&x)[C], float mul) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      if (part * C + 8 * v >= dh) continue;
      uint4 w;
      uint32_t* wp = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        wp[u] = tc::pack_bf16(x[8 * v + 2 * u] * mul, x[8 * v + 2 * u + 1] * mul);
      reinterpret_cast<uint4*>(dst)[v] = w;
    }
  };
  auto srow = [&](int j, int p) { return j == 0 ? 0 : 1 + (j - 1) * P + p; };

  for (int item = warp; item < np * HG; item += nw) {
    const int p = item / HG, hh = item % HG, h = h0 + hh;
    const int col = hh * DHP + part * C;   // the lane's staged columns
    const int gcol = h * dh + part * C;    // and in device memory
    float* cw = cls_w + ((size_t)p * HG + hh) * f * 2;
    // A. the queries, 8 at a time (a quad each)
    for (int i0 = 0; i0 < f; i0 += 8) {
      const int i = i0 + quad;
      const bool live = i < f;
      const int r = live ? srow(i + 1, p) : 0;
      float q[C], o[C];
      load_row(q, QKV + (size_t)r * W3 + col);
      load_row(o, DO + (size_t)r * W + col);
      for (int j = 0; j <= f; ++j) {
        const int kr = srow(j, p);
        const float s = tc::quad_sum(dot(q, QKV + (size_t)kr * W3 + W + col));
        const float dp = tc::quad_sum(dot(o, QKV + (size_t)kr * W3 + 2 * W + col));
        if (live && part == 0) {
          sp[i * (f + 1) + j] = s;
          sd[i * (f + 1) + j] = dp;
        }
      }
      __syncwarp();
      float dsc = 0.f;
      if (live) {
        const float* si = sp + i * (f + 1);
        const float* di = sd + i * (f + 1);
        float m = -INFINITY;
        for (int j = 0; j <= f; ++j) m = fmaxf(m, si[j]);
        float sum = 0.f;
        for (int j = 0; j <= f; ++j) sum += __expf(si[j] - m);
        const float inv = 1.f / sum;
        float sig = 0.f;
        for (int j = 0; j <= f; ++j) sig += __expf(si[j] - m) * inv * di[j];
        const float pc = __expf(si[0] - m) * inv;
        dsc = pc * (di[0] - sig);
        __syncwarp(0xfu << (quad * 4));  // the quad has read its row
        if (part == 0) {
          for (int j = 1; j <= f; ++j) {
            const float pj = __expf(si[j] - m) * inv;
            sd[i * (f + 1) + j] = sft::bf16r(pj * (di[j] - sig));
            sp[i * (f + 1) + j] = sft::bf16r(pj);
          }
          cw[2 * i] = dsc;
          cw[2 * i + 1] = pc;
        }
      }
      __syncwarp();
      if (live) {
        float acc[C];
        load_row(acc, QKV + W + col);  // the CLS key
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] *= dsc;
        for (int j = 1; j <= f; ++j)
          axpy(acc, sd[i * (f + 1) + j], QKV + (size_t)srow(j, p) * W3 + W + col);
        const int64_t tok = (int64_t)i * n + g0 + p;
        store_row(pdq + tok * D3 + gcol, acc, scale);
      }
    }
    __syncwarp();
    // B. the patch keys, 8 at a time (a quad each)
    const int64_t bh = (int64_t)b * H + h;
    for (int j0 = 0; j0 < f; j0 += 8) {
      const int jk = j0 + quad;  // key jk + 1: frame jk
      if (jk < f) {
        const int64_t tok = (int64_t)jk * n + g0 + p;
        float kacc[C], vacc[C];
        load_row(kacc, QKV + col);  // the CLS query, scaled
        load_row(vacc, DO + col);   // the CLS cotangent
        const float dsa = a.ds_cls[bh * fn + tok], pa = a.p_cls[bh * fn + tok];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          kacc[c] *= dsa;
          vacc[c] *= pa;
        }
        for (int i = 0; i < f; ++i) {
          const int r = srow(i + 1, p);
          axpy(kacc, sd[i * (f + 1) + jk + 1], QKV + (size_t)r * W3 + col);
          axpy(vacc, sp[i * (f + 1) + jk + 1], DO + (size_t)r * W + col);
        }
        store_row(pdq + tok * D3 + D + gcol, kacc, 1.f);
        store_row(pdq + tok * D3 + 2 * D + gcol, vacc, 1.f);
      }
    }
    __syncwarp();
  }
  __syncthreads();

  // the CLS key's partial dk / dv over the block's positions, per head, in
  // a fixed order: positions, then frames
  for (int idx = threadIdx.x; idx < 2 * HG * dh; idx += nthreads) {
    const int hh = idx / (2 * dh), w = idx % (2 * dh), c = hh * DHP + w % dh;
    const bool is_k = w < dh;
    float acc = 0.f;
    for (int p = 0; p < np; ++p) {
      const float* cw = cls_w + ((size_t)p * HG + hh) * f * 2;
      for (int i = 0; i < f; ++i) {
        const int r = srow(i + 1, p);
        acc += is_k ? cw[2 * i] * __bfloat162float(QKV[(size_t)r * W3 + c])
                    : cw[2 * i + 1] * __bfloat162float(DO[(size_t)r * W + c]);
      }
    }
    a.cls_part_g[(((int64_t)b * H + h0 + hh) * gridDim.x + blockIdx.x) * 2 * dh + w] = acc;
  }
}

// (2') Space mode on the tensor cores: block (h, group, b), one frame's n
// queries over its nk = n + 1 keys [CLS; members], W = min(SPACE_WARPS,
// key tiles) warps. mma.sync.m16n8k16 (bf16 in, f32 sums) with every
// fragment in registers, as the forward's mma_attention.cuh: 16-byte
// cp.async staging, ldmatrix / ldmatrix.trans, row statistics by quad
// shuffles, p and ds packed from the accumulators straight into A fragments.
// Shared memory is fixed by DHP, not by n: W 16-row tiles the warps own and
// a streamed chunk of chunk_tiles(DHP) 16-row tiles (208 rows up to width
// 128: one chunk up to 207 patches a frame; past that, more chunks,
// restaged per sweep).
// Query-major part, rounds of W query tiles, warp w on tile w of the round
// (its Q and dO fragments held in registers):
//   sweep 1 over the key chunks: S = q K^T and dP = dO V^T, per 16-key tile;
//     the row max m, sum l and sigma accumulated online (l and sum(e * dp)
//     rescaled by exp(m_old - m_new) as the max grows; sigma = that / l);
//   sweep 2: S and dP again, p = exp(s - m) / l and ds = p (dp - sigma) in
//     f32, ds rounded to bf16 into A fragments, dq += ds K; the CLS key's
//     ds_c and p_c stay f32: dq = (dq + ds_c k_c) * scale, and the warp adds
//     ds_c q and p_c do of its rows to its share of the CLS key's partial;
//   (m, 1/l, sigma) of each row go to the f32 scratch ``stats``.
// Key-major part, rounds of W key tiles, warp w on tile w: over the query
// chunks (their stats staged beside them), S^T = K q^T and dP^T = V dO^T, so
// p^T and ds^T land in accumulator layout: p^T rounded to bf16 feeds
// dv += p^T dO, ds^T rounded feeds dk += ds^T q; each patch key adds its
// CLS-query terms (ds_cls q_cls, p_cls do_cls, from (1)) in f32 and is
// rounded once. The CLS key's row is left out of both products.
// q is scaled by dh^-0.5 and rounded to bf16 in shared memory once it has
// landed, before any warp reads it. The warps' CLS partials are summed in
// warp order into the group's cls_part_g slot. Staged columns past dh are
// zero, and no output column past dh is written (EXACT: dh == DH, compiled
// as a constant, the main path's code).
template <int DH, bool EXACT>
__global__ void __launch_bounds__(SPACE_WARPS * 32, DH <= 64 ? 2 : 1)
space_bwd_mma_kernel(const BwdArgs a) {
  constexpr int PITCH = DH + 8;  // bf16; an odd count of 16-byte units: ldmatrix conflict-free
  constexpr int CPR = DH / 8;    // 16-byte pieces of a staged row
  constexpr int NS = DH / 16;    // 16-wide steps over the head dim
  constexpr int CT = chunk_tiles(DH);  // 16-row tiles of a streamed chunk
  constexpr int CR = 16 * CT;    // rows of a streamed chunk
  constexpr int CU = DH / 32;    // CLS-partial columns a lane owns
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x, grp = blockIdx.y, b = blockIdx.z;
  const int H = a.H, dh = EXACT ? DH : a.dh, D = H * dh, D3 = 3 * D, W = a.warps;
  const int cpr = EXACT ? CPR : dh / 8;  // pieces of a row that hold the head's columns
  const int n = a.n, nk = n + 1;
  const int ntq = (n + 15) / 16, ntk = (nk + 15) / 16;
  bf16* own0 = reinterpret_cast<bf16*>(smem);  // W * 16 rows: q (query-major) / k (key-major)
  bf16* own1 = own0 + W * 16 * PITCH;          // do / v
  bf16* str0 = own1 + W * 16 * PITCH;          // CR rows: k (query-major) / q (key-major)
  bf16* str1 = str0 + CR * PITCH;              // v / do
  float4* sstat = reinterpret_cast<float4*>(str1 + CR * PITCH);  // CR: streamed rows' stats
  float* wrow = reinterpret_cast<float*>(sstat + CR);  // W x 16 x (ds_c, p_c)
  float* wcls = wrow + W * 32;                          // W x 2 DH
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int64_t tok0 = (int64_t)grp * n;  // the group's first patch in its segment
  const int64_t bh = (int64_t)b * H + h;
  const bf16* pin = a.qkv_p + ((int64_t)b * a.st.p + tok0) * D3 + h * dh;
  const bf16* pdo = a.dop + ((int64_t)b * a.st.op + tok0) * D + h * dh;
  const bf16* crow = a.qkv_c + (int64_t)b * a.st.c * D3 + h * dh;
  const bf16* cdo = a.doc + (int64_t)b * a.st.oc * D + h * dh;
  bf16* pdq = a.dqkv_p + ((int64_t)b * a.st.p + tok0) * D3 + h * dh;
  float4* stats = reinterpret_cast<float4*>(a.stats) + bh * a.fn + tok0;
  const float scale = a.scale;

  // rows [first, first + rows) of the queries (q | do) or of the keys (k | v)
  // into d0 | d1, zero past the last and past column dh
  auto stage = [&](bf16* d0, bf16* d1, int first, int rows, bool keys) {
    for (int idx = tid; idx < rows * CPR; idx += blockDim.x) {
      const int r = idx / CPR, c = idx % CPR, j = first + r;
      const bf16 *s0, *s1;
      bool ok;
      if (keys) {
        ok = j < nk;
        const bf16* row = j == 0 ? crow : pin + (int64_t)(ok ? j - 1 : 0) * D3;
        s0 = row + D;
        s1 = row + 2 * D;
      } else {
        ok = j < n;
        s0 = pin + (int64_t)(ok ? j : 0) * D3;
        s1 = pdo + (int64_t)(ok ? j : 0) * D;
      }
      if (!EXACT) ok = ok && c < cpr;
      cp_async16(d0 + r * PITCH + c * 8, ok ? s0 + c * 8 : crow, ok);
      cp_async16(d1 + r * PITCH + c * 8, ok ? s1 + c * 8 : crow, ok);
    }
  };
  // q rows [0, rows) of a staged buffer scaled by dh^-0.5 and rounded, in
  // place, once per staging (after it has landed)
  auto scale_q = [&](bf16* q, int rows) {
    for (int idx = tid; idx < rows * (DH / 2); idx += blockDim.x) {
      uint32_t* x = reinterpret_cast<uint32_t*>(q + (idx / (DH / 2)) * PITCH) + idx % (DH / 2);
      *x = tc::scale_bf16x2(*x, scale);
    }
  };
  // the B fragments of 16 rows (two n8 blocks) and the A fragment of a
  // 16-row tile at 16-wide step ks, from shared memory
  auto b_frag = [&](uint32_t (&r)[4], const bf16* rows, int ks) {
    tc::ldmatrix_x4(r, rows + ((lane & 7) + (lane >> 4) * 8) * PITCH + ks * 16 +
                           ((lane >> 3) & 1) * 8);
  };
  auto a_frag = [&](uint32_t (&r)[4], const bf16* rows, int ks) {
    tc::ldmatrix_x4(r, rows + (lane & 15) * PITCH + ks * 16 + (lane >> 4) * 8);
  };
  // acc[DH / 8] += A (16 x 16, packed from x) times the 16 rows of B (x DH)
  auto pv = [&](float (&acc)[DH / 8][4], const float (&x)[2][4], const bf16* rows) {
    const uint32_t af[4] = {tc::pack_bf16(x[0][0], x[0][1]), tc::pack_bf16(x[0][2], x[0][3]),
                            tc::pack_bf16(x[1][0], x[1][1]), tc::pack_bf16(x[1][2], x[1][3])};
#pragma unroll
    for (int jj = 0; jj < NS; ++jj) {
      uint32_t bb[4];
      tc::ldmatrix_x4_trans(bb, rows + ((lane & 7) + ((lane >> 3) & 1) * 8) * PITCH + jj * 16 +
                                    (lane >> 4) * 8);
      tc::mma_bf16(acc[2 * jj], af, bb[0], bb[1]);
      tc::mma_bf16(acc[2 * jj + 1], af, bb[2], bb[3]);
    }
  };

  // ---------------------------------------------------------- query-major
  float ck[CU], cv[CU];  // this lane's columns of the warp's CLS-key partial
#pragma unroll
  for (int u = 0; u < CU; ++u) ck[u] = cv[u] = 0.f;
  const int nkc = (ntk + CT - 1) / CT;  // key chunks
  int staged = -1;
  for (int t0 = 0; t0 < ntq; t0 += W) {
    const bool active = t0 + warp < ntq;
    const bf16* qw = own0 + warp * 16 * PITCH;
    const bf16* ow = own1 + warp * 16 * PITCH;
    __syncthreads();  // the own buffers' last readers are done
    stage(own0, own1, t0 * 16, W * 16, false);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    scale_q(own0, W * 16);
    __syncthreads();
    uint32_t qa[NS][4], oa[NS][4];
    if (active) {
#pragma unroll
      for (int ks = 0; ks < NS; ++ks) {
        a_frag(qa[ks], qw, ks);
        a_frag(oa[ks], ow, ks);
      }
    }
    // rows g and g + 8 of the warp's tile; l and e * dp per lane until the end
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, e0 = 0.f, e1 = 0.f;
    float inv0 = 0.f, inv1 = 0.f, sg0 = 0.f, sg1 = 0.f, dsc0 = 0.f, dsc1 = 0.f, pc0 = 0.f,
          pc1 = 0.f;
    float dq[DH / 8][4];
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;
    for (int sweep = 0; sweep < 2; ++sweep) {
      for (int c = 0; c < nkc; ++c) {
        const int k0 = c * CR, ntc = min(CT, ntk - c * CT);
        if (staged != c) {
          __syncthreads();  // the chunk buffers' last readers are done
          stage(str0, str1, k0, ntc * 16, true);
          cp_async_commit();
          cp_async_wait<0>();
          __syncthreads();
          staged = c;
        }
        if (!active) continue;
        for (int kt = 0; kt < ntc; ++kt) {
          float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
          for (int ks = 0; ks < NS; ++ks) {
            uint32_t bk[4], bv[4];
            b_frag(bk, str0 + kt * 16 * PITCH, ks);
            b_frag(bv, str1 + kt * 16 * PITCH, ks);
            tc::mma_bf16(s[0], qa[ks], bk[0], bk[1]);
            tc::mma_bf16(s[1], qa[ks], bk[2], bk[3]);
            tc::mma_bf16(dp[0], oa[ks], bv[0], bv[1]);
            tc::mma_bf16(dp[1], oa[ks], bv[2], bv[3]);
          }
          const int jb = k0 + kt * 16;  // the tile's first key
#pragma unroll
          for (int nb = 0; nb < 2; ++nb) {
            const int j = jb + 8 * nb + 2 * t;
            if (j >= nk) s[nb][0] = s[nb][2] = -INFINITY;
            if (j + 1 >= nk) s[nb][1] = s[nb][3] = -INFINITY;
          }
          if (sweep == 0) {
            const float n0 = fmaxf(m0, tc::quad_max(fmaxf(fmaxf(s[0][0], s[0][1]),
                                                          fmaxf(s[1][0], s[1][1]))));
            const float n1 = fmaxf(m1, tc::quad_max(fmaxf(fmaxf(s[0][2], s[0][3]),
                                                          fmaxf(s[1][2], s[1][3]))));
            const float c0 = __expf(m0 - n0), c1 = __expf(m1 - n1);
            l0 *= c0;
            e0 *= c0;
            l1 *= c1;
            e1 *= c1;
#pragma unroll
            for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
              for (int u = 0; u < 2; ++u) {
                const float x0 = __expf(s[nb][u] - n0), x1 = __expf(s[nb][2 + u] - n1);
                l0 += x0;
                e0 += x0 * dp[nb][u];
                l1 += x1;
                e1 += x1 * dp[nb][2 + u];
              }
            }
            m0 = n0;
            m1 = n1;
          } else {
#pragma unroll
            for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
              for (int u = 0; u < 2; ++u) {
                const float p0 = __expf(s[nb][u] - m0) * inv0;
                const float p1 = __expf(s[nb][2 + u] - m1) * inv1;
                s[nb][u] = p0 * (dp[nb][u] - sg0);
                s[nb][2 + u] = p1 * (dp[nb][2 + u] - sg1);
                if (jb + 8 * nb + 2 * t + u == 0) {  // the CLS key: f32, outside the product
                  dsc0 = s[nb][u];
                  dsc1 = s[nb][2 + u];
                  pc0 = p0;
                  pc1 = p1;
                  s[nb][u] = s[nb][2 + u] = 0.f;
                }
              }
            }
            pv(dq, s, str0 + kt * 16 * PITCH);
          }
        }
      }
      if (sweep == 0 && active) {
        l0 = tc::quad_sum(l0);
        l1 = tc::quad_sum(l1);
        inv0 = 1.f / l0;
        inv1 = 1.f / l1;
        sg0 = tc::quad_sum(e0) * inv0;
        sg1 = tc::quad_sum(e1) * inv1;
      }
    }
    if (active) {
      const int r0 = (t0 + warp) * 16 + g;
      const bool v0 = r0 < n, v1 = r0 + 8 < n;
      // lane 4g holds the CLS column (key 0): its ds_c / p_c to the quad
      dsc0 = __shfl_sync(0xffffffffu, dsc0, lane & ~3);
      dsc1 = __shfl_sync(0xffffffffu, dsc1, lane & ~3);
      pc0 = __shfl_sync(0xffffffffu, pc0, lane & ~3);
      pc1 = __shfl_sync(0xffffffffu, pc1, lane & ~3);
      if (!v0) dsc0 = pc0 = 0.f;
      if (!v1) dsc1 = pc1 = 0.f;
      if (t == 0) {
        if (v0) stats[r0] = make_float4(m0, inv0, sg0, 0.f);
        if (v1) stats[r0 + 8] = make_float4(m1, inv1, sg1, 0.f);
        float* wr = wrow + warp * 32;
        wr[2 * g] = dsc0;
        wr[2 * g + 1] = pc0;
        wr[2 * (g + 8)] = dsc1;
        wr[2 * (g + 8) + 1] = pc1;
      }
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        if (j >= cpr) continue;  // the zero columns past dh
        const int col = 8 * j + 2 * t;
        const float2 kc = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(crow + D + col));
        if (v0)
          *reinterpret_cast<__nv_bfloat162*>(pdq + (int64_t)r0 * D3 + col) =
              __floats2bfloat162_rn((dq[j][0] + dsc0 * kc.x) * scale,
                                    (dq[j][1] + dsc0 * kc.y) * scale);
        if (v1)
          *reinterpret_cast<__nv_bfloat162*>(pdq + (int64_t)(r0 + 8) * D3 + col) =
              __floats2bfloat162_rn((dq[j][2] + dsc1 * kc.x) * scale,
                                    (dq[j][3] + dsc1 * kc.y) * scale);
      }
      __syncwarp();
      const float* wr = wrow + warp * 32;
#pragma unroll
      for (int u = 0; u < CU; ++u) {
        const int col = lane + 32 * u;
        for (int r = 0; r < 16; ++r) {
          ck[u] += wr[2 * r] * __bfloat162float(qw[r * PITCH + col]);
          cv[u] += wr[2 * r + 1] * __bfloat162float(ow[r * PITCH + col]);
        }
      }
      __syncwarp();
    }
  }
#pragma unroll
  for (int u = 0; u < CU; ++u) {
    wcls[warp * 2 * DH + lane + 32 * u] = ck[u];
    wcls[warp * 2 * DH + DH + lane + 32 * u] = cv[u];
  }
  __syncthreads();  // the stats and the warps' CLS partials are written
  for (int c = tid; c < 2 * dh; c += blockDim.x) {
    const int sc = c < dh ? c : DH + c - dh;  // dk's columns, then dv's
    float acc = 0.f;
    for (int w = 0; w < W; ++w) acc += wcls[w * 2 * DH + sc];
    a.cls_part_g[(bh * gridDim.y + grp) * 2 * dh + c] = acc;
  }

  // ------------------------------------------------------------ key-major
  const int nqc = (ntq + CT - 1) / CT;  // query chunks
  staged = -1;
  for (int t0 = 0; t0 < ntk; t0 += W) {
    const int kt_own = t0 + warp;
    const bool active = kt_own < ntk;
    const bf16* kw = own0 + warp * 16 * PITCH;
    const bf16* vw = own1 + warp * 16 * PITCH;
    __syncthreads();
    stage(own0, own1, t0 * 16, W * 16, true);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    float dk[DH / 8][4], dv[DH / 8][4];
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      dk[j][0] = dk[j][1] = dk[j][2] = dk[j][3] = dv[j][0] = dv[j][1] = dv[j][2] = dv[j][3] = 0.f;
    // keys g and g + 8 of the warp's tile: patch keys only (not the CLS row)
    const int kj0 = kt_own * 16 + g, kj1 = kj0 + 8;
    const bool kv0 = kj0 >= 1 && kj0 < nk, kv1 = kj1 >= 1 && kj1 < nk;
    for (int c = 0; c < nqc; ++c) {
      const int q0 = c * CR, ntc = min(CT, ntq - c * CT);
      if (staged != c) {
        __syncthreads();
        stage(str0, str1, q0, ntc * 16, false);
        cp_async_commit();
        for (int r = tid; r < ntc * 16; r += blockDim.x)
          sstat[r] = q0 + r < n ? __ldcg(stats + q0 + r) : make_float4(0.f, 0.f, 0.f, 0.f);
        cp_async_wait<0>();
        __syncthreads();
        scale_q(str0, ntc * 16);
        __syncthreads();
        staged = c;
      }
      if (!active) continue;
      for (int qt = 0; qt < ntc; ++qt) {
        float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
        for (int ks = 0; ks < NS; ++ks) {
          uint32_t ka[4], va[4], bq[4], bo[4];
          a_frag(ka, kw, ks);
          a_frag(va, vw, ks);
          b_frag(bq, str0 + qt * 16 * PITCH, ks);
          b_frag(bo, str1 + qt * 16 * PITCH, ks);
          tc::mma_bf16(s[0], ka, bq[0], bq[1]);
          tc::mma_bf16(s[1], ka, bq[2], bq[3]);
          tc::mma_bf16(dp[0], va, bo[0], bo[1]);
          tc::mma_bf16(dp[1], va, bo[2], bo[3]);
        }
        // s now holds p^T, dp ds^T; columns are queries 8 nb + 2 t + u
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int qi = qt * 16 + 8 * nb + 2 * t + u;
            const float4 st = sstat[qi];  // zero past the last query: p = 0
            const float p0 = kv0 ? __expf(s[nb][u] - st.x) * st.y : 0.f;
            const float p1 = kv1 ? __expf(s[nb][2 + u] - st.x) * st.y : 0.f;
            dp[nb][u] = p0 * (dp[nb][u] - st.z);
            dp[nb][2 + u] = p1 * (dp[nb][2 + u] - st.z);
            s[nb][u] = p0;
            s[nb][2 + u] = p1;
          }
        }
        pv(dv, s, str1 + qt * 16 * PITCH);
        pv(dk, dp, str0 + qt * 16 * PITCH);
      }
    }
    if (active) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int kj = half ? kj1 : kj0;
        if (!(half ? kv1 : kv0)) continue;
        const int64_t tok = kj - 1;  // the patch within the group
        const int64_t pi = bh * a.fn + tok0 + tok;
        const float dsa = a.ds_cls[pi], pa = a.p_cls[pi];
        bf16* out = pdq + tok * D3;
#pragma unroll
        for (int j = 0; j < DH / 8; ++j) {
          if (j >= cpr) continue;  // the zero columns past dh
          const int col = 8 * j + 2 * t;
          const float2 qc = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(crow + col));
          const float2 oc = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(cdo + col));
          *reinterpret_cast<__nv_bfloat162*>(out + D + col) = __floats2bfloat162_rn(
              dk[j][2 * half] + dsa * sft::bf16r(qc.x * scale),
              dk[j][2 * half + 1] + dsa * sft::bf16r(qc.y * scale));
          *reinterpret_cast<__nv_bfloat162*>(out + 2 * D + col) = __floats2bfloat162_rn(
              dv[j][2 * half] + pa * oc.x, dv[j][2 * half + 1] + pa * oc.y);
        }
      }
    }
  }
}

// (3) dk / dv of the CLS key: its own term plus every chunk's, in order;
// 2 * dh threads a (head, batch).
__global__ void __launch_bounds__(2 * tc::MAX_DH)
cls_reduce_kernel(const float* __restrict__ cls_part, const float* __restrict__ cls_part_g,
                  bf16* __restrict__ dqkv_c, int H, int dh, int nchunks, int cstride) {
  const int h = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
  const int D = H * dh;
  const int64_t bh = (int64_t)b * H + h;
  float acc = cls_part[bh * 2 * dh + t];
  for (int c = 0; c < nchunks; ++c) acc += cls_part_g[(bh * nchunks + c) * 2 * dh + t];
  const int which = t / dh, col = t % dh;
  dqkv_c[(int64_t)b * cstride * 3 * D + (1 + which) * D + h * dh + col] = __float2bfloat16(acc);
}

// The space pass's warps and shared memory for n patches a frame.
inline int space_warps(int n) {
  const int ntk = (n + 1 + 15) / 16;
  return ntk < SPACE_WARPS ? ntk : SPACE_WARPS;
}

template <int DHP>
size_t space_smem(int warps) {
  constexpr int CT = chunk_tiles(DHP);
  const size_t rows = 2 * (size_t)warps * 16 + 2 * (size_t)CT * 16;
  return rows * (DHP + 8) * sizeof(bf16) + (size_t)CT * 16 * sizeof(float4) +
         ((size_t)warps * 32 + (size_t)warps * 2 * DHP) * sizeof(float);
}

// The time pass's shared memory for P positions of f frames, HG heads at
// width DHP and ``warps`` warps.
inline size_t time_bwd_smem(int f, int HG, int DHP, int P, int warps) {
  return (size_t)(1 + f * P) * 4 * HG * DHP * sizeof(bf16) + (size_t)P * HG * f * 2 * sizeof(float) +
         (size_t)warps * 2 * f * (f + 1) * sizeof(float);
}

struct TimeBwdPlan {
  int P, HG, warps;
  size_t smem;
};

// All H heads and WARPS warps with the largest P of 4, 2 that fits
// TIME_BWD_SMEM_TARGET (2 at D = 768, f = 8: two blocks an SM); else P = 1,
// the largest HG dividing H (and min(WARPS, HG) warps, one item each at
// most) that fits the target, else that fits a block.
inline TimeBwdPlan time_bwd_plan(int f, int H, int DHP) {
  for (int P = 4; P > 1; P /= 2)
    if (time_bwd_smem(f, H, DHP, P, WARPS) <= TIME_BWD_SMEM_TARGET)
      return {P, H, WARPS, time_bwd_smem(f, H, DHP, P, WARPS)};
  const size_t limits[2] = {TIME_BWD_SMEM_TARGET, MAX_SMEM};
  for (size_t limit : limits)
    for (int hg = H; hg >= 1; --hg) {
      const int w = hg < WARPS ? hg : WARPS;
      if (H % hg == 0 && time_bwd_smem(f, hg, DHP, 1, w) <= limit)
        return {1, hg, w, time_bwd_smem(f, hg, DHP, 1, w)};
    }
  return {1, 1, 1, time_bwd_smem(f, 1, DHP, 1, 1)};
}

// mode 0 = space (groups are frames), 1 = time (groups are spatial
// positions, P a block). Scratch (f32, written before read): ds_cls and
// p_cls B*H*f*n each, cls_part B*H*2*dh, cls_part_g B*H*G*2*dh with G the
// block count over a segment's groups (f in space mode, ceil(n / P) in
// time mode), stats B*H*f*n*4 (space mode only).
template <int DHP>
int launch_bwd(const bf16* qkv_p, const bf16* qkv_c, const bf16* dop, const bf16* doc,
               float* ds_cls, float* p_cls, float* cls_part, float* cls_part_g, float* stats,
               bf16* dqkv_p, bf16* dqkv_c, int B, int f, int n, int H, int dh, int mode,
               Strides strd, cudaStream_t s) {
  const int fn = f * n;
  const float scale = (float)pow((double)dh, -0.5);
  BwdArgs a{qkv_p, qkv_c, dop, doc, ds_cls, p_cls, stats, cls_part_g, dqkv_p,
            fn, f, n, H, dh, H, 1, 1, strd, scale};
  size_t smem_g;
  int threads_g;
  if (mode == 0) {
    a.warps = space_warps(n);
    smem_g = space_smem<DHP>(a.warps);
    threads_g = a.warps * 32;
  } else {
    const TimeBwdPlan tp = time_bwd_plan(f, H, DHP);
    a.P = tp.P;
    a.HG = tp.HG;
    smem_g = tp.smem;
    threads_g = tp.warps * 32;
  }
  if (smem_g > MAX_SMEM) return (int)cudaErrorInvalidValue;
  const int nchunks = mode == 0 ? f : (n + a.P - 1) / a.P;

  const size_t smem_c = (2 * DHP + 32 + 2 + (CLS_THREADS / 32) * DHP + 2 * (size_t)(fn + 1)) *
                        sizeof(float);
  auto cls = dh == DHP ? cls_bwd_kernel<DHP, true> : cls_bwd_kernel<DHP, false>;
  cudaFuncSetAttribute(cls, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_c);
  SFT_CHECK_LAUNCH();
  cls<<<dim3(H, B), CLS_THREADS, smem_c, s>>>(qkv_p, qkv_c, doc, ds_cls, p_cls, cls_part,
                                              dqkv_c, fn, H, dh, strd, scale);
  SFT_CHECK_LAUNCH();

  if (mode == 0) {
    auto kern = dh == DHP ? space_bwd_mma_kernel<DHP, true> : space_bwd_mma_kernel<DHP, false>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_g);
    SFT_CHECK_LAUNCH();
    kern<<<dim3(H, f, B), threads_g, smem_g, s>>>(a);
  } else {
    auto kern = dh == DHP && a.HG == H && threads_g == TIME_THREADS ? time_bwd_kernel<DHP, true>
                                                                     : time_bwd_kernel<DHP, false>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_g);
    SFT_CHECK_LAUNCH();
    kern<<<dim3(nchunks, B, H / a.HG), threads_g, smem_g, s>>>(a);
  }
  SFT_CHECK_LAUNCH();

  cls_reduce_kernel<<<dim3(H, B), 2 * dh, 0, s>>>(cls_part, cls_part_g, dqkv_c, H, dh, nchunks,
                                                  strd.c);
  SFT_CHECK_LAUNCH();
  return 0;
}

// launch_bwd at tc::padded_width(dh); a dh that is not a multiple of 8 or
// is above 256 is refused (the wrappers refuse it before they launch).
int dispatch_bwd(int dh, const void* qkv_p, const void* qkv_c, const void* dop, const void* doc,
                 void* ds_cls, void* p_cls, void* cls_part, void* cls_part_g, void* stats,
                 void* dqkv_p, void* dqkv_c, int B, int f, int n, int H, int mode, Strides strd,
                 void* stream) {
#define SFT_BWD(W)                                                                            \
  case W:                                                                                     \
    return launch_bwd<W>(static_cast<const bf16*>(qkv_p), static_cast<const bf16*>(qkv_c),    \
                         static_cast<const bf16*>(dop), static_cast<const bf16*>(doc),        \
                         static_cast<float*>(ds_cls), static_cast<float*>(p_cls),             \
                         static_cast<float*>(cls_part), static_cast<float*>(cls_part_g),      \
                         static_cast<float*>(stats), static_cast<bf16*>(dqkv_p),              \
                         static_cast<bf16*>(dqkv_c), B, f, n, H, dh, mode, strd,              \
                         static_cast<cudaStream_t>(stream))
  switch (tc::padded_width(dh)) {
    SFT_BWD(32);
    SFT_BWD(64);
    SFT_BWD(96);
    SFT_BWD(128);
    SFT_BWD(192);
    SFT_BWD(256);
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
                                         void* stats, void* dqkv_p, void* dqkv_c, int B, int f,
                                         int n, int H, int dh, int mode, void* stream) {
  const int fn = f * n;
  return dispatch_bwd(dh, qkv_p, qkv_c, dop, doc, ds_cls, p_cls, cls_part, cls_part_g, stats,
                      dqkv_p, dqkv_c, B, f, n, H, mode, Strides{fn, 1, fn, 1}, stream);
}

// K7c on the packed layout: dqkv (B, 1 + f*n, 3D) from qkv of that shape and
// the cotangent dout (B, 1 + f*n, D). Scratch as K6's.
extern "C" int sft_divided_attention_packed_bwd(const void* qkv, const void* dout,
                                                void* ds_cls, void* p_cls, void* cls_part,
                                                void* cls_part_g, void* stats, void* dqkv, int B,
                                                int f, int n, int H, int dh, int mode,
                                                void* stream) {
  const int seq = 1 + f * n, D = H * dh;
  const bf16* q = static_cast<const bf16*>(qkv);
  const bf16* o = static_cast<const bf16*>(dout);
  bf16* dq = static_cast<bf16*>(dqkv);
  return dispatch_bwd(dh, q + 3 * D, q, o + D, o, ds_cls, p_cls, cls_part, cls_part_g, stats,
                      dq + 3 * D, dq, B, f, n, H, mode, Strides{seq, seq, seq, seq}, stream);
}
