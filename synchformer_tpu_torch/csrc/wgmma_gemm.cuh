// The Hopper GEMM under K1's projection, K2's two MLP products, the fused
// route's products (K8a's QKV, K8b's fc1 and fc2, K8c) and, above a few
// groups, the CLS-pool layers' (K4's and K4b's tail, K4b's q):
//
//   C[M,N] = epilogue(A[M,K] @ W[N,K]^T + bias)
//
// bf16 operands, f32 accumulation on wgmma. A is row-major and W a torch
// Linear weight (out, in), so both are K-major: the layout wgmma reads from
// shared memory without a transpose.
//
// It replaced the WMMA tile GEMM these callers had (one 64x64 tile a block,
// plain loads, no pipelining: about 115-120 TFLOP/s on an NVIDIA H100 80GB
// HBM3 at 700 W, PERF.md). At K2's shapes (175616 rows, 768
// -> 3072 -> 768: 830 GFLOP a product) the card is bound by its tensor cores,
// so the design is about keeping them fed:
// - tiles reach shared memory by TMA (cp.async.bulk.tensor.2d, 128-byte
//   swizzle, the layout wgmma's descriptors name) into a ring of STAGES
//   stages of BM x BK of A and BN x BK of W, each guarded by a full / empty
//   mbarrier pair;
// - one producer warpgroup (one elected thread) issues the loads; two
//   consumer warpgroups issue wgmma.mma_async m64n128k16, one k-step of
//   products kept in flight, and hold 128 f32 accumulators a thread
//   (setmaxnreg moves registers from the producer, 40, to them, 232). They
//   share the work in one of two schedules:
//   - ping-pong (EPI_BIAS, EPI_BIAS_RESIDUAL, and the GELUs where N % 256
//     != 0): each consumer owns whole 128 x 128 tiles, the block's tiles in
//     turns, and an order barrier lets one run its main loop while the
//     other runs its epilogue, so the tensor cores do not wait for it;
//   - cooperative (the GELUs, where N % 256 == 0): both consumers work on
//     one 128 x 256 tile, 64 rows each, and run its epilogue together. The
//     GELU is the longest epilogue, and one warpgroup alone (one warp a
//     scheduler) hides its latency so poorly that the ping-pong schedule was
//     22% slower at fc1 on an NVIDIA H100 80GB HBM3 at 700 W (2.190 against
//     1.706 ms, PERF.md), where it was 6% and 23% faster at fc2 and K1's
//     projection;
// - the grid is persistent (one block an SM) and walks the output tiles with
//   the column tile fastest, so the tiles in flight share a few row panels
//   of A, which L2 keeps: A comes from device memory once, W (at most 4.7 MB
//   here) stays in L2;
// - the epilogue stages each 64 x 64 piece of a consumer's output in shared memory
//   (bias, then GELU, rounded once to bf16) and writes it, and reads the
//   residual (its loads started before the piece is staged), with 16-byte
//   accesses.
//
// Epilogues (tile_gemm.cuh::Epilogue), each rounded as the JAX kernels do:
// - EPI_BIAS: bf16(acc + bias);
// - EPI_BIAS_GELU: bf16(erf-GELU(acc + bias)), in f32;
// - EPI_BIAS_GELU_POLY: bf16(GELU(acc + bias)) with the TPU kernels' clamped
//   degree-9 erf polynomial (tile_gemm.cuh::gelu_poly), in f32 (K8b's fc1);
// - EPI_BIAS_RESIDUAL: bf16(R + bf16(acc + bias)), the JAX
//   `x + (y + b).astype(dtype)`.
//
// Shapes: any M >= 1 up to 2^31 - 1 (TMA fills the rows past M with zeros,
// and the stores are masked), any N >= 1 and K >= 1. A and W are read by TMA
// at row strides lda and ldw that are multiples of 8 (16 bytes: a TMA
// descriptor's rule) and at least K; TMA fills their columns past K with
// zeros, whose products add nothing (K8c's d = 96, fc2 over hidden 1996). C
// has row stride ldc >= N and R r_stride. Where N % 128 == 0, ldc == N and
// r_stride is a multiple of 8, the epilogue is the plain one above; else the
// TAIL variant of the ping-pong schedule reads the bias and the residual
// element by element past N (or where a row is not 16-byte aligned), writes
// zeros into C's columns from N to the next multiple of 8 within ldc (the
// pad a caller that holds an activation at a 16-byte pitch needs zeroed),
// and stores element by element where ldc is not a multiple of 8. TMA takes W
// rows past N as zeros, so the last column tile's products there are zero.
// 16-byte aligned A, W, R and C. The TMA descriptors are built per call on
// the host with cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint, so the library links nothing beyond the runtime.
#pragma once

#include <cuda.h>
#include <limits.h>

#include "tile_gemm.cuh"

namespace sft {
namespace wg {

constexpr int BM = 128;
constexpr int BK = 64;  // 128 bytes of bf16: one swizzle span
constexpr int THREADS = 384;  // the producer warpgroup, then two consumers
constexpr int EPI_COLS = 64;  // output columns a consumer stages at a time
constexpr int EPI_PITCH = EPI_COLS + 8;  // bf16 row pitch: conflict-free pair stores
constexpr long long HANG_CYCLES = 1ll << 35;  // ~17 s: a barrier wait this long traps

// PP: the ping-pong schedule (128 x 128 tiles, 6 stages), else the
// cooperative one (128 x 256 tiles, 4 stages); both fill 192 KB of stages
template <bool PP>
struct Cfg {
  static constexpr int BN = PP ? 128 : 256;
  static constexpr int STAGES = PP ? 6 : 4;
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int STAGE_BYTES = A_BYTES + BN * BK * 2;
  static constexpr int EPI_BYTES = 2 * 64 * EPI_PITCH * 2;
  // 1024 bytes of slack to align the stages to the swizzle's 1024-byte
  // atom; full, empty and the two consumers' order barriers
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + EPI_BYTES + (2 * STAGES + 2) * 8;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the barrier's phase of this parity has completed. A wait that
// outlasts HANG_CYCLES traps, so that a pipeline fault fails the launch
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  long long t0 = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) {
      t0 = clock64();
    } else if (clock64() - t0 > HANG_CYCLES) {
      __trap();
    }
  }
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile with 128-byte rows in the
// 128-byte swizzle: 8-row atoms 1024 bytes apart (SBO), LBO unused (1).
__device__ __forceinline__ uint64_t smem_desc(const bf16* p) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Tie the accumulators to this point, so that no access to them moves across
// a wgmma fence or wait.
__device__ __forceinline__ void keep(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, f32) = A (64 x 16) @ B (128 x 16)^T + (scale_d ? d : 0).
// Register i of a thread holds row warp*16 + lane/4 + 8*((i/2)%2), column
// 8*(i/4) + 2*(lane%4) + i%2.
__device__ __forceinline__ void wgmma_128(float (&d)[64], uint64_t da, uint64_t db,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, "
      "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The 8 bf16 from p of which the first ``have`` exist (the rest read as
// zero): one 16-byte load where ``vec`` and all 8 exist, else one by one.
__device__ __forceinline__ uint4 load8_tail(const bf16* p, int have, bool vec) {
  if (vec && have >= 8) return __ldg(reinterpret_cast<const uint4*>(p));
  uint4 out = make_uint4(0u, 0u, 0u, 0u);
  unsigned short* o = reinterpret_cast<unsigned short*>(&out);
  const unsigned short* src = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (e < have) o[e] = src[e];
  return out;
}

// 8 bf16 to p: the first ``have`` from v, then zeros, none at or past
// ``room`` (the end of the row); one 16-byte store where ``vec`` and all 8
// fit.
__device__ __forceinline__ void store8_tail(bf16* p, uint4 v, int have, int room, bool vec) {
  unsigned short* x = reinterpret_cast<unsigned short*>(&v);
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (e >= have) x[e] = 0;
  if (vec && room >= 8) {
    *reinterpret_cast<uint4*>(p) = v;
    return;
  }
  unsigned short* dst = reinterpret_cast<unsigned short*>(p);
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (e < room) dst[e] = x[e];
}

// 8 bf16 of r plus 8 bf16 of y, summed in f32 and rounded once.
__device__ __forceinline__ uint4 add8(uint4 r, uint4 y) {
  const __nv_bfloat162* a = reinterpret_cast<const __nv_bfloat162*>(&r);
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&y);
  uint4 out;
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 u = __bfloat1622float2(a[e]), v = __bfloat1622float2(b[e]);
    o[e] = __floats2bfloat162_rn(u.x + v.x, u.y + v.y);
  }
  return out;
}

// Output tile t of a (tiles_m x tiles_n) grid: the column tile runs fastest.
// Block b takes tiles b, b + gridDim.x, ... (its j-th tile); in the
// ping-pong schedule consumer c takes the block's tiles j = c, c + 2, ...,
// in the cooperative one both take every tile (the plan the wrappers' host
// side mirrors in ops/kernels/_build.py::gemm_plan). TAIL: the epilogue for
// N % 128 != 0, C's pitch other than N or residual rows that are not 16-byte
// aligned (ping-pong only).
template <int EPI, bool PP, bool TAIL>
__global__ void __launch_bounds__(THREADS, 1)
gemm_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_w,
            const float* __restrict__ bias, const bf16* __restrict__ R, int64_t r_stride,
            bf16* __restrict__ C, int64_t ldc, int M, int N, int K) {
  static_assert(PP || !TAIL, "the tail epilogue runs on the ping-pong schedule");
  using CF = Cfg<PP>;
  constexpr int BN = CF::BN, STAGES = CF::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* epi = reinterpret_cast<bf16*>(base + STAGES * CF::STAGE_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + STAGES * CF::STAGE_BYTES + CF::EPI_BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* order = empty + STAGES;  // order[c]: consumer c may start its next main loop
  auto tile_a = [&](int s) { return reinterpret_cast<bf16*>(base + s * CF::STAGE_BYTES); };
  auto tile_w = [&](int s) {
    return reinterpret_cast<bf16*>(base + s * CF::STAGE_BYTES + CF::A_BYTES);
  };

  const int tiles_n = (N + BN - 1) / BN;
  const int tiles = ((M + BM - 1) / BM) * tiles_n;
  const int ksteps = (K + BK - 1) / BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      // every thread of the warpgroups that read the stage releases it
      mbar_init(&empty[s], PP ? 128 : 256);
    }
    mbar_init(&order[0], 128);
    mbar_init(&order[1], 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t / tiles_n) * BM, n0 = (t % tiles_n) * BN;
        for (int kb = 0; kb < ksteps; ++kb) {
          mbar_wait(&empty[stage], phase ^ 1);  // the first pass finds every stage free
          mbar_expect_tx(&full[stage], CF::STAGE_BYTES);
          tma_load_2d(tile_a(stage), &map_a, &full[stage], kb * BK, m0);
          tma_load_2d(tile_w(stage), &map_w, &full[stage], kb * BK, n0);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = threadIdx.x / 128 - 1;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  bf16* eb = epi + c * 64 * EPI_PITCH;
  // acc[h]: ping-pong, rows h*64.. of the tile, its 128 columns; cooperative,
  // rows c*64.., columns h*128..
  float acc[2][64] = {};
  for (int j = PP ? c : 0;; j += PP ? 2 : 1) {
    const int t = blockIdx.x + j * gridDim.x;
    if (t >= tiles) break;
    const int m0 = (t / tiles_n) * BM, n0 = (t % tiles_n) * BN;
    // ping-pong: the main loops alternate, so the other consumer has waited
    // for every stage of the block's tile j - 1, and each stage this one
    // waits for is at most one lap of the ring ahead of its barrier
    if (PP && j > 0) mbar_wait(&order[c], ((j - 1) / 2) & 1);
    const long long first = (long long)j * ksteps;  // the stage uses before this tile
    int stage = (int)(first % STAGES);
    uint32_t phase = (uint32_t)((first / STAGES) & 1);
    int prev = stage;
    for (int kb = 0; kb < ksteps; ++kb) {
      mbar_wait(&full[stage], phase);
      keep(acc[0]);
      keep(acc[1]);
      wgmma_fence();
      const bf16* a = tile_a(stage);
      const bf16* w = tile_w(stage);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
          wgmma_128(acc[h], smem_desc(a + (PP ? h : c) * 64 * BK + kk * 16),
                    smem_desc(w + (PP ? 0 : h) * 128 * BK + kk * 16), (kb | kk) != 0);
      }
      wgmma_commit();
      // this k-step's products stay in flight; the previous step's are done,
      // so its stage goes back to the producer
      wgmma_wait<1>();
      keep(acc[0]);
      keep(acc[1]);
      if (kb > 0) mbar_arrive(&empty[prev]);
      prev = stage;
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    if (PP) mbar_arrive(&order[1 - c]);  // the other consumer's next main loop may start
    wgmma_wait<0>();
    keep(acc[0]);
    keep(acc[1]);
    mbar_arrive(&empty[prev]);

    // four 64 x 64 pieces; piece p holds registers acc[p / 2][(p % 2) * 32 ..]
    const int r0 = warp * 16 + lane / 4;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int64_t row0 = (int64_t)m0 + (PP ? p / 2 : c) * 64;
      const int col0 = n0 + (PP ? p % 2 : p) * EPI_COLS;
      // past N: the right half of a last ping-pong tile of 64 or less (a
      // left half always starts below N; the cooperative schedule runs only
      // where N % 256 == 0). Checking every piece instead made K2's and
      // K8b's fc1 2-10% slower (PERF.md)
      if (PP && p % 2 == 1 && col0 >= N) continue;
      // the residual's 16-byte loads first, so that they are in flight
      // while the piece is staged (TAIL: element by element past N or where
      // its rows are not 16-byte aligned)
      uint4 res[64 * EPI_COLS / 8 / 128];
      if (EPI == EPI_BIAS_RESIDUAL) {
#pragma unroll
        for (int v = 0; v < 64 * EPI_COLS / 8 / 128; ++v) {
          const int idx = tid + v * 128;
          const int64_t gm = row0 + idx / (EPI_COLS / 8);
          const int gn = col0 + idx % (EPI_COLS / 8) * 8;
          res[v] = gm < M ? (TAIL ? load8_tail(R + gm * r_stride + gn, N - gn, r_stride % 8 == 0)
                                  : __ldg(reinterpret_cast<const uint4*>(R + gm * r_stride + gn)))
                          : make_uint4(0u, 0u, 0u, 0u);
        }
      }
#pragma unroll
      for (int jb = 0; jb < EPI_COLS / 8; ++jb) {
        const int i = ((p % 2) * (EPI_COLS / 8) + jb) * 4;  // the n8 block's registers
        const int col = jb * 8 + 2 * (lane % 4);
        const float2 bb =
            TAIL ? make_float2(col0 + col < N ? __ldg(bias + col0 + col) : 0.f,
                               col0 + col + 1 < N ? __ldg(bias + col0 + col + 1) : 0.f)
                 : __ldg(reinterpret_cast<const float2*>(bias + col0 + col));
        float v0 = acc[p / 2][i] + bb.x, v1 = acc[p / 2][i + 1] + bb.y;
        float v2 = acc[p / 2][i + 2] + bb.x, v3 = acc[p / 2][i + 3] + bb.y;
        if (EPI == EPI_BIAS_GELU) {
          v0 = gelu_erf(v0);
          v1 = gelu_erf(v1);
          v2 = gelu_erf(v2);
          v3 = gelu_erf(v3);
        }
        if (EPI == EPI_BIAS_GELU_POLY) {
          v0 = gelu_poly(v0);
          v1 = gelu_poly(v1);
          v2 = gelu_poly(v2);
          v3 = gelu_poly(v3);
        }
        *reinterpret_cast<__nv_bfloat162*>(eb + r0 * EPI_PITCH + col) =
            __floats2bfloat162_rn(v0, v1);
        *reinterpret_cast<__nv_bfloat162*>(eb + (r0 + 8) * EPI_PITCH + col) =
            __floats2bfloat162_rn(v2, v3);
      }
      bar_sync(1 + c, 128);
#pragma unroll
      for (int v = 0; v < 64 * EPI_COLS / 8 / 128; ++v) {
        const int idx = tid + v * 128;
        const int r = idx / (EPI_COLS / 8), q = idx % (EPI_COLS / 8);
        const int64_t gm = row0 + r;
        if (gm < M) {
          uint4 o = *reinterpret_cast<const uint4*>(eb + r * EPI_PITCH + q * 8);
          if (EPI == EPI_BIAS_RESIDUAL) o = add8(res[v], o);
          if (TAIL)
            store8_tail(C + gm * ldc + col0 + q * 8, o, N - col0 - q * 8,
                        (int)(ldc - col0 - q * 8), ldc % 8 == 0);
          else
            *reinterpret_cast<uint4*>(C + gm * N + col0 + q * 8) = o;
        }
      }
      bar_sync(1 + c, 128);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A 2-D map of a row-major (rows, cols) bf16 matrix with row stride ld
// elements (a multiple of 8), box BK columns x box_rows rows, 128-byte
// swizzle; rows past the last and columns past cols read as zeros.
inline bool make_map(CUtensorMap* map, const bf16* ptr, int64_t rows, int64_t cols, int64_t ld,
                     int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<bf16*>(ptr), dims,
                   strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                   CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline int sm_count() {
  static int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  return sms;
}

template <int EPI, bool PP, bool TAIL>
int launch(const bf16* A, int64_t lda, const bf16* W, int64_t ldw, const float* bias,
           const bf16* R, int64_t r_stride, bf16* C, int64_t ldc, int M, int N, int K,
           cudaStream_t s) {
  using CF = Cfg<PP>;
  CUtensorMap ma, mw;
  if (!make_map(&ma, A, M, K, lda, BM) || !make_map(&mw, W, N, K, ldw, CF::BN))
    return (int)cudaErrorInvalidValue;
  const int tiles = ((M + BM - 1) / BM) * ((N + CF::BN - 1) / CF::BN);
  const int grid = tiles < sm_count() ? tiles : sm_count();
  cudaFuncSetAttribute(gemm_kernel<EPI, PP, TAIL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       CF::SMEM);
  SFT_CHECK_LAUNCH();
  gemm_kernel<EPI, PP, TAIL><<<grid, THREADS, CF::SMEM, s>>>(ma, mw, bias, R, r_stride, C, ldc,
                                                            M, N, K);
  SFT_CHECK_LAUNCH();
  return 0;
}

}  // namespace wg

// C = epilogue(A @ W^T + bias) on the Hopper GEMM, A (M, K) at row stride
// lda, W (N, K) at ldw, C (M, N) at ldc; R (EPI_BIAS_RESIDUAL only) has row
// stride r_stride elements. Returns a CUDA error code: invalid value for a
// shape it does not take, symbol not found without libcuda's TMA encoder
// (cuTensorMapEncodeTiled).
template <int EPI>
inline int wgmma_gemm_strided(const bf16* A, int64_t lda, const bf16* W, int64_t ldw,
                              const float* bias, const bf16* R, int64_t r_stride, bf16* C,
                              int64_t ldc, int64_t M, int N, int K, cudaStream_t s) {
  if (M < 1 || M > INT_MAX || N < 1 || K < 1 || lda < K || ldw < K || ldc < N || lda % 8 != 0 ||
      ldw % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (wg::encoder() == nullptr) return (int)cudaErrorSymbolNotFound;
  const bool tail =
      N % 128 != 0 || ldc != N || (EPI == EPI_BIAS_RESIDUAL && r_stride % 8 != 0);
  if (tail)
    return wg::launch<EPI, true, true>(A, lda, W, ldw, bias, R, r_stride, C, ldc, (int)M, N, K, s);
  if ((EPI == EPI_BIAS_GELU || EPI == EPI_BIAS_GELU_POLY) && N % 256 == 0)
    return wg::launch<EPI, false, false>(A, lda, W, ldw, bias, R, r_stride, C, ldc, (int)M, N, K,
                                         s);
  return wg::launch<EPI, true, false>(A, lda, W, ldw, bias, R, r_stride, C, ldc, (int)M, N, K, s);
}

// wgmma_gemm_strided on contiguous A (M, K), W (N, K) and C (M, N).
template <int EPI>
inline int wgmma_gemm(const bf16* A, const bf16* W, const float* bias, const bf16* R,
                      int64_t r_stride, bf16* C, int64_t M, int N, int K, cudaStream_t s) {
  return wgmma_gemm_strided<EPI>(A, K, W, K, bias, R, r_stride, C, N, M, N, K, s);
}

}  // namespace sft
