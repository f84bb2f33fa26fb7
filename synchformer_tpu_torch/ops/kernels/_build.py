"""Build and load the port's CUDA kernels: nvcc into shared libraries with a
plain C interface, loaded with ctypes.

Each ``csrc/<name>.cu`` becomes ``build/torch_kernels/<name>-<hash>.so`` at
first use, where the hash covers every file under ``csrc/`` and the compile
flags, so an edited source rebuilds. No PyTorch headers are compiled in, which
keeps a build at seconds. Every C entry returns ``cudaGetLastError()``;
``check`` raises on a non-zero code. Nothing here runs at import time.

Kernels launch on PyTorch's current stream. A wrapper may drop its scratch
tensors as soon as it has enqueued the launch: the caching allocator hands
their memory only to later work on the same stream, which runs after it.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the Hopper GEMM (csrc/wgmma_gemm.cuh, under K1, K2, K4, K4b and K8a-K8c): TMA row
# coordinates are 32-bit; its persistent grid has no limit of its own. Any N
# and K: A's and W's rows are read by TMA at strides that are multiples of
# WGMMA_LD_QUANTUM elements (16 bytes), which fills their columns past K
# with zeros over WGMMA_BK-deep k-steps; where N % WGMMA_TAIL_N != 0, C's
# pitch is not N or the residual's row stride is not a multiple of 8, the
# tail epilogue runs (bias and residual read element by element past N, C's
# pad columns zeroed)
WGMMA_MAX_ROWS = 2 ** 31 - 1
WGMMA_BM, WGMMA_BK = 128, 64
WGMMA_LD_QUANTUM, WGMMA_TAIL_N = 8, 128
# the attention kernels (csrc/mma_attention.cuh::padded_width): a head_dim
# that is a multiple of 8 up to the last width runs at the least width that
# holds it, its columns past head_dim staged as zeros
ATTN_WIDTHS = (32, 64, 96, 128, 192, 256)
# the time pass of the divided attention (csrc/divided_attention.cuh)
TIME_WARPS = 8
TIME_SMEM_TARGET = 57344
MAX_SMEM = 232448  # shared memory one block may take on the H100
# the divided attention's backward (csrc/divided_attention_bwd.cu): the
# space pass's warps a block at most and 16-row tiles of a streamed chunk
# at widths up to 128 (chunk_tiles: fewer at 192 and 256); the time pass's
# warps at most and shared-memory target
BWD_SPACE_WARPS = 8
BWD_SPACE_CHUNK_TILES = 13
BWD_TIME_WARPS = 8
BWD_TIME_SMEM_TARGET = 114688
# the CLS-pool layer (csrc/cls_pool.cu, K4 and K4b): the pool pass's heads
# (Z's 16-row tile) and groups a block at most
CLS_MAXH = 16
CLS_GMAX = 16

# launches of each kernel wrapper on a CUDA tensor, keyed K1..K4, K4b, K5,
# K6, K7a, K7b, K7c, K8a, K8b, K8c, and GEMM (the Hopper GEMM's own entry,
# which no model path calls)
launches: collections.Counter = collections.Counter()

_libs: dict = {}
_lock = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# csrc/<name>.cu -> {its C entry: argtypes}; the first entry is the default
_SIGNATURES = {
    "ln_mlp": {"sft_ln_mlp": [_P] * 6 + [_L] + [_P] * 3 + [_L] + [_P] * 2
               + [_L, _I, _I, _F, _I, _P],
               "sft_ln_matmul": [_P] * 7 + [_L, _I, _I, _F, _P]},
    "standard_attention": {"sft_standard_attention": [_P, _P, _I, _I, _I, _I, _P]},
    "cls_pool": {"sft_cls_pool_tokens": [_P] * 21 + [_I] * 8 + [_F, _P],
                 "sft_cls_pool": [_P] * 20 + [_I] * 8 + [_F, _P]},
    "divided_attention": {"sft_divided_attention_proj": [_P] * 8 + [_I] * 6 + [_P],
                          "sft_divided_attention": [_P] * 4 + [_I] * 6 + [_P],
                          "sft_divided_attention_packed": [_P] * 2 + [_I] * 6 + [_P]},
    "divided_attention_bwd": {"sft_divided_attention_bwd": [_P] * 11 + [_I] * 6 + [_P],
                              "sft_divided_attention_packed_bwd": [_P] * 8 + [_I] * 6 + [_P]},
    "gemm": {"sft_gemm": [_P, _L, _P, _L, _P, _P, _L, _P, _L, _L, _I, _I, _I, _P]},
    "fused_block": {"sft_fused_divided_attention": [_P] * 8 + [_I] * 6 + [_F, _P]},
}


def gemm_plan(m: int, n: int, k: int, epilogue: str = "bias", sms: int = 132) -> dict:
    """The launch plan of the Hopper GEMM (csrc/wgmma_gemm.cuh) for C[m, n]
    = A[m, k] @ W[n, k]^T with C (m, n) contiguous: its schedule
    (``cooperative``, 128 x 256 tiles, for the GELU epilogues where n % 256
    == 0 and no tail; else ``ping-pong``, 128 x 128 tiles), whether the
    ``tail`` epilogue runs (n % WGMMA_TAIL_N != 0; the kernel also takes it
    for a C pitch other than n and a residual whose rows are not 16-byte
    aligned), the tile grid, and the persistent grid (one block an SM, at
    most one a tile). Block b takes tiles b, b + grid, ...; tile t is row
    tile t // tiles_n, column tile t % tiles_n. Raises on a shape the kernel
    does not take."""
    require(0 < m <= WGMMA_MAX_ROWS, f"the Hopper GEMM takes 1 to {WGMMA_MAX_ROWS} rows, got {m}")
    require(n >= 1 and k >= 1, f"the Hopper GEMM takes N, K >= 1, got N={n}, K={k}")
    tail = n % WGMMA_TAIL_N != 0
    cooperative = not tail and epilogue in ("gelu", "gelu_poly") and n % 256 == 0
    bn = 256 if cooperative else 128
    tiles_m, tiles_n = -(-m // WGMMA_BM), -(-n // bn)
    return {"schedule": "cooperative" if cooperative else "ping-pong", "bn": bn, "tail": tail,
            "tiles_m": tiles_m, "tiles_n": tiles_n, "grid": min(tiles_m * tiles_n, sms)}


def gemm_block_tiles(plan: dict, block: int, consumer: int | None = None) -> list:
    """The (row tile, column tile) pairs block ``block`` of ``plan`` walks,
    in order; with ``consumer`` (0 or 1), those that consumer warpgroup
    works on (ping-pong: every other one; cooperative: all of them, its 64
    rows of each)."""
    tiles, tn = plan["tiles_m"] * plan["tiles_n"], plan["tiles_n"]
    mine = [(t // tn, t % tn) for t in range(block, tiles, plan["grid"])]
    return mine[consumer::2] if consumer is not None and plan["schedule"] == "ping-pong" else mine


def padded_width(dh: int) -> int:
    """The width the attention kernels run head_dim ``dh`` at: the least of
    ATTN_WIDTHS that holds it (csrc/mma_attention.cuh::padded_width). Raises
    on a head_dim that is not a multiple of 8 or is above the last width."""
    require(dh >= 8 and dh % 8 == 0 and dh <= ATTN_WIDTHS[-1],
            f"the attention kernels take a head_dim that is a multiple of 8 up to "
            f"{ATTN_WIDTHS[-1]}, got {dh}")
    return next(w for w in ATTN_WIDTHS if dh <= w)


def head_dim(what: str, d: int, heads: int) -> int:
    """D over ``heads`` heads as the attention kernels take it: heads
    dividing D, head_dim a multiple of 8 up to 256 (padded_width)."""
    require(heads >= 1 and d % heads == 0, f"{what}: D={d} does not split into {heads} heads")
    padded_width(d // heads)
    return d // heads


def _divisors_down(h: int) -> list:
    return [g for g in range(h, 0, -1) if h % g == 0]


def time_pass_plan(f: int, n: int, d: int, heads: int) -> dict:
    """The launch plan of the divided attention's time pass
    (csrc/divided_attention.cuh::time_plan, time_attention_kernel) over
    ``heads`` heads of D = d: ``heads_a_block`` HG and ``p`` spatial
    positions a block (all heads and the largest of 4, 2 whose f * p + 1 key
    / value rows, at the padded head width, fit TIME_SMEM_TARGET bytes; else
    p = 1 and the largest HG dividing the heads that fits the target, else
    that fits a block), ``blocks`` position tiles a segment, ``head_groups``,
    and the block's shared memory. Raises where even one head's rows do not
    fit a block: the cap is set by the head width, not by D."""
    dhp = padded_width(head_dim("the time pass", d, heads))

    def smem(p, hg):
        return (1 + f * p) * 2 * hg * dhp * 2 + TIME_WARPS * 8 * (f + 1) * 4

    p, hg = next(((p, heads) for p in (4, 2) if smem(p, heads) <= TIME_SMEM_TARGET), (1, None))
    if hg is None:
        hg = next((g for limit in (TIME_SMEM_TARGET, MAX_SMEM) for g in _divisors_down(heads)
                   if smem(1, g) <= limit), None)
        require(hg is not None,
                f"the time pass stages {f} frames' keys and values of one head (width {dhp}) "
                f"in a block: {smem(1, 1)} bytes of shared memory, more than {MAX_SMEM}")
    return {"p": p, "heads_a_block": hg, "head_groups": heads // hg, "blocks": -(-n // p),
            "smem": smem(p, hg)}


def cls_row_smem(fn: int, dh: int, backward: bool = False) -> int:
    """Shared memory (bytes) of the CLS row's launch over 1 + fn keys at
    head_dim dh (divided_attention.cuh::launch_attention's smem_c; with
    ``backward``, divided_attention_bwd.cu::launch_bwd's): the scaled query
    (and cotangent), the warps' sums and one (two) f32 a key."""
    w = padded_width(dh)
    if backward:
        return (2 * w + 32 + 2 + 16 * w + 2 * (fn + 1)) * 4
    return (w + 32 + 8 * w + fn + 1) * 4


def space_bwd_plan(n: int, dh: int) -> dict:
    """The launch plan of the backward's space pass
    (csrc/divided_attention_bwd.cu::space_bwd_mma_kernel) for frames of n
    patches at head_dim dh (run at its padded width): ``warps`` a block (one
    16-row tile each, at most BWD_SPACE_WARPS), the query / key tiles, the
    streamed chunks of ``chunk_tiles`` tiles (BWD_SPACE_CHUNK_TILES up to
    width 128, 8 at 192, 4 at 256) over the n + 1 keys and over the n
    queries, and the block's shared memory, which depends on the width and
    the warps but not otherwise on n."""
    w = padded_width(dh)
    ct = BWD_SPACE_CHUNK_TILES if w <= 128 else (8 if w <= 192 else 4)
    tq, tk = -(-n // 16), -(-(n + 1) // 16)
    warps = min(tk, BWD_SPACE_WARPS)
    pitch = (w + 8) * 2
    smem = ((2 * warps * 16 + 2 * ct * 16) * pitch + ct * 16 * 16
            + (warps * 32 + warps * 2 * w) * 4)
    require(smem <= MAX_SMEM, f"the backward's space pass at head_dim {dh} takes {smem} bytes "
            f"of shared memory, more than {MAX_SMEM}")
    return {"warps": warps, "query_tiles": tq, "key_tiles": tk, "chunk_tiles": ct,
            "key_chunks": -(-tk // ct), "query_chunks": -(-tq // ct), "smem": smem}


def time_bwd_plan(f: int, n: int, d: int, heads: int) -> dict:
    """The launch plan of the backward's time pass
    (csrc/divided_attention_bwd.cu::time_bwd_plan, time_bwd_kernel): ``p``
    spatial positions, ``heads_a_block`` HG and ``warps`` a block (all heads,
    BWD_TIME_WARPS warps and the largest p of 4, 2 whose 1 + f * p rows of
    qkv and cotangent, 4 x HG padded heads wide, fit BWD_TIME_SMEM_TARGET
    bytes with the scratch; else p = 1 and the largest HG dividing the heads,
    with min(BWD_TIME_WARPS, HG) warps, that fits the target, else that fits
    a block), ``blocks`` position tiles a segment (the CLS key's partial
    slots), ``head_groups``, and the block's shared memory. Raises where
    even one head's rows and one warp's f x (f + 1) scratch do not fit a
    block."""
    dhp = padded_width(head_dim("the backward's time pass", d, heads))

    def smem(p, hg, warps):
        return ((1 + f * p) * 4 * hg * dhp * 2 + p * hg * f * 2 * 4
                + warps * 2 * f * (f + 1) * 4)

    plan = next(((p, heads, BWD_TIME_WARPS) for p in (4, 2)
                 if smem(p, heads, BWD_TIME_WARPS) <= BWD_TIME_SMEM_TARGET), None)
    if plan is None:
        plan = next(((1, g, min(BWD_TIME_WARPS, g))
                     for limit in (BWD_TIME_SMEM_TARGET, MAX_SMEM) for g in _divisors_down(heads)
                     if smem(1, g, min(BWD_TIME_WARPS, g)) <= limit), None)
        require(plan is not None,
                f"the backward's time pass stages {f} frames' qkv and cotangent rows of one "
                f"head (width {dhp}) and a warp's {f} x {f + 1} scratch in a block: "
                f"{smem(1, 1, 1)} bytes of shared memory, more than {MAX_SMEM}")
    p, hg, warps = plan
    return {"p": p, "heads_a_block": hg, "warps": warps, "head_groups": heads // hg,
            "blocks": -(-n // p), "smem": smem(p, hg, warps)}


def cls_pool_smem(rows: int, d: int, heads: int) -> int:
    """Shared memory (bytes) of the CLS-pool pass (csrc/cls_pool.cu::
    pool_smem) holding ``rows`` rows of x: the rows and U's hi and lo parts
    at a pitch of d + 8 bf16, a zero row, the logits (16 heads of rows + 1
    f32), P^T (16 rows of the rows rounded up to 16, + 8, bf16), the softmax
    state of CLS_GMAX groups and the cluster's exchange slots."""
    p, t16 = d + 8, -(-rows // 16) * 16
    return (rows * p * 2 + 2 * heads * p * 2 + p * 2 + 16 * (rows + 1) * 4 + 16 * (t16 + 8) * 2
            + CLS_GMAX * 16 * 3 * 4 + 2 * CLS_MAXH * 4)


@functools.lru_cache(maxsize=256)
def cls_pool_plan(b: int, m: int, d: int, heads: int, shared_u: bool, sms: int = 132) -> dict:
    """The launch plan of the CLS-pool pass (csrc/cls_pool.cu::pool_kernel)
    over b groups of m rows of width d, with cap the most rows (a multiple of
    16) a block holds in shared memory: ``groups`` a block (with a shared U,
    K4's, short groups are packed: at most cap // m, CLS_GMAX, and as many as
    keep two blocks an SM busy); ``cluster`` 1, or 2 when a group has more
    than cap rows (its halves on a 2-block cluster; x read once while a half
    fits, else each block streams its half in passes of ``rows``); ``rows`` a
    block holds at once; ``blocks``. Raises where not even 16 rows fit."""
    cap = 0
    while cls_pool_smem(cap + 16, d, heads) <= MAX_SMEM:
        cap += 16
    require(cap >= 16, f"the CLS-pool pass holds no 16 rows of width {d} with {heads} heads "
            f"in {MAX_SMEM} bytes of shared memory")
    groups, cluster = 1, 1
    if m <= cap:
        if shared_u:
            groups = max(1, min(CLS_GMAX, cap // m, -(-b // (2 * sms))))
        rows = groups * m
    else:
        cluster, rows = 2, min(cap, -(-m // 2))
    return {"groups": groups, "cluster": cluster, "rows": rows,
            "blocks": -(-b // groups) * cluster}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(name: str, out: Path) -> None:
    tmp = out.with_suffix(f".tmp{os.getpid()}")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (BUILD_DIR / f"{name}.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr[-4000:]}")
    tmp.replace(out)


def build_all() -> float:
    """Compile every kernel library that is missing (in parallel); returns
    the seconds spent."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = _source_hash()
    todo = [n for n in _SIGNATURES if not (BUILD_DIR / f"{n}-{tag}.so").exists()]
    with ThreadPoolExecutor(max_workers=len(_SIGNATURES)) as pool:
        futures = [pool.submit(_compile, n, BUILD_DIR / f"{n}-{tag}.so") for n in todo]
        for fut in futures:
            fut.result()
    return time.perf_counter() - t0


def library(name: str, entry: str | None = None):
    """The C entry ``entry`` (default: the first) of the kernel library
    ``name``, loaded with its signature set."""
    entry = entry or next(iter(_SIGNATURES[name]))
    with _lock:
        if (name, entry) not in _libs:
            build_all()
            lib = ctypes.CDLL(str(BUILD_DIR / f"{name}-{_source_hash()}.so"))
            fn = getattr(lib, entry)
            fn.argtypes = _SIGNATURES[name][entry]
            fn.restype = ctypes.c_int
            _libs[(name, entry)] = fn
        return _libs[(name, entry)]


def stream_ptr() -> int:
    return torch.cuda.current_stream().cuda_stream


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")


def use_kernel(x: torch.Tensor, impl: str) -> bool:
    """True: launch the CUDA kernel. False: run the plain PyTorch version,
    which happens only for impl='plain' or a tensor on the CPU."""
    if impl not in ("kernel", "plain"):
        raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")
    if impl == "plain" or x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    return True


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def require_same_device(what: str, x: torch.Tensor, *tensors: torch.Tensor) -> None:
    """A kernel dereferences every pointer on x's device."""
    require(all(t.device == x.device for t in tensors), f"{what} takes every tensor on {x.device}")
