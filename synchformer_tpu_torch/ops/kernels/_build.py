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

# the tile GEMM's grid (csrc/tile_gemm.cuh, under K4 and K4b) puts 64-row
# tiles on gridDim.y (at most 65535)
MAX_GEMM_ROWS = 65535 * 64
# the Hopper GEMM (csrc/wgmma_gemm.cuh, under K1, K2 and K8a-K8c): TMA row
# coordinates are 32-bit; its persistent grid has no limit of its own. N
# comes in 64-column pieces (a last column tile may be 64 wide), K in
# multiples of 32 over WGMMA_BK-deep k-steps (TMA fills A's and W's columns
# past K with zeros)
WGMMA_MAX_ROWS = 2 ** 31 - 1
WGMMA_BM, WGMMA_BK = 128, 64
WGMMA_N_QUANTUM, WGMMA_K_QUANTUM = 64, 32
# the time pass of the divided attention (csrc/divided_attention.cuh)
TIME_WARPS = 8
TIME_SMEM_TARGET = 57344
MAX_SMEM = 232448  # shared memory one block may take on the H100
# the divided attention's backward (csrc/divided_attention_bwd.cu): the
# space pass's warps a block at most and 16-row tiles of a streamed chunk;
# the time pass's warps and shared-memory target
BWD_SPACE_WARPS = 8
BWD_SPACE_CHUNK_TILES = 13
BWD_TIME_WARPS = 8
BWD_TIME_SMEM_TARGET = 114688

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
    "ln_mlp": {"sft_ln_mlp": [_P] * 11 + [_L, _I, _I, _F, _I, _P],
               "sft_ln_matmul": [_P] * 7 + [_L, _I, _I, _F, _P]},
    "standard_attention": {"sft_standard_attention": [_P, _P, _I, _I, _I, _I, _P]},
    "cls_pool": {"sft_cls_pool_tokens": [_P] * 20 + [_I] * 5 + [_F, _P],
                 "sft_cls_pool": [_P] * 20 + [_I] * 5 + [_F, _P]},
    "divided_attention": {"sft_divided_attention_proj": [_P] * 8 + [_I] * 6 + [_P],
                          "sft_divided_attention": [_P] * 4 + [_I] * 6 + [_P],
                          "sft_divided_attention_packed": [_P] * 2 + [_I] * 6 + [_P]},
    "divided_attention_bwd": {"sft_divided_attention_bwd": [_P] * 11 + [_I] * 6 + [_P],
                              "sft_divided_attention_packed_bwd": [_P] * 8 + [_I] * 6 + [_P]},
    "gemm": {"sft_gemm": [_P] * 4 + [_L, _P, _L, _I, _I, _I, _P]},
    "fused_block": {"sft_fused_divided_attention": [_P] * 8 + [_I] * 6 + [_F, _P]},
}


def gemm_plan(m: int, n: int, k: int, epilogue: str = "bias", sms: int = 132) -> dict:
    """The launch plan of the Hopper GEMM (csrc/wgmma_gemm.cuh) for C[m, n]
    = A[m, k] @ W[n, k]^T: its schedule (``cooperative``, 128 x 256 tiles,
    for the GELU epilogues where n % 256 == 0; else ``ping-pong``, 128 x 128
    tiles, the last one 64 wide where n % 128 == 64), the tile grid, and the
    persistent grid (one block an SM, at most one a tile). Block b takes
    tiles b, b + grid, ...; tile t is row tile t // tiles_n, column tile t %
    tiles_n. Raises on a shape the kernel does not take."""
    require(0 < m <= WGMMA_MAX_ROWS, f"the Hopper GEMM takes 1 to {WGMMA_MAX_ROWS} rows, got {m}")
    require(n >= WGMMA_N_QUANTUM and n % WGMMA_N_QUANTUM == 0,
            f"the Hopper GEMM takes N % {WGMMA_N_QUANTUM} == 0, got {n}")
    require(k >= WGMMA_K_QUANTUM and k % WGMMA_K_QUANTUM == 0,
            f"the Hopper GEMM takes K % {WGMMA_K_QUANTUM} == 0, got {k}")
    cooperative = epilogue in ("gelu", "gelu_poly") and n % 256 == 0
    bn = 256 if cooperative else 128
    tiles_m, tiles_n = -(-m // WGMMA_BM), -(-n // bn)
    return {"schedule": "cooperative" if cooperative else "ping-pong", "bn": bn,
            "tiles_m": tiles_m, "tiles_n": tiles_n, "grid": min(tiles_m * tiles_n, sms)}


def gemm_block_tiles(plan: dict, block: int, consumer: int | None = None) -> list:
    """The (row tile, column tile) pairs block ``block`` of ``plan`` walks,
    in order; with ``consumer`` (0 or 1), those that consumer warpgroup
    works on (ping-pong: every other one; cooperative: all of them, its 64
    rows of each)."""
    tiles, tn = plan["tiles_m"] * plan["tiles_n"], plan["tiles_n"]
    mine = [(t // tn, t % tn) for t in range(block, tiles, plan["grid"])]
    return mine[consumer::2] if consumer is not None and plan["schedule"] == "ping-pong" else mine


def time_pass_plan(f: int, n: int, d: int) -> dict:
    """The launch plan of the divided attention's time pass
    (csrc/divided_attention.cuh::time_attention_kernel): ``p`` spatial
    positions a block (the largest of 4, 2, 1 whose f * p + 1 key / value rows
    fit TIME_SMEM_TARGET bytes, else 1), ``blocks`` position tiles a segment,
    and the block's shared memory. Raises where even one position's rows do
    not fit a block."""
    def smem(p):
        return (1 + f * p) * 2 * d * 2 + TIME_WARPS * 8 * (f + 1) * 4

    p = next((p for p in (4, 2) if smem(p) <= TIME_SMEM_TARGET), 1)
    require(smem(p) <= MAX_SMEM,
            f"the time pass stages {f} frames' keys and values of width {d} in one block: "
            f"{smem(p)} bytes of shared memory, more than {MAX_SMEM}")
    return {"p": p, "blocks": -(-n // p), "smem": smem(p)}


def space_bwd_plan(n: int, dh: int) -> dict:
    """The launch plan of the backward's space pass
    (csrc/divided_attention_bwd.cu::space_bwd_mma_kernel) for frames of n
    patches: ``warps`` a block (one 16-row tile each, at most
    BWD_SPACE_WARPS), the query / key tiles, the streamed chunks of
    BWD_SPACE_CHUNK_TILES tiles over the n + 1 keys and over the n queries,
    and the block's shared memory, which depends on dh and the warps but
    not otherwise on n."""
    tq, tk = -(-n // 16), -(-(n + 1) // 16)
    warps = min(tk, BWD_SPACE_WARPS)
    pitch = (dh + 8) * 2
    smem = ((2 * warps * 16 + 2 * BWD_SPACE_CHUNK_TILES * 16) * pitch
            + BWD_SPACE_CHUNK_TILES * 16 * 16 + (warps * 32 + warps * 2 * dh) * 4)
    require(smem <= MAX_SMEM, f"the backward's space pass at head_dim {dh} takes {smem} bytes "
            f"of shared memory, more than {MAX_SMEM}")
    return {"warps": warps, "query_tiles": tq, "key_tiles": tk,
            "key_chunks": -(-tk // BWD_SPACE_CHUNK_TILES),
            "query_chunks": -(-tq // BWD_SPACE_CHUNK_TILES), "smem": smem}


def time_bwd_plan(f: int, n: int, d: int, heads: int) -> dict:
    """The launch plan of the backward's time pass
    (csrc/divided_attention_bwd.cu::time_bwd_kernel): ``p`` spatial
    positions a block (the largest of 4, 2, 1 whose 1 + f * p rows of qkv
    and cotangent, 4d wide, fit BWD_TIME_SMEM_TARGET bytes with the scratch,
    else 1), ``blocks`` position tiles a segment (the CLS key's partial
    slots), and the block's shared memory. Raises where even one position's
    rows do not fit a block."""
    def smem(p):
        return ((1 + f * p) * 4 * d * 2 + p * heads * f * 2 * 4
                + BWD_TIME_WARPS * 2 * f * (f + 1) * 4)

    p = next((p for p in (4, 2) if smem(p) <= BWD_TIME_SMEM_TARGET), 1)
    require(smem(p) <= MAX_SMEM,
            f"the backward's time pass stages {f} frames' qkv and cotangent rows of width {d} "
            f"in one block: {smem(p)} bytes of shared memory, more than {MAX_SMEM}")
    return {"p": p, "blocks": -(-n // p), "smem": smem(p)}


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
