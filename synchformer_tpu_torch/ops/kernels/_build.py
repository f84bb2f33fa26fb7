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

# the tile GEMM's grid puts 64-row tiles on gridDim.y (at most 65535)
MAX_GEMM_ROWS = 65535 * 64

# launches of each kernel wrapper on a CUDA tensor, keyed K1..K4, K4b, K5,
# K6, K7a, K7b, K7c, K8a, K8b, K8c
launches: collections.Counter = collections.Counter()

_libs: dict = {}
_lock = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# csrc/<name>.cu -> {its C entry: argtypes}; the first entry is the default
_SIGNATURES = {
    "ln_mlp": {"sft_ln_mlp": [_P] * 11 + [_L, _I, _I, _F, _P],
               "sft_ln_matmul": [_P] * 7 + [_L, _I, _I, _F, _P]},
    "standard_attention": {"sft_standard_attention": [_P, _P, _I, _I, _I, _I, _P]},
    "cls_pool": {"sft_cls_pool_tokens": [_P] * 20 + [_I] * 5 + [_F, _P],
                 "sft_cls_pool": [_P] * 20 + [_I] * 5 + [_F, _P]},
    "divided_attention": {"sft_divided_attention_proj": [_P] * 8 + [_I] * 6 + [_P],
                          "sft_divided_attention": [_P] * 4 + [_I] * 6 + [_P],
                          "sft_divided_attention_packed": [_P] * 2 + [_I] * 6 + [_P]},
    "divided_attention_bwd": {"sft_divided_attention_bwd": [_P] * 10 + [_I] * 6 + [_P],
                              "sft_divided_attention_packed_bwd": [_P] * 7 + [_I] * 6 + [_P]},
    "fused_block": {"sft_fused_divided_attention": [_P] * 8 + [_I] * 6 + [_F, _P],
                    "sft_fused_mlp": [_P] * 8 + [_L, _I, _I, _F, _P]},
}


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
