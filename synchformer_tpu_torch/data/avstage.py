"""ctypes bindings for the native avstage batch-staging runtime (the port's
copy of synchformer_tpu/data/avstage.py).

The library is compiled at first use from ``native/avstage/avstage.cpp``
(g++, the flags of its Makefile) into ``build/avstage/`` beside the
package; nothing is written into ``native/``. A library is bound only if it
exports every entry point used here (``avstage_patchify_u8`` is the newest:
a stale build without it is rebuilt, or refused). Where no library can be
built or loaded the functions run their numpy versions, as the JAX module
does. The pipeline calls ``gather_video_segments`` / ``gather_audio_segments``
on the hot path; the native versions run the copy loops multi-threaded
outside the GIL.
"""
from __future__ import annotations

import _ctypes
import ctypes
import logging
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
_SRC = _ROOT / "native" / "avstage" / "avstage.cpp"
_LIB_PATH = _ROOT / "build" / "avstage" / "libavstage.so"
_SYMBOLS = ("avstage_gather_video_u8", "avstage_patchify_u8", "avstage_gather_audio_f32",
            "avstage_pcm16_to_f32", "avstage_pcm16_downmix_f32", "avstage_hw_threads")
_LIB: Optional[ctypes.CDLL] = None


def build_library() -> bool:
    """Compile libavstage.so into build/avstage/ (g++, -O3 -std=c++17); the
    result is moved into place whole, so that processes building it at
    once never load a half-written file."""
    _LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_LIB_PATH.parent)
    os.close(fd)
    try:
        subprocess.check_call(
            ["g++", "-O3", "-std=c++17", "-fPIC", "-shared", "-pthread",
             "-o", tmp, str(_SRC)], stdout=subprocess.DEVNULL)
        os.replace(tmp, _LIB_PATH)
        return True
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        logging.warning(f"avstage build failed: {e}")
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _open(path: Path) -> Optional[ctypes.CDLL]:
    """The library at ``path`` if it loads and exports every entry point."""
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        logging.warning(f"avstage load failed: {e}")
        return None
    missing = [s for s in _SYMBOLS if not hasattr(lib, s)]
    if missing:
        logging.warning(f"avstage library {path} lacks {missing}")
        # unload it, so that a rebuild at the same path is loaded afresh
        _ctypes.dlclose(lib._handle)
        return None
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _LIB
    if _LIB is not None:
        return _LIB
    may_build = os.environ.get("SYNCHFORMER_BUILD_AVSTAGE", "1") == "1"
    lib = _open(_LIB_PATH) if _LIB_PATH.exists() else None
    if lib is None and may_build and _SRC.exists() and build_library():
        lib = _open(_LIB_PATH)
    if lib is None:
        return None
    i64, u8p, f32p, i16p, i64p = (ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8),
                                  ctypes.POINTER(ctypes.c_float),
                                  ctypes.POINTER(ctypes.c_int16),
                                  ctypes.POINTER(ctypes.c_int64))
    lib.avstage_gather_video_u8.argtypes = [u8p] + [i64] * 4 + [i64p] + [i64] * 6 \
        + [u8p, ctypes.c_int]
    lib.avstage_gather_video_u8.restype = None
    lib.avstage_patchify_u8.argtypes = [u8p] + [i64] * 7 + [u8p, ctypes.c_int]
    lib.avstage_patchify_u8.restype = None
    lib.avstage_gather_audio_f32.argtypes = [f32p, i64p, i64, i64, f32p]
    lib.avstage_gather_audio_f32.restype = None
    lib.avstage_pcm16_to_f32.argtypes = [i16p, f32p, i64]
    lib.avstage_pcm16_to_f32.restype = None
    lib.avstage_pcm16_downmix_f32.argtypes = [i16p, f32p, i64, i64]
    lib.avstage_pcm16_downmix_f32.restype = None
    lib.avstage_hw_threads.argtypes = []
    lib.avstage_hw_threads.restype = ctypes.c_int
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


def gather_video_segments(video: np.ndarray, starts: np.ndarray, seg_len: int,
                          crop_ij: Tuple[int, int], crop_hw: Tuple[int, int],
                          num_threads: int = 0,
                          out: Optional[np.ndarray] = None) -> np.ndarray:
    """(T,H,W,C) u8 + segment starts -> (S, seg_len, ch, cw, C) u8 with crop."""
    t, h, w, c = video.shape
    s = len(starts)
    ci, cj = crop_ij
    ch, cw = crop_hw
    if out is None:
        out = np.empty((s, seg_len, ch, cw, c), dtype=np.uint8)
    lib = _load()
    if lib is None:
        idx = np.asarray(starts)[:, None] + np.arange(seg_len)[None]
        out[...] = video[idx][:, :, ci:ci + ch, cj:cj + cw]
        return out
    video = np.ascontiguousarray(video)
    starts64 = np.ascontiguousarray(np.asarray(starts, dtype=np.int64))
    lib.avstage_gather_video_u8(
        video.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), t, h, w, c,
        starts64.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), s, seg_len,
        ci, cj, ch, cw, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        num_threads)
    return out


def gather_audio_segments(audio: np.ndarray, starts: np.ndarray, seg_len: int,
                          out: Optional[np.ndarray] = None) -> np.ndarray:
    s = len(starts)
    if out is None:
        out = np.empty((s, seg_len), dtype=np.float32)
    lib = _load()
    if lib is None:
        idx = np.asarray(starts)[:, None] + np.arange(seg_len)[None]
        out[...] = audio[idx]
        return out
    audio = np.ascontiguousarray(audio, dtype=np.float32)
    starts64 = np.ascontiguousarray(np.asarray(starts, dtype=np.int64))
    lib.avstage_gather_audio_f32(
        audio.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        starts64.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), s, seg_len,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out


def patchify_u8(frames: np.ndarray, z_block: int = 2, patch: int = 16,
                num_threads: int = 0,
                out: Optional[np.ndarray] = None) -> np.ndarray:
    """(..., T, H, W, C) u8 -> (..., T//z, (H//p)*(W//p), z*p*p*C) patch-major.

    Host-side im2col for the dense patch embed (multi-threaded memcpy rows in
    C++; numpy transpose fallback). Identical output to
    ops/video.py::patchify_frames."""
    *lead, t, h, w, c = frames.shape
    f, gh, gw = t // z_block, h // patch, w // patch
    n = int(np.prod(lead)) if lead else 1
    shape = (*lead, f, gh * gw, z_block * patch * patch * c)
    lib = _load()
    if lib is None:
        from synchformer_tpu_torch.ops.video import patchify_frames

        res = patchify_frames(frames, z_block=z_block, patch=patch)
        if out is None:
            return np.ascontiguousarray(res)
        out[...] = res
        return out
    if out is None:
        out = np.empty(shape, dtype=np.uint8)
    frames = np.ascontiguousarray(frames)
    lib.avstage_patchify_u8(
        frames.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n, t, h, w, c, z_block, patch,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), num_threads)
    return out


def pcm16_to_f32(pcm: np.ndarray, channels: int = 1) -> np.ndarray:
    """Interleaved int16 PCM -> mono float32 (native downmix when available)."""
    lib = _load()
    if lib is None:
        x = pcm.astype(np.float32) / 32768.0
        return x.reshape(-1, channels).mean(axis=1) if channels > 1 else x
    pcm = np.ascontiguousarray(pcm, dtype=np.int16)
    frames = pcm.size // channels
    out = np.empty(frames, dtype=np.float32)
    if channels == 1:
        lib.avstage_pcm16_to_f32(
            pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), frames)
    else:
        lib.avstage_pcm16_downmix_f32(
            pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), frames, channels)
    return out
