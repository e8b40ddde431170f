"""The native (C++) WAV reader of the loader, built at first use
(port of ``svt_speechbrain_tpu/native/__init__.py``).

``wav_loader.cpp`` parses RIFF/WAV headers and decodes PCM and float data,
sliced, into float32 in [-1, 1], or a mono-mixed int16 stream. ``get_lib()``
compiles it with ``g++`` on first use into ``build/native/`` at the root of
the checkout (never beside the source), under a name that carries a hash of
the source and flags, and returns a ctypes handle, or None when no compiler
is available; callers then read through scipy.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

SRC = Path(__file__).resolve().parent / "wav_loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")
_lock = threading.Lock()
_lib = None
_tried = False


def library_path():
    """``build/native/libsvtnative-<hash of the source and flags>.so``."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(SRC.read_bytes())
    return BUILD_DIR / f"libsvtnative-{digest.hexdigest()[:16]}.so"


def _compile(out):
    cxx = shutil.which("g++") or shutil.which("c++") or shutil.which(
        "clang++")
    if cxx is None:
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SRC)],
                       check=True, capture_output=True)
    except subprocess.CalledProcessError as e:
        logger.warning("native build failed: %s",
                       e.stderr.decode(errors="replace"))
        return False
    os.replace(tmp, out)           # atomic: concurrent builds never clash
    return True


def get_lib():
    """ctypes handle to the native library, or None."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = library_path()
        if not path.exists() and not _compile(path):
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            logger.warning("native load failed: %s", e)
            return None
        lib.wav_info.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
        lib.wav_info.restype = ctypes.c_int
        lib.wav_read.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                 ctypes.c_int64,
                                 ctypes.POINTER(ctypes.c_float)]
        lib.wav_read.restype = ctypes.c_int
        lib.wav_read_int16.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                       ctypes.c_int64,
                                       ctypes.POINTER(ctypes.c_int16)]
        lib.wav_read_int16.restype = ctypes.c_int
        _lib = lib
        return _lib


def wav_info(path):
    """(frames, sample_rate, channels, bits, is_float) or None."""
    lib = get_lib()
    if lib is None:
        return None
    frames = ctypes.c_int64()
    sr = ctypes.c_int32()
    ch = ctypes.c_int32()
    bits = ctypes.c_int32()
    isf = ctypes.c_int32()
    rc = lib.wav_info(os.fsencode(path), ctypes.byref(frames),
                      ctypes.byref(sr), ctypes.byref(ch), ctypes.byref(bits),
                      ctypes.byref(isf))
    if rc != 0:
        return None
    return frames.value, sr.value, ch.value, bits.value, bool(isf.value)


def wav_read(path, start=0, stop=None):
    """Sliced float32 read → (data (T, C), sample_rate), or None."""
    info = wav_info(path)
    if info is None:
        return None
    frames, sr, ch, _, _ = info
    stop = frames if stop is None else min(int(stop), frames)
    n = max(stop - int(start), 0)
    out = np.empty(n * ch, dtype=np.float32)
    got = get_lib().wav_read(
        os.fsencode(path), int(start), n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if got < 0:
        return None
    return out[: got * ch].reshape(-1, ch), sr


def wav_read_int16(path, start=0, stop=None):
    """Sliced mono-mixed int16 read of a 16-bit PCM file → (data (T,),
    sample_rate), or None."""
    info = wav_info(path)
    if info is None:
        return None
    frames, sr, ch, bits, isf = info
    if bits != 16 or isf:
        return None
    stop = frames if stop is None else min(int(stop), frames)
    n = max(stop - int(start), 0)
    out = np.empty(n, dtype=np.int16)
    got = get_lib().wav_read_int16(
        os.fsencode(path), int(start), n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)))
    if got < 0:
        return None
    return out[:got], sr
