"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each of the five ``csrc/<name>.cu`` (``SOURCES``) compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/kernels/<name>-<hash>.so csrc/<name>.cu

The library name carries a hash of the sources and flags, so an edited
source is rebuilt and a stale library is never loaded. Builds happen at
first use, from the sources in the checkout only; ``build_all`` starts one
``nvcc`` per source at once and waits for all of them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("conv_frontend", "flash_attention", "flash_attention_bwd",
           "quant_matmul", "transducer_lattice")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc():
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "with the CUDA toolkit's nvcc at first use")


def library_path(name):
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_all(names=SOURCES):
    """Build every missing library in ``names``, one ``nvcc`` per source, all
    started together. Returns {name: (seconds, ptxas report)} for the
    libraries built now; raises with the compiler's output on a failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        log = tempfile.TemporaryFile("w+", dir=BUILD_DIR)
        procs[name] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT), log, tmp,
                       out)
    report = {}
    failed = []
    while procs:                   # in order of completion: each source's
        time.sleep(0.05)           # seconds are its own compiler's
        for name, (proc, log, tmp, out) in list(procs.items()):
            if proc.poll() is None:
                continue
            seconds = time.perf_counter() - t0
            del procs[name]
            log.seek(0)
            text = log.read()
            log.close()
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {name}.cu:\n{text}")
                continue
            os.replace(tmp, out)
            report[name] = (seconds, text)
    if failed:
        raise RuntimeError("\n".join(failed))
    return report


def load(name, signatures):
    """The ctypes library for ``csrc/<name>.cu``, built if needed.
    ``signatures`` maps each C function to its argtypes; every function
    returns a cudaError_t as int."""
    lib = _loaded.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def check(err, what):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def stream_handle():
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
