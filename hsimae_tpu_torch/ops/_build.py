"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface (``extern "C"``, raw
pointers, ints and the ``cudaStream_t``) and compiles with one nvcc call into
``_build/<name>-<hash>.so``, where the hash covers the source and the
flags. The first use builds it (a few seconds with no PyTorch headers
involved); later uses load the library already built. Any build or load
error raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# ctypes signatures of each library's C functions: name -> (restype, argtypes)
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "fused_block": {
        "hsimae_fused_block": (_I, [_I, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
        "hsimae_fused_block_max_seq": (_I, [_I]),
    },
}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return found


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(name: str) -> float:
    """Build ``csrc/<name>.cu`` unless it is built already; returns nvcc's
    wall seconds (0.0 when the library was there)."""
    lib = library_path(name)
    if lib.exists():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    (BUILD_DIR / f"{name}.log").write_text(proc.stdout)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, lib)  # atomic: a concurrent loader sees the whole file or none
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """nvcc's output (ptxas register and spill report) of the last build."""
    path = BUILD_DIR / f"{name}.log"
    return path.read_text() if path.exists() else ""


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and load it with its signatures set."""
    build(name)
    lib = ctypes.CDLL(str(library_path(name)))
    for fn, (restype, argtypes) in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.restype = restype
        f.argtypes = argtypes
    return lib
