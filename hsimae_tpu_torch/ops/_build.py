"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface (``extern "C"``, raw
pointers, ints and the ``cudaStream_t``) and compiles with one nvcc call into
``_build/<name>-<hash>.so``, where the hash covers the source, the
``csrc/`` headers it ``#include``s by name (found through ``-I csrc``) and the flags
(extra ones, such as a profiling ``-D`` switch, are an argument). The
first use builds it (a few seconds with no PyTorch headers involved); later
uses load the library already built. :func:`build_all` starts one nvcc per
source at once. Any build or load error raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
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
    "fused_block_tf32x3": {
        "hsimae_fused_block_tf32x3": (_I, [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
        "hsimae_fused_block_tf32x3_max_seq": (_I, [_I]),
        "hsimae_fused_block_tf32x3_max_hidden": (_I, [_I]),
        "hsimae_fused_block_tf32x3_smem_bytes": (_I, [_I]),
        "hsimae_fused_block_tf32x3_image_bytes": (ctypes.c_longlong, [_I, _I]),
    },
    "fused_block_tf32x3_d256": {
        "hsimae_fused_block_tf32x3_d256": (_I, [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
        "hsimae_fused_block_tf32x3_d256_max_seq": (_I, [_I]),
        "hsimae_fused_block_tf32x3_d256_max_hidden": (_I, [_I]),
        "hsimae_fused_block_tf32x3_d256_smem_bytes": (_I, [_I]),
        "hsimae_fused_block_tf32x3_d256_image_bytes": (ctypes.c_longlong, [_I, _I]),
    },
    "fused_block_wgmma": {
        "hsimae_fused_block_wgmma": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
        "hsimae_fused_block_wgmma_max_seq": (_I, [_I]),
        "hsimae_fused_block_wgmma_max_hidden": (_I, [_I]),
        "hsimae_fused_block_wgmma_smem_bytes": (_I, [_I]),
        "hsimae_fused_block_wgmma_image_bytes": (ctypes.c_longlong, [_I, _I]),
    },
    "fused_block_wgmma_d256": {
        "hsimae_fused_block_wgmma_d256": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
        "hsimae_fused_block_wgmma_d256_max_seq": (_I, [_I]),
        "hsimae_fused_block_wgmma_d256_max_hidden": (_I, [_I]),
        "hsimae_fused_block_wgmma_d256_smem_bytes": (_I, [_I]),
        "hsimae_fused_block_wgmma_d256_image_bytes": (ctypes.c_longlong, [_I, _I]),
    },
}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return found


def library_path(name: str, extra_flags: tuple = ()) -> Path:
    src = CSRC / f"{name}.cu"
    flags = " ".join((*NVCC_FLAGS, *extra_flags))
    included = re.findall(rb'^#include "([^"]+)"', src.read_bytes(), re.M)
    headers = b"".join((CSRC / h.decode()).read_bytes() for h in sorted(included))
    digest = hashlib.sha256(src.read_bytes() + headers + flags.encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def _start(name: str, extra_flags: tuple = ()):
    """Start nvcc on ``csrc/<name>.cu`` unless it is built already: returns
    (process, library, start time) or None."""
    lib = library_path(name, extra_flags)
    if lib.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, *extra_flags, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, lib, time.perf_counter()


def _finish(name: str, started) -> float:
    if started is None:
        return 0.0
    proc, lib, t0 = started
    log = proc.communicate()[0]
    lib.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
    # atomic: a concurrent loader sees the whole file or none
    os.replace(lib.with_suffix(f".{os.getpid()}.tmp"), lib)
    return time.perf_counter() - t0


def build_all(names: tuple = tuple(SIGNATURES), extra_flags: tuple = ()) -> dict:
    """Build the libraries ``names`` (every one of ``SIGNATURES`` by default)
    with nvcc's ``extra_flags``, one nvcc per source, all started together;
    returns each one's wall seconds (0.0: already built)."""
    started = {name: _start(name, extra_flags) for name in names}
    return {name: _finish(name, s) for name, s in started.items()}


def build_log(name: str) -> str:
    """nvcc's output (ptxas register and spill report) of the library's build."""
    path = library_path(name).with_suffix(".log")
    return path.read_text() if path.exists() else ""


@functools.cache
def load_library(name: str, extra_flags: tuple = ()) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` (with nvcc's ``extra_flags``) if needed and
    load it with its signatures set."""
    _finish(name, _start(name, extra_flags))
    lib = ctypes.CDLL(str(library_path(name, extra_flags)))
    for fn, (restype, argtypes) in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.restype = restype
        f.argtypes = argtypes
    return lib
