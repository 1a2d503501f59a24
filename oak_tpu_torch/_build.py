"""Build and load the package's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` into one shared library with a
plain C interface, at first use, into ``.kernel_build/`` beside the package
(the directory is git-ignored). The library's file name carries a hash of the
sources and flags, so an edited source builds anew and an unchanged one is
reused. It is loaded with ``ctypes``; nothing here includes PyTorch's headers,
so the build takes seconds. A failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import List, Optional

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / ".kernel_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
NVCC_TIMEOUT_S = 600

# ctypes signature of every exported entry point: (argtypes, restype).
# Pointers and the stream are c_void_p; without argtypes ctypes would pass
# each as a 32-bit int.
SIGNATURES = {
    # u1, u2, c1, c2, extra, logb, sig2, out; D, N, M, E, P; stream
    "oak_gram_fwd_f32": ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                         + [ctypes.c_void_p], ctypes.c_int),
    # u1, u2, c1, c2, extra, logb, sig2, gbar, du1p, dc1p, du2p, dc2p, dlogbp,
    # dsig2p, dextra; D, N, M, E, P; stream
    "oak_gram_bwd_f32": ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 5
                         + [ctypes.c_void_p], ctypes.c_int),
}


@dataclasses.dataclass(frozen=True)
class Build:
    path: Path
    seconds: float  # compile time; 0.0 when an identical build was on disk
    log: str  # nvcc's output, including ptxas's registers and spills


_lock = threading.Lock()
_build: Optional[Build] = None
_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found in $CUDA_HOME/bin, /usr/local/cuda/bin "
                           "or on PATH: the CUDA kernels cannot be built")
    return found


def _sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _compile() -> Build:
    out = BUILD_DIR / f"liboak_kernels_{_digest()}.so"
    if out.exists():
        return Build(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=NVCC_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n"
                           f"{' '.join(cmd)}\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent process sees all or nothing
    return Build(out, seconds, log)


def build() -> Build:
    """Compile the kernels if no identical build is on disk (once a process)."""
    global _build
    with _lock:
        if _build is None:
            _build = _compile()
        return _build


def library() -> ctypes.CDLL:
    """The loaded kernel library, with every entry point's signature set."""
    global _lib
    b = build()
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(b.path))
            for name, (argtypes, restype) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
        return _lib
