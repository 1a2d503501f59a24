"""Build and load the package's CUDA kernels.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together, and the objects are linked into one shared library with a plain C
interface, at first use, into ``.kernel_build/`` beside the package (the
directory is git-ignored). The library's file name carries a hash of the
sources, headers and flags, so an edited source builds anew and an unchanged
one is reused. It is loaded with ``ctypes``; nothing here includes PyTorch's
headers. A failed build raises with the compiler's output.

Processes that build at once (the ranks of one ``torchrun`` job reaching a
cold build directory together) take turns on a file lock in the directory:
one compiles, the others wait and load its library. The library is written
beside its final name and renamed into place, so no process ever loads a
partial file. ``OAK_TPU_TORCH_BUILD_DIR`` names another build directory.
"""

from __future__ import annotations

import ctypes
import dataclasses
import fcntl
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
BUILD_DIR = Path(os.environ.get("OAK_TPU_TORCH_BUILD_DIR")
                 or PACKAGE_DIR.parent / ".kernel_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
NVCC_TIMEOUT_S = 600

# ctypes signature of every exported entry point: (argtypes, restype).
# Pointers and the stream are c_void_p; without argtypes ctypes would pass
# each as a 32-bit int.
_INT_P = ctypes.POINTER(ctypes.c_int)
SIGNATURES = {
    # u1, u2, c1, c2, extra, logb, sig2, out; D, N, M, E, P, variant, lanes;
    # lane strides (7 long longs); stream
    "oak_gram_fwd_f32": ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                         + [ctypes.c_void_p] * 2, ctypes.c_int),
    # P, variant -> rows, columns of the block tile
    "oak_gram_fwd_tile": ([ctypes.c_int] * 2 + [_INT_P] * 2, ctypes.c_int),
    # u1, u2, c1, c2, extra, logb, sig2, gbar, work, du1, dc1, du2, dc2,
    # dlogb, dsig2, dextra; D, N, M, E, P, variant, lanes; lane strides (8
    # long longs); stream
    "oak_gram_bwd_f32": ([ctypes.c_void_p] * 16 + [ctypes.c_int] * 7
                         + [ctypes.c_void_p] * 2, ctypes.c_int),
    "oak_gram_bwd_tile": ([ctypes.c_int] * 2 + [_INT_P] * 2, ctypes.c_int),
    # D, N, M, P, variant, lanes -> floats of workspace
    "oak_gram_bwd_workspace": ([ctypes.c_int] * 6, ctypes.c_longlong),
    # L, B, X, work; M, N, lanes, lanes_L, transpose, nb; lane strides of L
    # and B; stream
    "oak_tri_solve_f32": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                          + [ctypes.c_longlong] * 2 + [ctypes.c_void_p], ctypes.c_int),
    # M, N, lanes -> the panel width (0: M too tall for one panel)
    "oak_tri_solve_panel": ([ctypes.c_int] * 3 + [_INT_P], ctypes.c_int),
    # M, lanes_L -> floats of workspace
    "oak_tri_solve_workspace": ([ctypes.c_int] * 2, ctypes.c_longlong),
    # P, Q, C; M, K, lanes; alpha; symmetric, split; lane strides of P and Q;
    # stream
    "oak_gemmt_f32": ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_float]
                      + [ctypes.c_int] * 2 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p],
                      ctypes.c_int),
    # M, K, lanes -> the split of K
    "oak_gemmt_plan": ([ctypes.c_int] * 3 + [_INT_P], ctypes.c_int),
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
    with open(BUILD_DIR / f"{out.stem}.lock", "w") as lock:
        # one process compiles; the others wait here and find its library
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return Build(out, 0.0, "")
        return _compile_to(out)


def _compile_to(out: Path) -> Build:
    stem = f"{out.stem}.{os.getpid()}"
    tmp = out.with_name(f"{stem}.tmp.so")
    nvcc = _nvcc()
    objects = [BUILD_DIR / f"{stem}.{src.stem}.o" for src in _sources()]
    t0 = time.perf_counter()
    # one compiler per source, all at once, then one link
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in ([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                         for src, obj in zip(_sources(), objects))]
    steps = []
    for cmd, proc in procs:
        text, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
        steps.append((cmd, text, proc.returncode))
    if all(rc == 0 for _, _, rc in steps):
        cmd = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *map(str, objects)]
        link = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=NVCC_TIMEOUT_S)
        steps.append((cmd, link.stdout + link.stderr, link.returncode))
    seconds = time.perf_counter() - t0
    for obj in objects:
        obj.unlink(missing_ok=True)
    log = "".join(text for _, text, _ in steps)
    for cmd, text, rc in steps:
        if rc != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed with exit code {rc}:\n"
                               f"{' '.join(cmd)}\n{text}")
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
