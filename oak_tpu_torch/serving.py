"""Serving export (``oak_tpu.serving``): a trained model's predict path as a
serialized artifact with a dynamic batch dimension.

    blob = serialize_predict(oak)            # trained oak_model -> bytes
    f = deserialize_predict(blob)            # another process
    y = f(X)                                 # X: [n, D], any n

The artifact holds ``oak_model.export_predict``'s graph (flows -> scalers ->
posterior -> inverse link or y scale) and its constants: the kernel's
parameters, the flows and the predict factors. D is fixed, the batch is not.

The graph is traced on the device it will serve on, because the trace
fixes the route: on the card a float32 model's gram is the registered op
``oak_tpu_torch::oak_gram_fwd`` (the CUDA kernel), on the CPU the plain
route.

A card artifact is compiled, as ``oak_tpu``'s is: an AOTInductor package
(``torch._inductor.aoti_compile_and_package``) of the traced program whose
gram nodes were swapped for ``oak_tpu_torch::oak_gram_triton``, so that the
package holds K1 as a Triton kernel in its cubins (``ops.oak_gram_triton``).
It is self-contained: ``torch._inductor.aoti_load_package(path)`` serves it
in a process that cannot import ``oak_tpu_torch`` and has no CUDA toolkit,
and one request runs as one compiled program. The blob is that package's
``.pt2`` archive with one record more, ``PROGRAM``: the ``torch.export``
program as traced, which ``deserialize_predict`` runs when the artifact is
asked onto the CPU.

A CPU artifact stays a ``torch.export`` program, the blob
``torch.export.save`` writes (as a card artifact of an earlier version
was): it holds the plain route and no custom op, so it loads with
``torch.export.load`` alone, and it is not compiled, which would cost every
save tens of seconds of C++ compile.
"""

from __future__ import annotations

import contextlib
import functools
import io
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Callable, Optional, Union

import torch

# The record of a card artifact's archive that holds the traced program.
PROGRAM = "oak_tpu_torch/program.pt2"
# Inductor's options for the package. It inlines 0-d constants (the
# graph's scalar parameters) and then fails to lower an unsqueeze of one;
# kept as tensors, they lower. Its default for a package tunes each
# kernel's launch configuration on random data, and a kernel that indexes
# with an intermediate (a categorical dim's table lookup) then reads out of
# bounds; tuned in a first pass over the traced sample rows instead, every
# index is real. Its float32 division is approximate unless asked to round
# as eager's does, which keeps the package's prescale (u = x / (l √2)) and
# scalers the live predict's.
INDUCTOR_CONFIGS = {"always_keep_tensor_constants": True,
                    "triton.autotune_at_compile_time": False,
                    "eager_numerics.division_rounding": True}


def _device(device) -> Optional[torch.device]:
    if device is None:
        return None
    if str(device) == "tpu":
        raise ValueError("device 'tpu' has no meaning for the PyTorch port: give a "
                         "torch device such as 'cuda' or 'cpu'")
    return torch.device(device)


def _artifact_device(ep) -> torch.device:
    return ep.state_dict["xmin"].device


def _on_thread(fn):
    """``fn()`` on a thread of its own. Export records the Python stack at
    every graph node it creates, so its time grows with the depth of the
    caller's stack (a server's handler, a script's phases); a new thread
    starts from an empty stack."""
    result = {}

    def run():
        try:
            result["value"] = fn()
        except BaseException as exc:  # re-raised in the caller's thread
            result["error"] = exc

    thread = threading.Thread(target=run, name="oak_tpu_torch-export")
    thread.start()
    thread.join()
    if "error" in result:
        raise result["error"]
    return result["value"]


def _export(module, sample, dynamic_shapes):
    def run():
        with torch.no_grad():
            return torch.export.export(module, (sample,), dynamic_shapes=dynamic_shapes)

    return _on_thread(run)


def _saved(ep) -> bytes:
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def with_triton_gram(ep):
    """``ep`` with every ``oak_tpu_torch::oak_gram_fwd`` node (the CUDA
    kernel, bound with ctypes) replaced by ``oak_tpu_torch::oak_gram_triton``
    (the Triton kernel, same inputs and output), which AOTInductor compiles
    into its package. Other ops stay as traced."""
    from .ops import oak_gram  # noqa: F401  (registers oak_tpu_torch::oak_gram_fwd)
    from .ops import oak_gram_triton

    return ep.run_decompositions(
        {torch.ops.oak_tpu_torch.oak_gram_fwd.default: oak_gram_triton.oak_gram_triton_op})


@contextlib.contextmanager
def _tf32_off():
    """Float32 matmuls in full precision while Inductor compiles: it reads
    the TF32 flags then, not when the package runs."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def _links_openmp(cxx: str) -> bool:
    """Whether ``cxx -fopenmp`` builds an empty program."""
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "main.cpp")
        with open(src, "w") as f:
            f.write("int main() { return 0; }\n")
        try:
            return subprocess.run([cxx, "-fopenmp", src, "-o", os.path.join(tmp, "main")],
                                  capture_output=True, timeout=120).returncode == 0
        except (OSError, subprocess.SubprocessError):
            return False


@functools.lru_cache(maxsize=None)
def _cxx() -> str:
    """The C++ compiler Inductor links the package with: the one it is
    configured with (``CXX``) or else the ``g++`` on ``PATH``, whichever
    first links an OpenMP program. Inductor links every package with
    ``-fopenmp``, and a ``CXX`` whose toolchain lacks libgomp (a wrapper
    around a compiler built without it) fails that link; none that links
    raises."""
    from torch._inductor import config

    configured = config.cpp.cxx if isinstance(config.cpp.cxx, (list, tuple)) \
        else (config.cpp.cxx,)
    candidates = [c for c in configured if c] + [shutil.which("g++")]
    for cxx in dict.fromkeys(c for c in candidates if c):
        if _links_openmp(cxx):
            return cxx
    raise RuntimeError(f"no C++ compiler links an OpenMP program (tried "
                       f"{', '.join(c for c in candidates if c)}): AOTInductor needs one")


def _compile(ep) -> bytes:
    """The AOTInductor package of ``ep``, as the bytes of its ``.pt2``
    archive; a failed compile raises."""
    from torch._inductor import aoti_compile_and_package, config

    def run():
        with _tf32_off(), config.patch({"cpp.cxx": (None, _cxx())}):
            buf = aoti_compile_and_package(
                ep, package_path=io.BytesIO(), inductor_configs=dict(INDUCTOR_CONFIGS))
        return buf.getvalue()

    return _on_thread(run)


def compile_package(ep) -> bytes:
    """A card artifact's blob for the traced program ``ep``: the
    AOTInductor package of ``with_triton_gram(ep)``, its archive's records
    copied with ``ep`` saved beside them as ``PROGRAM``."""
    from torch.export.pt2_archive import PT2ArchiveReader, PT2ArchiveWriter

    package = _compile(with_triton_gram(ep))
    out = io.BytesIO()
    with PT2ArchiveReader(io.BytesIO(package)) as reader, PT2ArchiveWriter(out) as writer:
        for name in reader.get_file_names():
            if not name.startswith(".data/"):  # written by every archive writer
                writer.write_bytes(name, reader.read_bytes(name))
        writer.write_bytes(PROGRAM, _saved(ep))
    return out.getvalue()


def _compiled_on(device: torch.device) -> bool:
    """Whether an artifact traced on ``device`` is compiled: on the card."""
    return device.type == "cuda"


def serialize_predict(oak, path: Optional[Union[str, os.PathLike]] = None,
                      device=None, include_var: bool = False) -> bytes:
    """The predict artifact of ``oak.export_predict(include_var, device)``
    as bytes (also written to ``path`` when given, once it is complete).

    The batch dimension is dynamic, so one artifact serves any batch size;
    D is fixed. The graph is traced by ``torch.export`` on ``device``
    (default the model's), from a copy of the model moved there, with a
    sample of two rows (export specialises sizes 0 and 1): on the card, a
    float32 model's gram goes through the registered op, wherever the model
    lives. A card artifact is then compiled (``compile_package``; a failed
    compile raises, and nothing is written), a CPU one is the program
    itself. ``include_var``: see ``oak_model.export_predict``."""
    predict = oak.export_predict(include_var=include_var, device=_device(device))
    sample = torch.stack([predict.xmin, predict.xmax])
    ep = _export(predict, sample, {"X": {0: torch.export.Dim("batch")}})
    blob = compile_package(ep) if _compiled_on(sample.device) else _saved(ep)
    if path is not None:
        with open(path, "wb") as f:
            f.write(blob)
    return blob


def _program(blob: bytes) -> Optional[bytes]:
    """The ``PROGRAM`` record of a card artifact's archive; None for a
    ``torch.export`` blob."""
    from torch.export.pt2_archive import PT2ArchiveReader

    with PT2ArchiveReader(io.BytesIO(blob)) as reader:
        return reader.read_bytes(PROGRAM) if PROGRAM in reader.get_file_names() else None


def deserialize_predict(blob_or_path: Union[bytes, str, os.PathLike],
                        device=None) -> Callable:
    """Load a serialized predict artifact; returns ``f(X)``, which takes
    numpy or a tensor [n, D], casts it to the artifact's dtype and device,
    and returns the artifact's tensors. ``device``: serve there (default:
    where it was traced).

    A card artifact on a card runs its AOTInductor package
    (``torch._inductor.aoti_load_package``, on that card's index); asked
    onto the CPU, it runs its traced program there, whose gram op runs its
    plain version. A ``torch.export`` blob runs its program with its
    constants moved to ``device``. The graph keeps the route it was traced
    with: a float32 artifact traced off the card has no K1 and raises when
    asked onto the card (serialize it with ``device="cuda"`` instead)."""
    from torch.export.passes import move_to_device_pass

    from .ops import oak_gram  # noqa: F401  (registers oak_tpu_torch::oak_gram_fwd)

    if isinstance(blob_or_path, (str, os.PathLike)):
        with open(blob_or_path, "rb") as f:
            blob = f.read()
    else:
        blob = bytes(blob_or_path)
    program = _program(blob)
    ep = torch.export.load(io.BytesIO(blob if program is None else program))
    target, traced = _device(device), _artifact_device(ep)
    dtype = ep.state_dict["xmin"].dtype  # the input range: the artifact's dtype
    if program is not None and (target or traced).type == "cuda":
        index = (target or traced).index
        on = torch.device("cuda", torch.cuda.current_device() if index is None else index)
        module = torch._inductor.aoti_load_package(io.BytesIO(blob), device_index=on.index)
    else:
        if target is not None and target != traced:
            if target.type == "cuda" and traced.type != "cuda" and dtype == torch.float32:
                raise ValueError(f"a float32 artifact traced on {traced} holds the plain "
                                 "route, not the fused gram: serialize the model with "
                                 f"device={str(target)!r} to serve it there")
            ep = move_to_device_pass(ep, target)
        module, on = ep.module(), _artifact_device(ep)

    def predict(X):
        return module(torch.as_tensor(X, dtype=dtype, device=on))

    return predict
