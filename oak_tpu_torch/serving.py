"""Serving export (``oak_tpu.serving``): a trained model's predict path as a
``torch.export`` artifact with a dynamic batch dimension.

    blob = serialize_predict(oak)            # trained oak_model -> bytes
    f = deserialize_predict(blob)            # another process
    y = f(X)                                 # X: [n, D], any n

The artifact holds ``oak_model.export_predict``'s graph (flows -> scalers ->
posterior -> inverse link or y scale) and its constants: the kernel's
parameters, the flows and the predict factors. D is fixed, the batch is not.

The graph is traced on the device it will serve on, because the trace
fixes the route: on the card a float32 model's gram is the registered op
``oak_tpu_torch::oak_gram_fwd`` (the forward kernel), on the CPU the plain
route. One difference from ``oak_tpu``'s artifact, which is
self-contained StableHLO: the card's graph calls that op, so the loading
process must be able to import ``oak_tpu_torch`` (``deserialize_predict``
imports it).
"""

from __future__ import annotations

import io
import os
import threading
from typing import Callable, Optional, Union

import torch


def _device(device) -> Optional[torch.device]:
    if device is None:
        return None
    if str(device) == "tpu":
        raise ValueError("device 'tpu' has no meaning for the PyTorch port: give a "
                         "torch device such as 'cuda' or 'cpu'")
    return torch.device(device)


def _artifact_device(ep) -> torch.device:
    return ep.state_dict["xmin"].device


def _export(module, sample, dynamic_shapes):
    """``torch.export.export`` on a thread of its own. Export records the
    Python stack at every graph node it creates, so its time grows with
    the depth of the caller's stack (a server's handler, a script's
    phases); a new thread starts from an empty stack."""
    result = {}

    def run():
        try:
            with torch.no_grad():
                result["ep"] = torch.export.export(module, (sample,),
                                                   dynamic_shapes=dynamic_shapes)
        except BaseException as exc:  # re-raised in the caller's thread
            result["error"] = exc

    thread = threading.Thread(target=run, name="oak_tpu_torch-export")
    thread.start()
    thread.join()
    if "error" in result:
        raise result["error"]
    return result["ep"]


def serialize_predict(oak, path: Optional[Union[str, os.PathLike]] = None,
                      device=None, include_var: bool = False) -> bytes:
    """``torch.export`` of ``oak.export_predict(include_var, device)``,
    saved to bytes (and to ``path`` when given).

    The batch dimension is dynamic, so one artifact serves any batch size;
    D is fixed. The graph is traced on ``device`` (default the model's),
    from a copy of the model moved there, with a sample of two rows (export
    specialises sizes 0 and 1): on the card, a float32 model's gram goes
    through the registered op and so through K1, wherever the model lives.
    ``include_var``: see ``oak_model.export_predict``."""
    predict = oak.export_predict(include_var=include_var, device=_device(device))
    sample = torch.stack([predict.xmin, predict.xmax])
    ep = _export(predict, sample, {"X": {0: torch.export.Dim("batch")}})
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    blob = buf.getvalue()
    if path is not None:
        with open(path, "wb") as f:
            f.write(blob)
    return blob


def deserialize_predict(blob_or_path: Union[bytes, str, os.PathLike],
                        device=None) -> Callable:
    """Load a serialized predict artifact; returns ``f(X)``, which takes
    numpy or a tensor [n, D], casts it to the artifact's dtype and device,
    and returns the artifact's tensors. ``device``: move the artifact's
    constants there first (default: where it was saved). The graph keeps
    the route it was traced with: a card artifact moved to the CPU runs the
    op's plain version, but a float32 artifact traced off the card has no
    K1 and raises when asked onto the card (serialize it with
    ``device="cuda"`` instead)."""
    from torch.export.passes import move_to_device_pass

    from .ops import oak_gram  # noqa: F401  (registers oak_tpu_torch::oak_gram_fwd)

    if isinstance(blob_or_path, (str, os.PathLike)):
        with open(blob_or_path, "rb") as f:
            blob = f.read()
    else:
        blob = bytes(blob_or_path)
    ep = torch.export.load(io.BytesIO(blob))
    target, traced = _device(device), _artifact_device(ep)
    if target is not None and target != traced:
        if (target.type == "cuda" and traced.type != "cuda"
                and ep.state_dict["xmin"].dtype == torch.float32):
            raise ValueError(f"a float32 artifact traced on {traced} holds the plain "
                             "route, not the fused gram: serialize the model with "
                             f"device={str(target)!r} to serve it there")
        ep = move_to_device_pass(ep, target)
    ref = ep.state_dict["xmin"]  # the input range: the artifact's dtype and device
    module = ep.module()

    def predict(X):
        return module(torch.as_tensor(X, dtype=ref.dtype, device=ref.device))

    return predict
