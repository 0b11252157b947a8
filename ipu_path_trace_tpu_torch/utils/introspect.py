"""Debug-level tensor introspection (the reference's logTensorInfo).

Counterpart of ``ipu_path_trace_tpu/utils/introspect.py``: each tensor of
a scene or an environment light (a ``NifModel``'s or ``QuantNifModel``'s
buffers, a texture) is logged with its shape, dtype, device and bytes.
The port runs on one device, so there is no sharding to report.
"""

from __future__ import annotations

import logging

import torch
from torch import nn

from .logging import logger


def _tensors(name: str, obj):
    """(path, tensor) of every tensor reachable from obj: modules by their
    buffers, named tuples by field, sequences by index."""
    if isinstance(obj, torch.Tensor):
        yield name, obj
    elif isinstance(obj, nn.Module):
        for key, buf in obj.named_buffers():
            yield f"{name}.{key}", buf
    elif isinstance(obj, tuple) and hasattr(obj, "_fields"):
        for key in obj._fields:
            yield from _tensors(f"{name}.{key}", getattr(obj, key))
    elif isinstance(obj, (list, tuple)):
        for i, item in enumerate(obj):
            yield from _tensors(f"{name}[{i}]", item)


def log_tensor_info(name: str, obj) -> None:
    """Debug-log shape, dtype, device and bytes of every tensor in obj."""
    log = logger()
    if not log.isEnabledFor(logging.DEBUG):
        return
    for path, t in _tensors(name, obj):
        log.debug("Tensor info: %s: shape=%s dtype=%s device=%s bytes=%d", path,
                  tuple(t.shape), t.dtype, t.device, t.numel() * t.element_size())
