"""Carry the JAX package's params over to the port.

``to_torch`` takes a nested dict of arrays (numpy arrays, or anything
``numpy.asarray`` accepts, such as the reference's device arrays) and
returns the same tree of tensors on ``device``.  Keys and layouts are kept
as they are (``wq`` is (d, H*hd), stacked layers on axis 0), so the port
computes the same function as the reference on the same params.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _to_tensor(a: Any, device: Any) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes' bfloat16
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    return t.to(device)


def to_torch(tree: Any, device: Any = "cuda") -> Any:
    """Nested dict of arrays -> the same nested dict of tensors, dtypes
    kept (bfloat16 included)."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    return _to_tensor(tree, device)
