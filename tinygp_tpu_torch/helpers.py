"""Shared helpers: device resolution and tensor coercion.

Counterpart of ``tinygp_tpu/helpers.py``. The JAX package needs a
precision-pinned matmul (``pdot``) because the TPU demotes f32 products to
bf16; PyTorch's CUDA matmuls run in full f32 by default and the port's
structural contractions are elementwise multiply-adds anyway, so nothing
here replaces it.
"""

from __future__ import annotations

__all__ = ["resolve_device", "as_tensor", "as_hyper"]

from typing import Any

import numpy as np
import torch


def resolve_device(device: Any = None) -> torch.device:
    """The device an entry point runs on: the card unless asked otherwise.

    ``None`` means ``"cuda"``. A CUDA device without a usable CUDA runtime
    raises ``RuntimeError`` rather than quietly running on the CPU; callers
    that want the CPU pass ``device="cpu"``.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this host; pass device='cpu' to run "
            "the plain PyTorch path on the CPU"
        )
    return device


def as_tensor(
    value: Any, device: torch.device, dtype: torch.dtype
) -> torch.Tensor:
    """A number, numpy array or tensor as a tensor on ``device`` in
    ``dtype`` (a tensor already there is returned as it is, so autograd
    history survives)."""
    return as_hyper(value).to(device=device, dtype=dtype)


def as_hyper(value: Any) -> torch.Tensor:
    """A hyperparameter as a tensor. Python numbers become float64 so that
    no precision is lost before the process casts to its own dtype."""
    if isinstance(value, torch.Tensor):
        return value
    if isinstance(value, np.ndarray | np.generic):
        return torch.tensor(value)
    return torch.tensor(value, dtype=torch.float64)
