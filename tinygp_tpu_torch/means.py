"""GP mean functions.

Counterpart of ``tinygp_tpu/means.py``. A mean function maps a tensor of
coordinates to one mean value per point; a callable is applied to the
whole coordinate tensor, so it must broadcast. The posterior mean
(``Conditioned``) comes with conditioning, ROADMAP item N2.
"""

from __future__ import annotations

__all__ = ["MeanBase", "Mean"]

from collections.abc import Callable
from typing import Any

import torch
from torch import nn

from tinygp_tpu_torch.helpers import as_hyper


class MeanBase(nn.Module):
    def forward(self, X: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


class Mean(MeanBase):
    """A constant or callable mean.

    Args:
        value: Either a scalar constant or a callable mapping the ``(N,)``
            coordinates to the ``(N,)`` means there.
    """

    def __init__(self, value: Any | Callable[[torch.Tensor], torch.Tensor]):
        super().__init__()
        self.func = value if callable(value) else None
        self.register_buffer("value", as_hyper(0.0 if callable(value) else value))

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        if self.func is not None:
            return self.func(X)
        return self.value.expand(X.shape[:1])
