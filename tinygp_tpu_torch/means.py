"""GP mean functions.

Counterpart of ``tinygp_tpu/means.py``. A mean function maps a tensor of
coordinates to one mean value per point; a callable is applied to the
whole coordinate tensor, so it must broadcast. :class:`Conditioned` is
the mean of a process conditioned on data.
"""

from __future__ import annotations

__all__ = ["MeanBase", "Mean", "Conditioned"]

from collections.abc import Callable
from typing import Any

import torch
from torch import nn

from tinygp_tpu_torch.helpers import as_hyper
from tinygp_tpu_torch.kernels.base import Kernel


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


class Conditioned(MeanBase):
    """The mean of a process conditioned on data:
    ``mu(x) = k(x, X) @ alpha``, plus the prior mean if asked.

    Args:
        X: The ``(N,)`` training coordinates.
        alpha: ``K^-1 (y - mu)``, ``(N,)``.
        kernel: The cross-covariance kernel.
        include_mean: Add ``mean_function(x)``.
        mean_function: The prior mean.
    """

    def __init__(
        self,
        X: torch.Tensor,
        alpha: torch.Tensor,
        kernel: Kernel,
        *,
        include_mean: bool = True,
        mean_function: MeanBase | None = None,
    ):
        super().__init__()
        self.register_buffer("X", X)
        self.register_buffer("alpha", alpha)
        self.kernel = kernel
        self.include_mean = include_mean
        self.mean_function = mean_function

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        mu = self.kernel(X, self.X) @ self.alpha
        if self.include_mean and self.mean_function is not None:
            mu = mu + self.mean_function(X)
        return mu
