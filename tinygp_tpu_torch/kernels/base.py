"""Kernel base class.

Counterpart of ``tinygp_tpu/kernels/base.py``, reduced to what the
quasiseparable kernels need. The JAX ``Kernel`` evaluates one pair of
points and lifts that with ``vmap``; here :meth:`Kernel.evaluate` takes
tensors that broadcast against each other, and calling a kernel builds the
matrix (or its diagonal) by broadcasting a column against a row.

The dense kernels and their composition algebra (``Sum``, ``Product``,
``Constant`` of ``kernels/base.py``) belong to ROADMAP item N3 (dense
path); composing a non-quasiseparable kernel raises until then.
"""

from __future__ import annotations

__all__ = ["Kernel"]

from typing import Any

import torch
from torch import nn

_DENSE = "dense kernel algebra is ROADMAP item N3 (dense path), not ported yet"


class Kernel(nn.Module):
    """The base class of all kernels.

    Subclasses hold their hyperparameters as tensors and override
    :meth:`evaluate`, which takes coordinates that broadcast against each
    other and returns the kernel value at each broadcast position.
    """

    def evaluate(self, X1: torch.Tensor, X2: torch.Tensor) -> torch.Tensor:
        """The kernel at each broadcast pair of ``X1`` and ``X2``."""
        del X1, X2
        raise NotImplementedError

    def evaluate_diag(self, X: torch.Tensor) -> torch.Tensor:
        """The kernel variance at each point of ``X``."""
        return self.evaluate(X, X)

    def forward(
        self, X1: torch.Tensor, X2: torch.Tensor | None = None
    ) -> torch.Tensor:
        """``K(X1, X2)`` for 1-d coordinates, or its diagonal if ``X2`` is
        ``None``."""
        if X2 is None:
            return self.evaluate_diag(X1)
        return self.evaluate(X1[:, None], X2[None, :])

    # -- composition hooks; quasiseparable kernels override them ------------
    def __add__(self, other: Any) -> Kernel:
        raise NotImplementedError(_DENSE)

    def __radd__(self, other: Any) -> Kernel:
        raise NotImplementedError(_DENSE)

    def __mul__(self, other: Any) -> Kernel:
        raise NotImplementedError(_DENSE)

    def __rmul__(self, other: Any) -> Kernel:
        raise NotImplementedError(_DENSE)
