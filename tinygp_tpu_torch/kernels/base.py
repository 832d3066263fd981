"""Kernel base class.

Counterpart of ``tinygp_tpu/kernels/base.py``, reduced to what the
quasiseparable kernels need. The JAX ``Kernel`` evaluates one pair of
points and lifts that with ``vmap``; here :meth:`Kernel.evaluate` takes
tensors that broadcast against each other, and calling a kernel builds the
matrix (or its diagonal) by broadcasting a column against a row.

The dense kernels and their composition algebra (``Sum``, ``Product``,
``Constant`` of ``kernels/base.py``) belong to ROADMAP item N3 (dense
path); composing a non-quasiseparable kernel raises until then.
:class:`Conditioned`, the kernel of a posterior process, is here.
"""

from __future__ import annotations

__all__ = ["Kernel", "Conditioned"]

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


class Conditioned(Kernel):
    """The kernel of a process conditioned on data:
    ``k(a, b) - k(X, a)^T K^-1 k(X, b)``, through the training solver's
    triangular solves.

    Args:
        X: The ``(N,)`` training coordinates.
        solver: The training process's solver (its factor ``L``).
        kernel: The prior kernel.
    """

    def __init__(self, X: torch.Tensor, solver: nn.Module, kernel: Kernel):
        super().__init__()
        self.X = X
        self.solver = solver
        self.kernel = kernel

    def _whitened(self, Xs: torch.Tensor) -> torch.Tensor:
        """``L^-1 k(X, Xs)`` for flat ``Xs``: ``(N, len(Xs))``."""
        return self.solver.solve_triangular(self.kernel(self.X, Xs))

    def evaluate(self, X1: torch.Tensor, X2: torch.Tensor) -> torch.Tensor:
        X1, X2 = torch.broadcast_tensors(X1, X2)
        A1 = self._whitened(X1.reshape(-1))
        A2 = self._whitened(X2.reshape(-1))
        cross = torch.sum(A1 * A2, dim=0).reshape(X1.shape)
        return self.kernel.evaluate(X1, X2) - cross

    def evaluate_diag(self, X: torch.Tensor) -> torch.Tensor:
        A = self._whitened(X.reshape(-1))
        return self.kernel.evaluate_diag(X) - torch.sum(A * A, dim=0).reshape(X.shape)

    def forward(
        self, X1: torch.Tensor, X2: torch.Tensor | None = None
    ) -> torch.Tensor:
        """The matrix through one solve per coordinate set (the default
        would solve once per pair)."""
        if X2 is None:
            return self.evaluate_diag(X1)
        return self.kernel(X1, X2) - self._whitened(X1).T @ self._whitened(X2)
