"""The solver interface.

Counterpart of ``tinygp_tpu/solvers/solver.py``. A solver owns the
factorized covariance ``K = L @ L.T`` and exposes the primitives the GP
needs.
"""

from __future__ import annotations

__all__ = ["Solver"]

import torch
from torch import nn


class Solver(nn.Module):
    def variance(self) -> torch.Tensor:
        """The diagonal of the covariance matrix."""
        raise NotImplementedError

    def covariance(self) -> torch.Tensor:
        """The full covariance matrix (may be dense; use sparingly)."""
        raise NotImplementedError

    def normalization(self) -> torch.Tensor:
        """``log|L| + (N/2) log(2 pi)`` for the factor ``L``."""
        raise NotImplementedError

    def solve_triangular(
        self, y: torch.Tensor, *, transpose: bool = False
    ) -> torch.Tensor:
        """Solve ``L @ x = y`` (or ``L.T @ x = y`` when ``transpose``)."""
        raise NotImplementedError

    def log_likelihood(self, r: torch.Tensor) -> torch.Tensor:
        """The Gaussian log density of a centered residual ``r``:
        ``-0.5 r^T K^{-1} r - log|L| - (N/2) log(2 pi)``. The default
        whitens through :meth:`solve_triangular`; solvers with a fused
        factor-and-whiten path override it."""
        alpha = self.solve_triangular(r)
        return -0.5 * torch.sum(torch.square(alpha)) - self.normalization()

    def dot_triangular(self, y: torch.Tensor) -> torch.Tensor:
        """Compute ``L @ y``."""
        raise NotImplementedError

    def condition(self, kernel, X_test, noise):
        """The covariance of the process conditioned on the data."""
        raise NotImplementedError
