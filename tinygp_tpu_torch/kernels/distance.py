"""Distance metrics for the stationary kernels.

Counterpart of ``tinygp_tpu/kernels/distance.py``. A metric takes two
tensors of points that broadcast against each other, with the feature axis
last (length 1 for ``(N,)`` coordinates), and returns one distance per
broadcast pair, without the feature axis.

The L2 metric keeps gradients finite at coincident points: at r = 0 it
switches, with a ``where`` on both the value and the operand of the
square root, to the L1 distance, which has the same value there and a
finite derivative.
"""

from __future__ import annotations

__all__ = ["Distance", "L1Distance", "L2Distance", "UnitDistance"]

import torch
from torch import nn


class Distance(nn.Module):
    """Abstract base class for distance metrics."""

    def distance(self, X1: torch.Tensor, X2: torch.Tensor) -> torch.Tensor:
        """The distance between each broadcast pair of points."""
        raise NotImplementedError

    def squared_distance(self, X1: torch.Tensor, X2: torch.Tensor) -> torch.Tensor:
        """The squared distance; override when cheaper than squaring."""
        return torch.square(self.distance(X1, X2))


class L1Distance(Distance):
    """Manhattan distance."""

    def distance(self, X1: torch.Tensor, X2: torch.Tensor) -> torch.Tensor:
        return torch.sum(torch.abs(X1 - X2), dim=-1)


class L2Distance(Distance):
    """Euclidean distance with a gradient-safe r = 0 branch."""

    def distance(self, X1: torch.Tensor, X2: torch.Tensor) -> torch.Tensor:
        r2 = self.squared_distance(X1, X2)
        at_zero = r2 == 0
        safe_r2 = torch.where(at_zero, torch.ones_like(r2), r2)
        l1 = L1Distance().distance(X1, X2)
        return torch.where(at_zero, l1, torch.sqrt(safe_r2))

    def squared_distance(self, X1: torch.Tensor, X2: torch.Tensor) -> torch.Tensor:
        return torch.sum(torch.square(X1 - X2), dim=-1)


class UnitDistance(Distance):
    """A degenerate metric that always returns 1; useful for testing."""

    def distance(self, X1: torch.Tensor, X2: torch.Tensor) -> torch.Tensor:
        shape = torch.broadcast_shapes(X1.shape, X2.shape)[:-1]
        return torch.ones(shape, dtype=X1.dtype, device=X1.device)
