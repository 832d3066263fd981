"""Input-coordinate transforms for building expressive kernels.

Counterpart of ``tinygp_tpu/transforms.py``: :class:`Transform`,
:class:`Linear`, :class:`Cholesky` and :class:`Subspace`. Each maps the
points its kernel sees (feature axis last, see
:mod:`~tinygp_tpu_torch.kernels.base`) before evaluating the wrapped
kernel on them.

Examples:
    >>> import torch
    >>> from tinygp_tpu_torch import kernels, transforms
    >>> k = transforms.Linear(
    ...     scale=1.0 / torch.tensor([2.0, 0.5]), kernel=kernels.ExpSquared()
    ... )
    >>> k(torch.zeros(5, 2), torch.zeros(5, 2)).shape
    torch.Size([5, 5])
"""

from __future__ import annotations

__all__ = ["Transform", "Linear", "Cholesky", "Subspace"]

from collections.abc import Callable, Sequence
from typing import Any

import torch

from tinygp_tpu_torch.helpers import as_hyper
from tinygp_tpu_torch.kernels.base import Kernel


class _Wrapped(Kernel):
    """A kernel evaluated on transformed points."""

    def __init__(self, kernel: Kernel):
        super().__init__()
        self.kernel = kernel

    def _map(self, X: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def evaluate(self, X1: torch.Tensor, X2: torch.Tensor) -> torch.Tensor:
        return self.kernel.evaluate(self._map(X1), self._map(X2))


class Transform(_Wrapped):
    """Apply an arbitrary callable to the points of a kernel.

    Args:
        transform: Maps points (feature axis last) to transformed points.
        kernel: The kernel evaluated in the transformed space.
    """

    def __init__(self, transform: Callable[[torch.Tensor], torch.Tensor], kernel: Kernel):
        super().__init__(kernel)
        self.transform = transform

    def _map(self, X: torch.Tensor) -> torch.Tensor:
        return self.transform(X)


class Linear(_Wrapped):
    """Multiply the inputs by a scalar, per-dimension, or matrix scale.

    Args:
        scale: A 0-, 1-, or 2-dimensional scale applied as ``scale * x`` (or
            ``scale @ x`` when 2-dimensional).
        kernel: The kernel evaluated in the transformed space.
    """

    def __init__(self, scale: Any, kernel: Kernel):
        super().__init__(kernel)
        self.register_buffer("scale", as_hyper(scale))

    def _map(self, X: torch.Tensor) -> torch.Tensor:
        ndim = self.scale.ndim
        if ndim < 2:
            return self.scale * X
        if ndim == 2:
            return X @ self.scale.T
        raise ValueError(
            f"Linear scale has {ndim} dimensions; at most 2 are meaningful"
        )


class Cholesky(_Wrapped):
    """Warp inputs by the inverse of a lower-triangular factor.

    Args:
        factor: A 0-, 1-, or 2-dimensional Cholesky factor; inputs are
            transformed as ``solve(factor, x)`` (or division for scalar /
            diagonal factors).
        kernel: The kernel evaluated in the transformed space.
    """

    def __init__(self, factor: Any, kernel: Kernel):
        super().__init__(kernel)
        self.register_buffer("factor", as_hyper(factor))

    def _map(self, X: torch.Tensor) -> torch.Tensor:
        ndim = self.factor.ndim
        if ndim < 2:
            return X / self.factor
        if ndim == 2:
            flat = X.reshape(-1, X.shape[-1]).T
            out = torch.linalg.solve_triangular(self.factor, flat, upper=False)
            return out.T.reshape(X.shape)
        raise ValueError(
            f"Cholesky factor has {ndim} dimensions; at most 2 are meaningful"
        )

    @classmethod
    def from_parameters(
        cls, diagonal: Any, off_diagonal: Any, kernel: Kernel
    ) -> Cholesky:
        """Build from an unconstrained (diagonal, strictly-lower) packing.

        Args:
            diagonal: ``(ndim,)`` positive diagonal entries.
            off_diagonal: ``(ndim*(ndim-1)/2,)`` strictly-lower entries, row
                by row.
            kernel: The kernel evaluated in the transformed space.
        """
        diagonal, off_diagonal = as_hyper(diagonal), as_hyper(off_diagonal)
        dim = diagonal.numel()
        expect = dim * (dim - 1) // 2
        if off_diagonal.numel() != expect:
            raise ValueError(
                f"a {dim}-dimensional Cholesky packing takes {expect} "
                f"strictly-lower entries; got {off_diagonal.numel()}"
            )
        rows, cols = torch.tril_indices(dim, dim, -1)
        factor = torch.diag_embed(diagonal.reshape(dim))
        factor = factor.index_put((rows, cols), off_diagonal.reshape(expect).to(factor.dtype))
        return cls(factor=factor, kernel=kernel)


class Subspace(_Wrapped):
    """Evaluate a kernel on a subset of the input dimensions.

    Args:
        axis: An integer, or a sequence or array of integers, selecting
            features; an integer keeps its feature axis (of length 1). (The
            JAX package takes an integer or a numpy array: a tuple or list
            fails there as an index.)
        kernel: The kernel evaluated on the selected dimensions.
    """

    def __init__(self, axis: Sequence[int] | int, kernel: Kernel):
        super().__init__(kernel)
        self.axis = axis

    def _map(self, X: torch.Tensor) -> torch.Tensor:
        return X[..., torch.as_tensor(self.axis).reshape(-1).tolist()]
