"""Kernel base class and composition algebra.

Counterpart of ``tinygp_tpu/kernels/base.py``. The JAX ``Kernel`` evaluates
one pair of points and lifts that with ``vmap``; here :meth:`Kernel.evaluate`
takes tensors of points that broadcast against each other, and calling a
kernel builds the matrix (:meth:`Kernel.gram`) by broadcasting a column of
points against a row, or the diagonal (:meth:`Kernel.diag`).

Points. Coordinates are ``(N,)`` or ``(N, d)``. The kernels of this module
and of :mod:`~tinygp_tpu_torch.kernels.stationary` see every point with a
trailing feature axis: ``(N,)`` coordinates reach ``evaluate`` as ``(..., 1)``
points, ``(N, d)`` ones as ``(..., d)``, and ``evaluate`` returns one value
per broadcast pair, without that axis. A :class:`Custom` function follows
the same rule. The quasiseparable kernels take bare ``(N,)`` coordinates
(their ``_features`` is ``False``); in a dense :class:`Sum` or
:class:`Product` they are evaluated on the lone feature.

Scalars in ``+`` and ``*`` become :class:`Constant` kernels. A dense kernel
plus a quasiseparable one is a dense :class:`Sum`; a quasiseparable kernel
refuses a dense operand (``kernels/quasisep.py``), as in the JAX package.
"""

from __future__ import annotations

__all__ = [
    "Kernel",
    "Conditioned",
    "Custom",
    "Sum",
    "Product",
    "Constant",
    "DotProduct",
    "Polynomial",
]

from collections.abc import Callable
from typing import Any

import torch
from torch import nn

from tinygp_tpu_torch.helpers import as_hyper, pinned


def _points(X: torch.Tensor) -> torch.Tensor:
    """Coordinates as points with a trailing feature axis."""
    return X[:, None] if X.ndim == 1 else X


def _pair_shape(X1: torch.Tensor, X2: torch.Tensor) -> torch.Size:
    """The broadcast shape of two point tensors, without the feature axis."""
    return torch.broadcast_shapes(X1.shape, X2.shape)[:-1]


class Kernel(nn.Module):
    """The base class of all kernels.

    Subclasses hold their hyperparameters as tensors and override
    :meth:`evaluate` (see the module docstring for the points it takes).
    """

    _features = True

    def evaluate(self, X1: torch.Tensor, X2: torch.Tensor) -> torch.Tensor:
        """The kernel at each broadcast pair of points ``X1`` and ``X2``."""
        del X1, X2
        raise NotImplementedError

    def evaluate_diag(self, X: torch.Tensor) -> torch.Tensor:
        """The kernel variance at each point of ``X``."""
        return self.evaluate(X, X)

    def gram(self, X1: torch.Tensor, X2: torch.Tensor) -> torch.Tensor:
        """``K[i, j] = k(X1[i], X2[j])``, by broadcasting; subclasses may
        override it with a cheaper product."""
        P1, P2 = _points(X1), _points(X2)
        return self.evaluate(P1[:, None], P2[None, :])

    def diag(self, X: torch.Tensor) -> torch.Tensor:
        """The kernel's diagonal over a dataset."""
        return self.evaluate_diag(_points(X))

    def matmul(
        self,
        X1: torch.Tensor,
        X2: torch.Tensor | None = None,
        y: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """``K(X1, X2) @ y``, densely (``K(X1, X1) @ y`` without ``X2``)."""
        if y is None:
            X2, y = None, X2
            if y is None:
                raise TypeError("matmul() needs a right-hand side `y`")
        return self(X1, X1 if X2 is None else X2) @ y

    @pinned
    def forward(
        self, X1: torch.Tensor, X2: torch.Tensor | None = None
    ) -> torch.Tensor:
        """``K(X1, X2)``, or its diagonal if ``X2`` is ``None``."""
        if X2 is None:
            return _checked_ndim(self.diag(X1), 1, "diagonal")
        return _checked_ndim(self.gram(X1, X2), 2, "matrix")

    # -- composition algebra; quasiseparable kernels override it ------------
    def __add__(self, other: Any) -> Kernel:
        return Sum(self, _as_kernel(other))

    def __radd__(self, other: Any) -> Kernel:
        # builtin sum() seeds its accumulator with the int 0; fold it away.
        if isinstance(other, int | float) and other == 0:
            return self
        return Sum(_as_kernel(other), self)

    def __mul__(self, other: Any) -> Kernel:
        return Product(self, _as_kernel(other))

    def __rmul__(self, other: Any) -> Kernel:
        return Product(_as_kernel(other), self)


def _as_kernel(obj: Any) -> Kernel:
    """Lift a scalar into a :class:`Constant`; pass kernels through."""
    return obj if isinstance(obj, Kernel) else Constant(obj)


def _checked_ndim(k: torch.Tensor, ndim: int, what: str) -> torch.Tensor:
    if k.ndim != ndim:
        raise ValueError(
            f"kernel evaluation produced a {k.ndim}-d {what} where {ndim}-d "
            "was expected; a parameter or a custom evaluate() is likely "
            "carrying extra dimensions"
        )
    return k


def _evaluate(kernel: Kernel, X1: torch.Tensor, X2: torch.Tensor) -> torch.Tensor:
    """``kernel.evaluate`` on points, in the kernel's own convention."""
    if kernel._features:
        return kernel.evaluate(X1, X2)
    return kernel.evaluate(X1[..., 0], X2[..., 0])


def _evaluate_diag(kernel: Kernel, X: torch.Tensor) -> torch.Tensor:
    if kernel._features:
        return kernel.evaluate_diag(X)
    return kernel.evaluate_diag(X[..., 0])


def _gram(kernel: Kernel, X1: torch.Tensor, X2: torch.Tensor) -> torch.Tensor:
    return kernel.gram(X1, X2)


def _diag(kernel: Kernel, X: torch.Tensor) -> torch.Tensor:
    return kernel.diag(X)


class Conditioned(Kernel):
    """The kernel of a process conditioned on data:
    ``k(a, b) - k(X, a)^T K^-1 k(X, b)``, through the training solver's
    triangular solves.

    Args:
        X: The training coordinates, ``(N,)`` or ``(N, d)``.
        solver: The training process's solver (its factor ``L``).
        kernel: The prior kernel.
    """

    def __init__(self, X: torch.Tensor, solver: nn.Module, kernel: Kernel):
        super().__init__()
        self.X = X
        self.solver = solver
        self.kernel = kernel
        self._features = kernel._features

    def _whitened(self, Xs: torch.Tensor) -> torch.Tensor:
        """``L^-1 k(X, Xs)`` for coordinates ``Xs``: ``(N, len(Xs))``."""
        return self.solver.solve_triangular(self.kernel(self.X, Xs))

    def _flat(self, X: torch.Tensor) -> torch.Tensor:
        """Broadcast points as a flat list of coordinates like ``self.X``."""
        return X.reshape(-1, *self.X.shape[1:])

    def evaluate(self, X1: torch.Tensor, X2: torch.Tensor) -> torch.Tensor:
        X1, X2 = torch.broadcast_tensors(X1, X2)
        shape = X1.shape[:-1] if self._features else X1.shape
        A1 = self._whitened(self._flat(X1))
        A2 = self._whitened(self._flat(X2))
        cross = torch.sum(A1 * A2, dim=0).reshape(shape)
        return self.kernel.evaluate(X1, X2) - cross

    def evaluate_diag(self, X: torch.Tensor) -> torch.Tensor:
        shape = X.shape[:-1] if self._features else X.shape
        A = self._whitened(self._flat(X))
        return self.kernel.evaluate_diag(X) - torch.sum(A * A, dim=0).reshape(shape)

    def gram(self, X1: torch.Tensor, X2: torch.Tensor) -> torch.Tensor:
        """The matrix through one solve per coordinate set (the default
        would solve once per pair)."""
        return self.kernel(X1, X2) - self._whitened(X1).T @ self._whitened(X2)

    def diag(self, X: torch.Tensor) -> torch.Tensor:
        A = self._whitened(X)
        return self.kernel(X) - torch.sum(A * A, dim=0)


class Custom(Kernel):
    """A kernel from a plain callable ``function(X1, X2)`` that takes
    broadcast points (feature axis last) and returns one value per pair."""

    def __init__(self, function: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]):
        super().__init__()
        self.function = function

    def evaluate(self, X1: torch.Tensor, X2: torch.Tensor) -> torch.Tensor:
        return self.function(X1, X2)


class _Pair(Kernel):
    """Shared structure of the binary combinations (``kernel1``,
    ``kernel2``, as in the JAX package)."""

    def __init__(self, kernel1: Kernel, kernel2: Kernel):
        super().__init__()
        self.kernel1 = kernel1
        self.kernel2 = kernel2

    def _both(self, method: Callable, *args: torch.Tensor):
        return method(self.kernel1, *args), method(self.kernel2, *args)


class Sum(_Pair):
    """The sum of two kernels."""

    def evaluate(self, X1: torch.Tensor, X2: torch.Tensor) -> torch.Tensor:
        a, b = self._both(_evaluate, X1, X2)
        return a + b

    def evaluate_diag(self, X: torch.Tensor) -> torch.Tensor:
        a, b = self._both(_evaluate_diag, X)
        return a + b

    def gram(self, X1: torch.Tensor, X2: torch.Tensor) -> torch.Tensor:
        # Summing whole matrices keeps each term's own way of building its matrix.
        a, b = self._both(_gram, X1, X2)
        return a + b

    def diag(self, X: torch.Tensor) -> torch.Tensor:
        a, b = self._both(_diag, X)
        return a + b


class Product(_Pair):
    """The elementwise product of two kernels."""

    def evaluate(self, X1: torch.Tensor, X2: torch.Tensor) -> torch.Tensor:
        a, b = self._both(_evaluate, X1, X2)
        return a * b

    def evaluate_diag(self, X: torch.Tensor) -> torch.Tensor:
        a, b = self._both(_evaluate_diag, X)
        return a * b

    def gram(self, X1: torch.Tensor, X2: torch.Tensor) -> torch.Tensor:
        a, b = self._both(_gram, X1, X2)
        return a * b

    def diag(self, X: torch.Tensor) -> torch.Tensor:
        a, b = self._both(_diag, X)
        return a * b


class Constant(Kernel):
    r"""A constant kernel: :math:`k(x_i, x_j) = c` for a scalar ``value``."""

    def __init__(self, value: Any):
        super().__init__()
        self.register_buffer("value", as_hyper(value))

    def evaluate(self, X1: torch.Tensor, X2: torch.Tensor) -> torch.Tensor:
        if self.value.ndim:
            raise ValueError(
                "Constant kernels wrap a scalar; for array-valued amplitudes "
                "compose with transforms or a custom kernel"
            )
        return self.value.expand(_pair_shape(X1, X2))


class DotProduct(Kernel):
    r"""The dot-product kernel :math:`k(x_i, x_j) = x_i \cdot x_j`."""

    def evaluate(self, X1: torch.Tensor, X2: torch.Tensor) -> torch.Tensor:
        return torch.sum(X1 * X2, dim=-1)

    def gram(self, X1: torch.Tensor, X2: torch.Tensor) -> torch.Tensor:
        # One matrix product instead of N*M dot products.
        return _points(X1) @ _points(X2).T


class Polynomial(Kernel):
    r"""A polynomial kernel
    :math:`k(x_i, x_j) = [(x_i / \ell) \cdot (x_j / \ell) + \sigma^2]^P`.

    Args:
        order: The power :math:`P`.
        scale: The parameter :math:`\ell`.
        sigma: The parameter :math:`\sigma`.
    """

    def __init__(self, order: Any, scale: Any = 1.0, sigma: Any = 0.0):
        super().__init__()
        for name, value in (("order", order), ("scale", scale), ("sigma", sigma)):
            self.register_buffer(name, as_hyper(value))

    def evaluate(self, X1: torch.Tensor, X2: torch.Tensor) -> torch.Tensor:
        base = torch.sum((X1 / self.scale) * (X2 / self.scale), dim=-1)
        return (base + torch.square(self.sigma)) ** self.order
