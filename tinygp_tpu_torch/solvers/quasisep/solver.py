"""The scalable O(N) quasiseparable solver.

Counterpart of ``tinygp_tpu/solvers/quasisep/solver.py``. The solver holds
the covariance as a :class:`~tinygp_tpu_torch.solvers.quasisep.core.SymmQSM`
(``matrix``) and its Cholesky factor (``factor``), and offers the
triangular solves and products, the normalization, the covariance and the
posterior covariance of conditioning.

The JAX solver builds ``matrix`` and ``factor`` eagerly; under ``jit`` both
are dead code for the log-likelihood. In eager PyTorch they would be wasted
O(N) passes, so the port builds each on first use. With ``Diagonal`` noise
and the parallel strategy the log-likelihood takes the fused stacked route
(kernel B1 on the card) and builds neither. The factor of a posterior
(order 4m) is built only when something needs it, such as its
``log_probability`` or ``sample``; on the card its scans run the
generic-order kernels above order 4.
"""

from __future__ import annotations

__all__ = ["QuasisepSolver"]

import math
from typing import Any

import torch

from tinygp_tpu_torch.kernels.base import Kernel
from tinygp_tpu_torch.noise import Diagonal, Noise
from tinygp_tpu_torch.solvers.quasisep.core import LowerTriQSM, SymmQSM
from tinygp_tpu_torch.solvers.solver import Solver


class QuasisepSolver(Solver):
    """Factorize a quasiseparable covariance in O(N) work.

    Args:
        kernel: A quasiseparable kernel (unused with ``covariance``).
        X: Input coordinates, sorted along the kernel's sortable coordinate.
        noise: The observation noise; any model with a quasiseparable form.
        covariance: A precomputed :class:`SymmQSM` covariance, such as a
            posterior's; it already holds its noise.
        assume_sorted: Skip the sorted-input check.
        parallel: The monoid scans (kernel B3 on the card) or the
            sequential oracle, a Python loop over N.
    """

    def __init__(
        self,
        kernel: Kernel,
        X: torch.Tensor,
        noise: Noise,
        *,
        covariance: Any | None = None,
        assume_sorted: bool = False,
        parallel: bool = True,
    ):
        super().__init__()
        from tinygp_tpu_torch.kernels.quasisep import Quasisep

        self.X = X
        self.parallel = parallel
        self.ssm = None
        self._matrix = None
        self._factor = None
        if covariance is not None:
            if not isinstance(covariance, SymmQSM):
                raise TypeError("a precomputed covariance must be a SymmQSM")
            self._matrix = covariance
            return
        if not isinstance(kernel, Quasisep):
            raise TypeError("QuasisepSolver needs a quasiseparable kernel")
        if not assume_sorted:
            _guard_sorted(kernel.coord_to_sortable(X))
        if parallel and isinstance(noise, Diagonal):
            # The fused log-likelihood's operands, in the scans' stacked
            # layout; `matrix` is built from them on first use.
            d, ps, qs, as_ = kernel.to_stacked_ssm(X)
            self.ssm = (d + noise.diagonal(), ps, qs, as_)
        else:
            self._matrix = kernel.to_symm_qsm(X) + noise.to_qsm()

    @property
    def matrix(self) -> SymmQSM:
        """The covariance as a :class:`SymmQSM`."""
        if self._matrix is None:
            self._matrix = SymmQSM.from_stacked(*self.ssm)
        return self._matrix

    @property
    def factor(self) -> LowerTriQSM:
        """The lower Cholesky factor ``L`` of :attr:`matrix`."""
        if self._factor is None:
            self._factor = self.matrix.cholesky(parallel=self.parallel)
        return self._factor

    def variance(self) -> torch.Tensor:
        return self.ssm[0] if self.ssm is not None else self.matrix.diag.d

    def covariance(self) -> torch.Tensor:
        return self.matrix.to_dense()

    def normalization(self) -> torch.Tensor:
        n = self.factor.shape[0]
        return torch.sum(torch.log(self.factor.diag.d)) + 0.5 * n * math.log(2 * math.pi)

    def solve_triangular(
        self, y: torch.Tensor, *, transpose: bool = False
    ) -> torch.Tensor:
        if transpose:
            return self.factor.transpose().solve(y, parallel=self.parallel)
        return self.factor.solve(y, parallel=self.parallel)

    def dot_triangular(self, y: torch.Tensor) -> torch.Tensor:
        return self.factor.matmul(y, parallel=self.parallel)

    def log_likelihood(self, r: torch.Tensor) -> torch.Tensor:
        """Fused factor-and-whiten in one stacked pass where the stacked
        operands exist; otherwise whiten and normalize."""
        if self.ssm is None or r.ndim != 1:
            return super().log_likelihood(r)
        from tinygp_tpu_torch.solvers.quasisep.ops import stacked_loglik_terms

        d, ps, qs, as_ = self.ssm
        quad, logdet = stacked_loglik_terms(d, ps, qs, as_, r)
        n = r.shape[0]
        return -0.5 * (quad + n * math.log(2 * math.pi)) - logdet

    def condition(self, kernel: Kernel, X_test: Any, noise: Noise) -> Any:
        """The posterior covariance. At the training points with a
        quasiseparable ``kernel`` it stays a :class:`SymmQSM` of order 4m,
        ``M + noise - (L^-1 M)^T (L^-1 M)`` with ``M = K(X, X)``; otherwise it
        is the dense ``Kss - A^T A``, ``A = L^-1 K(X, X_test)``, without the
        noise, as in the JAX package."""
        from tinygp_tpu_torch.kernels.quasisep import Quasisep

        if X_test is None and isinstance(kernel, Quasisep):
            M = kernel.to_symm_qsm(self.X)
            delta = (self.factor.inv() @ M).gram()
            return (M + noise.to_qsm()) - delta
        if X_test is None:
            Kss = Ks = kernel(self.X, self.X)
        else:
            Kss = kernel(X_test, X_test)
            Ks = kernel(self.X, X_test)
        A = self.solve_triangular(Ks)
        return Kss - A.mT @ A


def _guard_sorted(coords: torch.Tensor) -> None:
    """Raise on unsorted inputs. The port runs eagerly, so this is the JAX
    check's concrete branch; it reads the comparison back to the host."""
    if bool(torch.any(torch.diff(coords) < 0)):
        raise ValueError(
            "Input coordinates must be sorted in order to use the "
            "QuasisepSolver"
        )
