"""The exact dense O(N^3) solver.

Counterpart of ``tinygp_tpu/solvers/direct.py``. For float32 matrices of
at least ``ops.dense._MIN_BLOCKED`` points the factor is the blocked
Cholesky of :func:`~tinygp_tpu_torch.ops.dense.cholesky_with_fallback`
(kernels B5 and B4 on the card, the split order picked from the noise
floor, the native factor as the rescue); ``blocked=False`` forces the
native factor everywhere.

The JAX solver factors in its constructor, and ``jit`` drops that factor
as dead code on the log-likelihood route. Eager PyTorch would not, so the
port builds the covariance and its factor ``scale_tril`` on first use:
``log_probability`` with diagonal noise runs only the fused strip-built
route (:func:`~tinygp_tpu_torch.ops.dense.kernel_loglik_terms`, B5 and B4
with its row side products), and a posterior process built from a given
covariance never factors it for its ``variance``.
"""

from __future__ import annotations

__all__ = ["DirectSolver"]

import math
from typing import Any

import torch

from tinygp_tpu_torch.kernels.base import Kernel
from tinygp_tpu_torch.noise import Diagonal, Noise
from tinygp_tpu_torch.ops import dense as _dense
from tinygp_tpu_torch.solvers.solver import Solver


class DirectSolver(Solver):
    """Factorize the dense covariance with a Cholesky decomposition.

    Args:
        kernel: The kernel.
        X: The input coordinates, ``(N,)`` or ``(N, d)``.
        noise: The observation noise model.
        covariance: A precomputed dense covariance, taken to be
            ``kernel(X, X) + noise`` (not checked); its diagonal is the
            variance.
        blocked: Use the blocked Cholesky for large float32 matrices;
            ``False`` forces the native factor.
    """

    def __init__(
        self,
        kernel: Kernel,
        X: torch.Tensor,
        noise: Noise,
        *,
        covariance: torch.Tensor | None = None,
        blocked: bool = True,
    ):
        super().__init__()
        self.X = X
        self.blocked = blocked
        self._covariance = covariance
        self._scale_tril = None
        if covariance is None:
            self.variance_value = kernel(X) + noise.diagonal()
            self._cov_parts = (kernel, noise)
        else:
            # A given covariance is kernel(X, X) + noise by contract, so its
            # diagonal is the variance (for a posterior this skips one
            # O(N^2) solve per point).
            self.variance_value = torch.diagonal(covariance)
            self._cov_parts = None
        if blocked and isinstance(noise, Diagonal):
            # The noise floor bounds the smallest eigenvalue of the scaled
            # covariance from below for diagonal noise only; any other
            # noise takes the 3-term order (rel_floor = 0).
            self.rel_floor = torch.min(
                noise.diagonal() / torch.clamp(self.variance_value, min=1e-30)
            )
        else:
            self.rel_floor = self.variance_value.new_zeros(())
        # The strip-built log-likelihood rebuilds the covariance from the
        # kernel: only without a given covariance, and for diagonal noise.
        fused = covariance is None and isinstance(noise, Diagonal)
        self.kernel = kernel if fused else None
        self.noise_diag = noise.diagonal() if fused else None

    @property
    def covariance_value(self) -> torch.Tensor:
        """The dense covariance, built on first use."""
        if self._covariance is None:
            kernel, noise = self._cov_parts
            self._covariance = noise + kernel(self.X, self.X)
        return self._covariance

    @property
    def scale_tril(self) -> torch.Tensor:
        """The lower Cholesky factor of the covariance, built on first use."""
        if self._scale_tril is None:
            if self.blocked:
                self._scale_tril = _dense.cholesky_with_fallback(
                    self.covariance_value, rel_floor=self.rel_floor
                )
            else:
                self._scale_tril = _dense._native_cholesky(self.covariance_value)
        return self._scale_tril

    def variance(self) -> torch.Tensor:
        return self.variance_value

    def covariance(self) -> torch.Tensor:
        return self.covariance_value

    def normalization(self) -> torch.Tensor:
        n = self.variance_value.shape[0]
        return torch.sum(torch.log(torch.diagonal(self.scale_tril))) + 0.5 * n * math.log(
            2.0 * math.pi
        )

    def log_likelihood(self, r: torch.Tensor) -> torch.Tensor:
        """The fused factor-and-whiten route for large float32 systems
        (strip-built from the kernel where it can be, from the covariance
        otherwise); small, float64 or batched residuals whiten through the
        factor."""
        n = self.variance_value.shape[0]
        if (
            not self.blocked
            or r.ndim != 1
            or self.variance_value.dtype != torch.float32
            or n < _dense._MIN_BLOCKED
        ):
            return super().log_likelihood(r)
        if self.kernel is not None:
            quad, half_logdet = _dense.kernel_loglik_terms(
                self.kernel,
                self.X,
                self.noise_diag,
                r,
                variance=self.variance_value,
                rel_floor=self.rel_floor,
            )
        else:
            quad, half_logdet = _dense.blocked_loglik_terms(
                self.covariance_value,
                r,
                min_size=_dense._MIN_BLOCKED,
                rel_floor=self.rel_floor,
            )
        return -0.5 * (quad + n * math.log(2.0 * math.pi)) - half_logdet

    def solve_triangular(
        self, y: torch.Tensor, *, transpose: bool = False
    ) -> torch.Tensor:
        flat = y.reshape(y.shape[0], -1)
        return _dense._solve_lower(self.scale_tril, flat, trans=transpose).reshape(y.shape)

    def dot_triangular(self, y: torch.Tensor) -> torch.Tensor:
        return torch.tensordot(self.scale_tril, y, dims=1)

    def condition(
        self, kernel: Kernel, X_test: torch.Tensor | None, noise: Noise
    ) -> Any:
        """The dense posterior covariance ``Kss - A^T A``, ``A = L^-1 Ks``.
        The downdate is one plain product, as in the JAX package, which
        keeps it on the native product in full float32: the variance
        cancels (a prior 1.6 down to about 7e-4 on ``bench.py``'s dense
        workload)."""
        if X_test is None:
            Ks = kernel(self.X, self.X)
            Kss = noise + Ks
        else:
            Ks = kernel(self.X, X_test)
            Kss = noise + kernel(X_test, X_test)
        A = self.solve_triangular(Ks)
        return Kss - A.mT @ A
