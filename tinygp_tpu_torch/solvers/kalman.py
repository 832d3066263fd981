"""A Kalman-filter solver, used as an independent O(N) oracle.

Counterpart of ``tinygp_tpu/solvers/kalman.py``. Only the
marginal-likelihood path (``normalization`` and the whitening
``solve_triangular``) is implemented: the solver cross-checks the
quasiseparable factorization through a different recursion, the
innovations form of the state-space filter.

Both recursions are sequential loops over N of m × m products in plain
PyTorch, on any device: on the card each step is a handful of small
launches, so a call costs milliseconds per thousand points. It is an
oracle, not a path to make fast, and it is not rewritten through the scan
kernels (which would make it the code it checks).
"""

from __future__ import annotations

__all__ = ["kalman_filter", "kalman_gains", "KalmanSolver"]

import math
from typing import Any

import torch

from tinygp_tpu_torch.helpers import pinned
from tinygp_tpu_torch.kernels.base import Kernel
from tinygp_tpu_torch.noise import Diagonal, Noise
from tinygp_tpu_torch.solvers.solver import Solver

_ORACLE_ONLY = (
    "KalmanSolver is a cross-checking oracle: only the marginal-"
    "likelihood path (normalization + forward whitening) is implemented"
)


class KalmanSolver(Solver):
    """Whiten observations with a Kalman filter.

    Args:
        kernel: A :class:`tinygp_tpu_torch.kernels.quasisep.Quasisep` kernel.
        X: Sorted input coordinates.
        noise: Must be :class:`tinygp_tpu_torch.noise.Diagonal`.
    """

    def __init__(
        self,
        kernel: Kernel,
        X: torch.Tensor,
        noise: Noise,
        *,
        covariance: Any | None = None,
    ):
        super().__init__()
        from tinygp_tpu_torch.kernels.quasisep import Quasisep

        if not isinstance(kernel, Quasisep):
            raise TypeError("the Kalman oracle needs a state-space kernel")
        if not isinstance(noise, Diagonal):
            raise TypeError("the Kalman oracle handles diagonal noise only")
        if covariance is not None:
            raise TypeError("precomputed covariances are not supported here")

        Pinf = kernel.stationary_covariance()
        X_prev = torch.cat([X[:1], X[:-1]])
        # The port's transitions are (m, m, N); the filter takes (N, m, m),
        # and its observation vectors are zero where the sortable
        # coordinate is NaN, as the JAX solver ties them to the inputs.
        A = kernel.transition_matrix(X_prev, X).permute(2, 0, 1)
        H = kernel._masked_observations(X).T
        self.X = X
        self.A = A
        self.H = H
        self.s, self.K = kalman_gains(Pinf, A, H, noise.diagonal())

    def variance(self) -> torch.Tensor:
        raise NotImplementedError(_ORACLE_ONLY)

    def covariance(self) -> torch.Tensor:
        raise NotImplementedError(_ORACLE_ONLY)

    def normalization(self) -> torch.Tensor:
        n = self.s.shape[0]
        return 0.5 * (torch.sum(torch.log(self.s)) + n * math.log(2 * math.pi))

    def solve_triangular(
        self, y: torch.Tensor, *, transpose: bool = False
    ) -> torch.Tensor:
        if transpose:
            raise NotImplementedError(_ORACLE_ONLY)
        innovations = kalman_filter(self.A, self.H, self.K, y)
        return innovations * torch.rsqrt(self.s)

    def dot_triangular(self, y: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError(_ORACLE_ONLY)

    def condition(self, kernel: Kernel, X_test: Any, noise: Noise) -> Any:
        raise NotImplementedError(_ORACLE_ONLY)


@pinned
def kalman_gains(
    Pinf: torch.Tensor, A: torch.Tensor, H: torch.Tensor, diag: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Innovation variances ``(N,)`` and gains ``(N, m)`` from the
    covariance recursion over ``A`` ``(N, m, m)``, ``H`` ``(N, m)`` and the
    noise ``diag`` ``(N,)``.

    Anchoring the recursion at the stationary covariance keeps it stable:
    ``P_pred = Pinf + A^T (P - Pinf) A`` propagates only the *deviation*
    from stationarity.
    """
    P = Pinf
    s, K = [], []
    for A_k, h_k, d_k in zip(A, H, diag):
        P_pred = Pinf + A_k.T @ (P - Pinf) @ A_k
        Ph = P_pred @ h_k
        s_k = h_k @ Ph + d_k
        K_k = Ph / s_k
        P = P_pred - s_k * torch.outer(K_k, K_k)
        s.append(s_k)
        K.append(K_k)
    return torch.stack(s), torch.stack(K)


@pinned
def kalman_filter(
    A: torch.Tensor, H: torch.Tensor, K: torch.Tensor, y: torch.Tensor
) -> torch.Tensor:
    """Run the mean filter, returning the (unnormalized) innovations
    ``(N,)``."""
    m = H.new_zeros(H.shape[1:])
    v = []
    for A_k, h_k, K_k, y_k in zip(A, H, K, y):
        m_pred = A_k.T @ m
        v_k = y_k - h_k @ m_pred
        m = m_pred + K_k * v_k
        v.append(v_k)
    return torch.stack(v)
