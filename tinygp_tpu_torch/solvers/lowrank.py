"""Inducing-point low-rank solver: dense kernels at large N in O(N M^2).

Counterpart of ``tinygp_tpu/solvers/lowrank.py``. The prior is
approximated with the FITC/Nystrom construction on M inducing points Z::

    K ~= Khat = D + W W^T,
    W = k(X, Z) chol(k(Z, Z))^{-T},
    D = noise_diag + (k_diag(X) - rowsum(W^2))   [FITC: exact diagonal]

and ``Khat`` is then treated exactly through Woodbury identities: within
the approximate prior every number the solver produces (log-likelihood,
conditionals, samples) is exact, and with ``Z = X`` it reproduces
:class:`~tinygp_tpu_torch.solvers.direct.DirectSolver` to float precision.

The work is two tall products (N x M) and M x M factorizations
(``torch.linalg``), the grams the port's broadcasting kernels, as in the
JAX solver; its products run in full float32, forward under
:func:`~tinygp_tpu_torch.helpers.pinned` and backward from the entry
points' :func:`~tinygp_tpu_torch.helpers.pin_backward`. The ``Solver`` contract's
triangular factor is the symmetric square root of the Woodbury
capacitance::

    Khat = Lhat Lhat^T,  Lhat = D^{1/2} (I + V V^T)^{1/2},  V = D^{-1/2} W
    (I + V V^T)^{+-1/2} = I + V phi(S) V^T,     S = V^T V  (M x M)

where ``phi`` is an analytic matrix function of S applied through a
symmetric eigendecomposition. Its gradient is the Daleckii-Krein
divided-difference formula, which stays finite at repeated eigenvalues
(the raw ``eigh`` backward has 1/(lam_i - lam_j) terms, NaN where W is
rank-deficient: duplicated inducing points, M past the gram's numerical
rank). No host read guards anything: a non-finite capacitance poisons the
output with NaN instead of reaching ``eigh``, and a failed Cholesky gives
NaN.
"""

from __future__ import annotations

__all__ = ["LowRankSolver"]

import math
from typing import Any

import torch
from torch.autograd.function import once_differentiable

from tinygp_tpu_torch.helpers import as_tensor, full_float32, pinned
from tinygp_tpu_torch.kernels.base import Kernel
from tinygp_tpu_torch.noise import Diagonal, Noise
from tinygp_tpu_torch.solvers.solver import Solver


def _phi(lam: torch.Tensor, sign: int) -> torch.Tensor:
    """``((1 + lam)^{sign/2} - 1) / lam`` in cancellation-free form."""
    u = torch.sqrt(1.0 + lam)
    if sign > 0:
        return 1.0 / (1.0 + u)
    return -1.0 / (u * (1.0 + u))


def _phi_prime(lam: torch.Tensor, sign: int) -> torch.Tensor:
    """Derivative of :func:`_phi`, same stable parameterization."""
    u = torch.sqrt(1.0 + lam)
    if sign > 0:
        return -1.0 / (2.0 * u * (1.0 + u) ** 2)
    return (1.0 + 2.0 * u) / (2.0 * u * (u * (1.0 + u)) ** 2)


def _finite_guard(S: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Replace a non-finite ``S`` with I and return a NaN poison scalar.

    ``eigh`` must never see a non-finite input (on the TPU it took the
    worker process down; on the card it may fail to converge and raise).
    The guard keeps the decomposition defined and re-injects NaN into the
    output, so the GP's NaN -> -inf log-probability guard still sees the
    failure. Both are ``torch.where`` on the device: no host read.
    """
    bad = ~torch.all(torch.isfinite(S))
    eye = torch.eye(S.shape[0], dtype=S.dtype, device=S.device)
    safe = torch.where(bad, eye, S)
    poison = torch.where(bad, torch.nan, 0.0).to(S.dtype)
    return safe, poison


class _CapApply(torch.autograd.Function):
    """``phi(S) @ T`` with the Daleckii-Krein gradient (the JAX package's
    custom JVP of ``_cap_apply``, as a VJP)."""

    @staticmethod
    def forward(S, T, sign):
        with full_float32():
            S, poison = _finite_guard(S)
            lam, E = torch.linalg.eigh(S)
            lam = torch.clamp(lam, min=0.0)
            f = _phi(lam, sign)
            out = E @ (f[:, None] * (E.T @ T)) + poison
        return out, lam, E, f, poison

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, T, sign = inputs
        _, lam, E, f, poison = output
        ctx.mark_non_differentiable(lam, E, f, poison)
        ctx.save_for_backward(T, lam, E, f, poison)
        ctx.sign = sign

    @staticmethod
    @once_differentiable
    def backward(ctx, grad, *_):
        """With ``D`` the symmetric divided differences of ``phi`` at the
        eigenvalues (``phi'`` on ties, within ``1e-6 (1 + lam_i + lam_j)``)
        and ``G`` the output's cotangent::

            Tbar = E diag(f) E^T G
            Sbar = sym(E (D o (E^T G T^T E)) E^T)
        """
        T, lam, E, f, poison = ctx.saved_tensors
        with full_float32():
            df = _phi_prime(lam, ctx.sign)
            den = lam[:, None] - lam[None, :]
            tie = torch.abs(den) < 1e-6 * (1.0 + lam[:, None] + lam[None, :])
            D = torch.where(
                tie,
                0.5 * (df[:, None] + df[None, :]),
                (f[:, None] - f[None, :]) / torch.where(tie, 1.0, den),
            )
            Et_G = E.T @ grad
            Tbar = E @ (f[:, None] * Et_G) + poison
            inner = Et_G @ (T.T @ E)
            Sbar = E @ (D * inner) @ E.T
            Sbar = 0.5 * (Sbar + Sbar.T) + poison
        return Sbar, Tbar, None


def _cap_apply(S: torch.Tensor, T: torch.Tensor, sign: int) -> torch.Tensor:
    """``phi(S) @ T`` with a tie-safe gradient.

    ``(I + V V^T)^{sign/2} = I + V phi(S) V^T``. ``phi`` is applied in the
    eigenbasis (each direction scaled, ``E phi E^T`` never formed: the
    formed matrix mixes O(0.5) and O(1/lam_max) scalings into shared
    entries and loses accuracy in float32 when ``cond(S)`` is large). The
    gradient uses Daleckii-Krein divided differences
    ``(phi_i - phi_j)/(lam_i - lam_j)`` with the analytic ``phi'`` on
    (near-)ties, so it is finite for any PSD S, the rank-deficient ones
    included.
    """
    return _CapApply.apply(S, T, sign)[0]


def _cholesky(A: torch.Tensor) -> torch.Tensor:
    """The lower Cholesky factor, NaN where the factorization fails (the
    JAX package's convention), without a host read."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where(info == 0, L, torch.nan)


def _solve_lower(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    with full_float32():
        return torch.linalg.solve_triangular(L, B, upper=False)


class LowRankSolver(Solver):
    """FITC/Nystrom inducing-point solver for dense kernels.

    Args:
        kernel: Any dense :class:`~tinygp_tpu_torch.kernels.base.Kernel`.
        X: Input coordinates, ``(N,)`` or ``(N, d)``.
        noise: Observation noise; must be :class:`Diagonal`.
        inducing_points: The ``(M,)``/``(M, d)`` inducing locations Z, moved
            to ``X``'s device and dtype. A good default is a subset of
            ``X``. Required.
        fitc: Keep the prior's diagonal exact by folding the Nystrom
            residual ``k_diag - rowsum(W^2)`` into ``D`` (default). With
            ``False`` (subset-of-regressors) the diagonal is the Nystrom
            one and ``D`` is the noise alone.

    Within the approximate prior all outputs are exact; with ``Z = X`` the
    approximation is exact and this matches ``DirectSolver`` to float
    precision. Cost: ``O(N M^2 + M^3)`` time, ``O(N M)`` memory.

    The predictive covariance contracts the *Nystrom* cross-covariances
    ``Qsf = k(X*, Z) Kmm^{-1} k(Z, X)`` against the approximate prior
    inverse (the standard FITC predictive), which keeps it positive
    semi-definite; the predictive mean assembled by
    :meth:`GaussianProcess.condition` uses the exact cross-covariance
    against ``Khat^{-1} y`` (a DTC-style mean).
    """

    @pinned
    def __init__(
        self,
        kernel: Kernel,
        X: torch.Tensor,
        noise: Noise,
        *,
        covariance: Any | None = None,
        inducing_points: Any | None = None,
        fitc: bool = True,
    ):
        super().__init__()
        if covariance is not None:
            raise TypeError("LowRankSolver builds its own structured covariance")
        if inducing_points is None:
            raise TypeError(
                "LowRankSolver requires inducing_points=Z (e.g. a subset of X)"
            )
        if not isinstance(noise, Diagonal):
            raise TypeError("LowRankSolver supports Diagonal noise only")

        Z = as_tensor(inducing_points, X.device, X.dtype)
        k_diag = kernel(X)
        Kmm = kernel(Z, Z)
        Knm = kernel(X, Z)
        # Smooth kernels make Kmm numerically singular for clustered Z, so
        # the factorization takes a ridge sized by dtype to dominate the
        # round-off's negative tail, which scales with ||Kmm||_2; the trace
        # is its cheap upper bound (max |diag| is about M times too small
        # for clustered inducing points).
        rel = 1e-10 if Kmm.dtype == torch.float64 else 3e-6
        ridge = rel * torch.sum(torch.abs(torch.diagonal(Kmm)))
        Kmm = Kmm + ridge * torch.eye(Kmm.shape[0], dtype=Kmm.dtype, device=Kmm.device)
        Lmm = _cholesky(Kmm)
        # W = Knm Lmm^{-T}: one triangular solve against the M x M factor.
        W = _solve_lower(Lmm, Knm.T).T

        qff_diag = torch.sum(torch.square(W), dim=1)
        noise_diag = noise.diagonal()
        if fitc:
            D = noise_diag + torch.clamp(k_diag - qff_diag, min=0.0)
            variance = k_diag + noise_diag
        else:
            D = noise_diag * torch.ones_like(k_diag)
            variance = qff_diag + noise_diag

        V = W / torch.sqrt(D)[:, None]
        self.X = X
        self.inducing_points = Z
        self.fitc = fitc
        self.Lmm = Lmm
        self.W = W
        self.D = D
        self.S = V.T @ V
        self.variance_value = variance

    # -- the (I + V V^T)^{sign/2} operator -----------------------------------

    def _half_power(self, y: torch.Tensor, sign: int) -> torch.Tensor:
        V = self.W / torch.sqrt(self.D)[:, None]
        t = V.T @ y.reshape(y.shape[0], -1)
        return y + (V @ _cap_apply(self.S, t, sign)).reshape(y.shape)

    def variance(self) -> torch.Tensor:
        return self.variance_value

    @pinned
    def covariance(self) -> torch.Tensor:
        # The dense Khat; O(N^2 M), for tests and small problems only.
        return torch.diag(self.D) + self.W @ self.W.T

    def _cap_chol(self) -> torch.Tensor:
        """Cholesky of the M x M capacitance ``I + S`` (always SPD)."""
        eye = torch.eye(self.S.shape[0], dtype=self.S.dtype, device=self.S.device)
        return _cholesky(eye + self.S)

    @pinned
    def normalization(self) -> torch.Tensor:
        n = self.D.shape[0]
        logdet_cap = 2.0 * torch.sum(torch.log(torch.diagonal(self._cap_chol())))
        logdet = torch.sum(torch.log(self.D)) + logdet_cap
        return 0.5 * logdet + 0.5 * n * math.log(2 * math.pi)

    @pinned
    def log_likelihood(self, r: torch.Tensor) -> torch.Tensor:
        """The fused Woodbury log density, with no eigendecomposition.

        The quadratic form needs only ``Khat^{-1}``, which Woodbury gives
        through one M x M Cholesky::

            quad = z^T z - u^T (I + S)^{-1} u,  z = D^{-1/2} r, u = V^T z
            log|Khat| = sum log D + 2 sum log diag(chol(I + S))

        The square-root operator (``solve_triangular``/``dot_triangular``)
        keeps the ``eigh`` route for sampling and conditioning.
        """
        z = r / torch.sqrt(self.D)
        u = (self.W / self.D[:, None]).T @ r
        w = _solve_lower(self._cap_chol(), u.reshape(u.shape[0], -1))
        quad = torch.sum(torch.square(z)) - torch.sum(torch.square(w))
        return -0.5 * quad - self.normalization()

    @pinned
    def solve_triangular(
        self, y: torch.Tensor, *, transpose: bool = False
    ) -> torch.Tensor:
        sqrt_D = torch.sqrt(self.D).reshape((-1,) + (1,) * (y.ndim - 1))
        if transpose:
            return self._half_power(y, -1) / sqrt_D
        return self._half_power(y / sqrt_D, -1)

    @pinned
    def dot_triangular(self, y: torch.Tensor) -> torch.Tensor:
        sqrt_D = torch.sqrt(self.D).reshape((-1,) + (1,) * (y.ndim - 1))
        return sqrt_D * self._half_power(y, 1)

    @pinned
    def condition(self, kernel: Kernel, X_test: Any, noise: Noise) -> Any:
        """The FITC predictive covariance ``Kss + noise - Qsf Khat^{-1} Qfs``.

        Positive semi-definite by construction. At the training points
        (``X_test=None``) this is N x N: condition on a prediction grid
        instead when N is the reason for this solver.
        """
        Xs = self.X if X_test is None else X_test
        Kss = noise + kernel(Xs, Xs)
        # Ws = k(Xs, Z) Lmm^{-T}, so Qfs = W Ws^T.
        Ws = _solve_lower(self.Lmm, kernel(Xs, self.inducing_points).T).T
        # The Nystrom cross-covariance whitened directly (O(N M T)): the
        # equivalent M x M capacitance route squares the conditioning and
        # loses about 1e-3 absolute on float32 posterior variances.
        A = self.solve_triangular(self.W @ Ws.T)
        return Kss - A.T @ A
