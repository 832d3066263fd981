"""The scalable O(N) quasiseparable solver.

Counterpart of ``tinygp_tpu/solvers/quasisep/solver.py``, for the stacked
route with :class:`~tinygp_tpu_torch.noise.Diagonal` noise: construction,
``variance`` and ``log_likelihood``. The JAX solver also builds the QSM
``matrix`` and its Cholesky ``factor`` eagerly; under ``jit`` both are dead
code for the log-likelihood, and in eager PyTorch they would be two wasted
O(N) passes, so the port builds neither. What needs them (``condition``,
the triangular solves and products, other noise models) is ROADMAP item N2,
the conditioning slice (kernel B3 and ``core.py``).
"""

from __future__ import annotations

__all__ = ["QuasisepSolver"]

import math
from typing import Any

import torch

from tinygp_tpu_torch.kernels.base import Kernel
from tinygp_tpu_torch.noise import Diagonal, Noise
from tinygp_tpu_torch.solvers.solver import Solver

_LATER = "is ROADMAP item N2 (conditioning: kernel B3, core.py), not ported yet"


class QuasisepSolver(Solver):
    """Factorize a quasiseparable covariance in O(N) work.

    Args:
        kernel: A quasiseparable kernel.
        X: Input coordinates, sorted along the kernel's sortable coordinate.
        noise: The observation noise; :class:`Diagonal` only.
        covariance: A precomputed covariance (not ported yet).
        assume_sorted: Skip the sorted-input check.
        parallel: The parallel scan strategy; the sequential one is not
            ported.
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

        if covariance is not None:
            raise NotImplementedError(f"a precomputed covariance {_LATER}")
        if not parallel:
            raise NotImplementedError(f"the sequential strategy {_LATER}")
        if not isinstance(noise, Diagonal):
            raise NotImplementedError(
                f"{type(noise).__name__} noise with the quasiseparable solver "
                f"{_LATER}"
            )
        if not isinstance(kernel, Quasisep):
            raise TypeError("QuasisepSolver needs a quasiseparable kernel")
        if not assume_sorted:
            _guard_sorted(kernel.coord_to_sortable(X))
        d, ps, qs, as_ = kernel.to_stacked_ssm(X)
        self.X = X
        self.ssm = (d + noise.diagonal(), ps, qs, as_)

    def variance(self) -> torch.Tensor:
        return self.ssm[0]

    def covariance(self) -> torch.Tensor:
        raise NotImplementedError(f"the dense covariance {_LATER}")

    def normalization(self) -> torch.Tensor:
        raise NotImplementedError(f"the factor's normalization {_LATER}")

    def solve_triangular(
        self, y: torch.Tensor, *, transpose: bool = False
    ) -> torch.Tensor:
        raise NotImplementedError(f"solve_triangular {_LATER}")

    def dot_triangular(self, y: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError(f"dot_triangular {_LATER}")

    def condition(self, kernel, X_test, noise):
        raise NotImplementedError(f"condition {_LATER}")

    def log_likelihood(self, r: torch.Tensor) -> torch.Tensor:
        """Fused factor-and-whiten in one stacked pass."""
        if r.ndim != 1:
            raise NotImplementedError(f"a batched residual {_LATER}")
        from tinygp_tpu_torch.solvers.quasisep.ops import stacked_loglik_terms

        d, ps, qs, as_ = self.ssm
        quad, logdet = stacked_loglik_terms(d, ps, qs, as_, r)
        n = r.shape[0]
        return -0.5 * (quad + n * math.log(2 * math.pi)) - logdet


def _guard_sorted(coords: torch.Tensor) -> None:
    """Raise on unsorted inputs. The port runs eagerly, so this is the JAX
    check's concrete branch; it reads the comparison back to the host."""
    if bool(torch.any(torch.diff(coords) < 0)):
        raise ValueError(
            "Input coordinates must be sorted in order to use the "
            "QuasisepSolver"
        )
