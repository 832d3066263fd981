"""The user-facing Gaussian process interface.

Counterpart of ``tinygp_tpu/gp.py``: the constructor and
:meth:`GaussianProcess.log_probability`. Conditioning, prediction and
sampling are ROADMAP item N2, the conditioning slice (kernel B3 and
``core.py``); the dense solver for other kernels is item N3, the dense slice.

The process lives on one device, in one dtype. ``device=None`` means the
card (``"cuda"``) and raises where there is none; pass ``device="cpu"``
for the plain PyTorch path. The dtype is the coordinates' (the default
dtype for non-float coordinates). The kernel, mean and noise move there,
in that dtype (``nn.Module.to``, in place).
"""

from __future__ import annotations

__all__ = ["GaussianProcess"]

import math
from collections.abc import Callable
from typing import Any

import torch
from torch import nn

from tinygp_tpu_torch import means
from tinygp_tpu_torch.helpers import as_tensor, resolve_device
from tinygp_tpu_torch.kernels.base import Kernel
from tinygp_tpu_torch.noise import Diagonal, Noise


class GaussianProcess(nn.Module):
    """A Gaussian process regression model.

    Args:
        kernel: The covariance kernel (quasiseparable in this slice).
        X: The ``(N,)`` input coordinates.
        diag: Extra diagonal variance (scalar or ``(N,)``); defaults to
            ``sqrt(eps)`` jitter for the dtype.
        noise: A full :class:`~tinygp_tpu_torch.noise.Noise` model;
            overrides ``diag``.
        mean: A constant, a callable on the ``(N,)`` coordinates, or a
            :class:`~tinygp_tpu_torch.means.MeanBase`.
        solver: A solver class; auto-selected when omitted.
        device: Where the process runs; ``None`` is ``"cuda"``.
        **solver_kwargs: Forwarded to the solver (e.g.
            ``assume_sorted=True``).

    Examples:
        >>> import torch
        >>> from tinygp_tpu_torch import GaussianProcess
        >>> from tinygp_tpu_torch.kernels import quasisep
        >>> X = torch.linspace(0.0, 10.0, 500, dtype=torch.float64)
        >>> gp = GaussianProcess(quasisep.Matern32(scale=1.5), X, diag=0.1,
        ...                      device="cpu")
        >>> bool(torch.isfinite(gp.log_probability(torch.sin(X))))
        True
    """

    def __init__(
        self,
        kernel: Kernel,
        X: Any,
        *,
        diag: Any | None = None,
        noise: Noise | None = None,
        mean: means.MeanBase | Callable[[torch.Tensor], torch.Tensor] | Any = None,
        solver: Any | None = None,
        device: Any = None,
        **solver_kwargs: Any,
    ):
        super().__init__()
        from tinygp_tpu_torch.kernels.quasisep import Quasisep
        from tinygp_tpu_torch.solvers.quasisep.solver import QuasisepSolver

        device = resolve_device(device)
        X = torch.as_tensor(X)
        dtype = X.dtype if X.is_floating_point() else torch.get_default_dtype()
        X = X.to(device=device, dtype=dtype)

        mean_function = _as_mean_function(mean).to(device=device, dtype=dtype)
        mean_value = mean_function(X)
        if mean_value.ndim != 1:
            raise ValueError(
                "the mean must evaluate to one scalar per data point; got "
                f"a {mean_value.ndim}-d tensor"
            )
        noise = _as_noise(noise, diag, mean_value).to(device=device, dtype=dtype)
        kernel = kernel.to(device=device, dtype=dtype)

        if solver is None:
            if not isinstance(kernel, Quasisep):
                raise NotImplementedError(
                    "the dense solver for non-quasiseparable kernels is "
                    "ROADMAP item N3 (the dense slice), not ported yet"
                )
            solver = QuasisepSolver
        if solver is QuasisepSolver:
            # The dense-only switch is a no-op on the O(N) path.
            solver_kwargs.pop("blocked", None)

        self.num_data = mean_value.shape[0]
        self.dtype = dtype
        self.device = device
        self.kernel = kernel
        self.X = X
        self.mean_function = mean_function
        self.mean = mean_value
        self.noise = noise
        self.solver = solver(kernel, X, noise, **solver_kwargs)

    @property
    def loc(self) -> torch.Tensor:
        """The marginal mean (alias of ``mean``)."""
        return self.mean

    @property
    def variance(self) -> torch.Tensor:
        """Pointwise marginal variance at the input points."""
        return self.solver.variance()

    def log_probability(self, y: Any) -> torch.Tensor:
        """The marginal log probability of ``y`` under this process.

        Non-finite results (e.g. from an indefinite covariance) are mapped
        to ``-inf`` so samplers reject rather than propagate NaNs.
        """
        y = as_tensor(y, self.device, self.dtype)
        lp = self.solver.log_likelihood(y - self.loc)
        return torch.where(torch.isfinite(lp), lp, -torch.inf)


def _default_diag(reference: torch.Tensor) -> float:
    """sqrt(eps) jitter for the reference's dtype."""
    return math.sqrt(torch.finfo(reference.dtype).eps)


def _as_mean_function(mean: Any) -> means.MeanBase:
    """Coerce a constant / callable / MeanBase into a mean function."""
    if isinstance(mean, means.MeanBase):
        return mean
    return means.Mean(0.0 if mean is None else mean)


def _as_noise(noise: Noise | None, diag: Any, reference: torch.Tensor) -> Noise:
    """Coerce the (noise, diag) pair into a Noise model, defaulting to
    sqrt(eps) jitter matched to ``reference``'s length and dtype."""
    if noise is not None:
        return noise
    diag = _default_diag(reference) if diag is None else diag
    diag = as_tensor(diag, reference.device, reference.dtype)
    return Diagonal(torch.broadcast_to(diag, reference.shape).contiguous())
