"""The user-facing Gaussian process interface.

Counterpart of ``tinygp_tpu/gp.py``: the constructor,
:meth:`GaussianProcess.log_probability`, :meth:`~GaussianProcess.condition`,
:meth:`~GaussianProcess.predict` and :meth:`~GaussianProcess.sample`.
Quasiseparable kernels (and precomputed ``SymmQSM`` covariances) take the
O(N) :class:`~tinygp_tpu_torch.solvers.QuasisepSolver`; every other kernel
takes the dense :class:`~tinygp_tpu_torch.solvers.DirectSolver`. A
posterior at new points, or of a kernel that is not quasiseparable, has a
dense covariance and a ``DirectSolver``.

The process lives on one device, in one dtype. ``device=None`` means the
card (``"cuda"``) and raises where there is none; pass ``device="cpu"``
for the plain PyTorch path. The dtype is the coordinates' (the default
dtype for non-float coordinates). The kernel, mean and noise move there,
in that dtype (``nn.Module.to``, in place). ``sample`` takes a
``torch.Generator`` where the JAX package takes a key; the two streams
differ.

One exception to the single dtype: a float32 quasiseparable process
conditions in float64. Under x64 the JAX package forms the Matern and
cosine kernels' transitions from NumPy float64 constants
(``np.sqrt(3.0) / scale``), so its whole posterior runs in float64 on
float32 inputs; in float32 arithmetic the posterior variance
``k(x, x) - a^T a`` cancels to a few digits and the mean loses as many: at
new points (ROADMAP C7) and at the training points, where the variance
went negative (C8). :meth:`~GaussianProcess.condition` and
:meth:`~GaussianProcess.predict` therefore run a float64 copy of the
process on the same float32 values and hand back float32 results, each
rounded once (the posterior covariance at the training points a
``SymmQSM`` of float32 parts); the log-likelihood and sampling stay in
float32.
"""

from __future__ import annotations

__all__ = ["GaussianProcess", "ConditionResult"]

import math
from collections.abc import Callable, Sequence
from typing import Any, NamedTuple

import torch
from torch import nn

from tinygp_tpu_torch import means
from tinygp_tpu_torch.helpers import (
    as_tensor,
    mapped_module,
    pin_backward,
    pinned,
    resolve_device,
)
from tinygp_tpu_torch.kernels.base import Conditioned, Kernel
from tinygp_tpu_torch.noise import Diagonal, Noise


class GaussianProcess(nn.Module):
    """A Gaussian process regression model.

    Args:
        kernel: The covariance kernel.
        X: The input coordinates, ``(N,)`` or ``(N, d)``.
        diag: Extra diagonal variance (scalar or ``(N,)``); defaults to
            ``sqrt(eps)`` jitter for the dtype.
        noise: A full :class:`~tinygp_tpu_torch.noise.Noise` model;
            overrides ``diag``.
        mean: A constant, a callable on the ``(N,)`` coordinates, or a
            :class:`~tinygp_tpu_torch.means.MeanBase`.
        solver: A solver class; auto-selected when omitted.
        mean_value / covariance_value: Precomputed values, which
            :meth:`condition` passes to the posterior process.
        device: Where the process runs; ``None`` is ``"cuda"``.
        **solver_kwargs: Forwarded to the solver (e.g.
            ``assume_sorted=True`` for the quasiseparable one, ``blocked=False``
            for the dense one, which forces the native Cholesky); each
            solver drops the other's switches.

    Examples:
        >>> import torch
        >>> from tinygp_tpu_torch import GaussianProcess
        >>> from tinygp_tpu_torch.kernels import quasisep
        >>> X = torch.linspace(0.0, 10.0, 500, dtype=torch.float64)
        >>> gp = GaussianProcess(quasisep.Matern32(scale=1.5), X, diag=0.1,
        ...                      device="cpu")
        >>> bool(torch.isfinite(gp.log_probability(torch.sin(X))))
        True
        >>> _, cond = gp.condition(torch.sin(X))
        >>> cond.loc.shape
        torch.Size([500])
    """

    @pinned
    def __init__(
        self,
        kernel: Kernel,
        X: Any,
        *,
        diag: Any | None = None,
        noise: Noise | None = None,
        mean: means.MeanBase | Callable[[torch.Tensor], torch.Tensor] | Any = None,
        solver: Any | None = None,
        mean_value: torch.Tensor | None = None,
        covariance_value: Any | None = None,
        device: Any = None,
        **solver_kwargs: Any,
    ):
        super().__init__()
        from tinygp_tpu_torch.kernels.quasisep import Quasisep
        from tinygp_tpu_torch.solvers.direct import DirectSolver
        from tinygp_tpu_torch.solvers.quasisep.core import SymmQSM
        from tinygp_tpu_torch.solvers.quasisep.solver import QuasisepSolver

        device = resolve_device(device)
        X = torch.as_tensor(X)
        dtype = X.dtype if X.is_floating_point() else torch.get_default_dtype()
        X = X.to(device=device, dtype=dtype).contiguous()

        mean_function = _as_mean_function(mean).to(device=device, dtype=dtype)
        if mean_value is None:
            mean_value = mean_function(X)
        if mean_value.ndim != 1:
            raise ValueError(
                "the mean must evaluate to one scalar per data point; got "
                f"a {mean_value.ndim}-d tensor"
            )
        noise = _as_noise(noise, diag, mean_value).to(device=device, dtype=dtype)
        kernel = kernel.to(device=device, dtype=dtype)

        if solver is None:
            structured = isinstance(kernel, Quasisep) or isinstance(
                covariance_value, SymmQSM
            )
            solver = QuasisepSolver if structured else DirectSolver
        if solver is DirectSolver:
            # The quasiseparable switches are no-ops on the dense path, so
            # one model function serves both solvers.
            solver_kwargs.pop("assume_sorted", None)
            solver_kwargs.pop("parallel", None)
        elif solver is QuasisepSolver:
            # ... and the dense-only switch is a no-op on the O(N) path.
            solver_kwargs.pop("blocked", None)

        self.num_data = mean_value.shape[0]
        # A float32 posterior's covariance in float64, set by `condition`
        # where it ran the float64 twin: `sample` factors it.
        self._wide_covariance = None
        self.dtype = dtype
        self.device = device
        self.kernel = kernel
        self.X = X
        self.mean_function = mean_function
        self.mean = mean_value
        self.noise = noise
        self.solver = solver(
            kernel, X, noise, covariance=covariance_value, **solver_kwargs
        )

    @property
    def loc(self) -> torch.Tensor:
        """The marginal mean (alias of ``mean``)."""
        return self.mean

    @property
    def variance(self) -> torch.Tensor:
        """Pointwise marginal variance at the input points."""
        return self.solver.variance()

    @property
    def covariance(self) -> torch.Tensor:
        """The dense marginal covariance at the input points."""
        return self.solver.covariance()

    @pinned
    def log_probability(self, y: Any) -> torch.Tensor:
        """The marginal log probability of ``y`` under this process.

        Non-finite results (e.g. from an indefinite covariance) are mapped
        to ``-inf`` so samplers reject rather than propagate NaNs.
        """
        y = as_tensor(y, self.device, self.dtype)
        lp = self.solver.log_likelihood(y - self.loc)
        return pin_backward(torch.where(torch.isfinite(lp), lp, -torch.inf))

    @pinned
    def condition(
        self,
        y: Any,
        X_test: Any | None = None,
        *,
        diag: Any | None = None,
        noise: Noise | None = None,
        include_mean: bool = True,
        kernel: Kernel | None = None,
    ) -> ConditionResult:
        """Condition on data; the posterior process at ``X_test``.

        Args:
            y: The observed values, ``(N,)``.
            X_test: Where to predict; the training points by default. At new
                points the posterior covariance is dense.
            diag / noise: The observation noise of the posterior process.
            include_mean: Include the prior mean in the posterior mean.
            kernel: Another cross-covariance kernel (e.g. one term of a
                sum).

        Returns:
            A :class:`ConditionResult`: the marginal ``log_probability`` of
            ``y`` and the posterior process ``gp``.
        """
        y = as_tensor(y, self.device, self.dtype)
        X_test = self._check_test_points(X_test)
        cross_kernel = self.kernel if kernel is None else kernel
        wide = self._float64_twin()
        kinv_r, log_prob, post_loc = self._condition(y, X_test, include_mean, kernel, wide)
        # The default jitter is the conditioning dtype's, as in the JAX
        # package, whose posterior mean on float32 inputs is float64.
        noise = _as_noise(noise, diag, post_loc if wide is None else _double(post_loc))
        wide_covariance = None
        if wide is None:
            covariance = self.solver.condition(cross_kernel, X_test, noise)
        else:
            wide_covariance = wide.solver.condition(
                wide.kernel if kernel is None else _float64_copy(kernel),
                _double(X_test),
                _float64_copy(noise),
            )
            covariance = _cast(wide_covariance, self.dtype)
        post_mean = means.Conditioned(
            self.X, kinv_r, cross_kernel,
            include_mean=include_mean, mean_function=self.mean_function,
        )
        post = GaussianProcess(
            Conditioned(self.X, self.solver, cross_kernel),
            self.X if X_test is None else X_test,
            noise=noise,
            mean=post_mean,
            mean_value=post_loc,
            covariance_value=covariance,
            device=self.device,
        )
        if X_test is None:
            post._wide_covariance = wide_covariance
        return ConditionResult(pin_backward(log_prob), post)

    @pinned
    def predict(
        self,
        y: Any,
        X_test: Any | None = None,
        *,
        kernel: Kernel | None = None,
        include_mean: bool = True,
        return_var: bool = False,
        return_cov: bool = False,
    ) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
        """The posterior mean at ``X_test`` (and its variance or
        covariance there).

        The mean alone takes the solves and one O(N) product, with no
        posterior covariance: what the JAX package's ``jit`` leaves of this
        call.
        """
        if not (return_var or return_cov):
            y = as_tensor(y, self.device, self.dtype)
            X_test = self._check_test_points(X_test)
            wide = self._float64_twin()
            return pin_backward(self._condition(y, X_test, include_mean, kernel, wide)[2])
        post = self.condition(y, X_test, kernel=kernel, include_mean=include_mean).gp
        spread = post.variance if return_var else post.covariance
        return pin_backward(post.loc), pin_backward(spread)

    @pinned
    def sample(
        self,
        generator: torch.Generator | None = None,
        shape: Sequence[int] | None = None,
    ) -> torch.Tensor:
        """Draw realizations, of shape ``shape + (N,)``: the mean plus the
        factor times white noise drawn from ``generator`` (a generator on
        this process's device; PyTorch's default one if ``None``). A float32
        quasiseparable process, and its posterior at the training points,
        apply the factor in float64 to the float32 draws (C8: in float32 it
        was 9.3e-4 of the largest value off at N = 1e5, and a posterior's
        factor NaN)."""
        eps = torch.randn(
            (self.num_data, *(shape or ())),
            generator=generator,
            dtype=self.dtype,
            device=self.device,
        )
        solver = self._float64_solver()
        if solver is None:
            draw = self.solver.dot_triangular(eps)
        else:
            draw = solver.dot_triangular(eps.double()).to(self.dtype)
        return self.mean + torch.movedim(draw, 0, -1)

    def _float64_solver(self) -> Any | None:
        """The solver whose factor `sample` applies in float64, or None."""
        from tinygp_tpu_torch.solvers.quasisep.solver import QuasisepSolver

        if self._wide_covariance is not None:
            return QuasisepSolver(None, self.X.double(), None, covariance=self._wide_covariance,
                                  parallel=self.solver.parallel)
        wide = self._float64_twin()
        return None if wide is None else wide.solver

    def _whiten(self, y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The whitened residual ``L^-1 (y - mu)`` and the marginal log
        probability, ``-inf`` where it is not finite."""
        white = self.solver.solve_triangular(y - self.loc)
        lp = -0.5 * torch.sum(torch.square(white)) - self.solver.normalization()
        return white, torch.where(torch.isfinite(lp), lp, -torch.inf)

    def _posterior_mean(
        self,
        kinv_r: torch.Tensor,
        y: torch.Tensor,
        X_test: torch.Tensor | None,
        include_mean: bool,
        kernel: Kernel | None,
    ) -> torch.Tensor:
        """``K(X*, X) K^-1 (y - mu) [+ mu(X*)]``, cheapest route first: at
        the training points with the training kernel ``K kinv_r`` is
        ``(y - mu) - noise @ kinv_r``; with another kernel one O(N)
        product; at new points the rectangular product."""
        if X_test is None:
            if kernel is None:
                mu = y - (self.noise @ kinv_r)
                return mu if include_mean else mu - self.loc
            mu = kernel.matmul(self.X, y=kinv_r)
            return mu + self.loc if include_mean else mu
        mu = (self.kernel if kernel is None else kernel).matmul(X_test, self.X, kinv_r)
        if include_mean:
            mu = mu + self.mean_function(X_test)
        return mu

    def _condition(
        self,
        y: torch.Tensor,
        X_test: torch.Tensor | None,
        include_mean: bool,
        kernel: Kernel | None = None,
        wide: GaussianProcess | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(K^-1 (y - mu), log p(y), posterior mean)``; computed by
        ``wide``, this process's float64 twin, where there is one."""
        if wide is not None:
            out = wide._condition(
                y.double(), _double(X_test), include_mean,
                None if kernel is None else _float64_copy(kernel),
            )
            return tuple(x.to(self.dtype) for x in out)
        white, log_prob = self._whiten(y)
        # The second triangular solve makes the whitened residual K^-1 (y - mu).
        kinv_r = self.solver.solve_triangular(white, transpose=True)
        mean = self._posterior_mean(kinv_r, y, X_test, include_mean, kernel)
        return kinv_r, log_prob, mean

    def _float64_twin(self) -> GaussianProcess | None:
        """The process that conditions this one: for a float32
        quasiseparable process, the same model in float64 on the same
        values (see the module docstring); otherwise ``None``, and this
        process conditions itself."""
        from tinygp_tpu_torch.kernels.quasisep import Quasisep
        from tinygp_tpu_torch.solvers.quasisep.solver import QuasisepSolver

        if (
            self.dtype != torch.float32
            or type(self.solver) is not QuasisepSolver
            or not isinstance(self.kernel, Quasisep)
        ):
            return None
        return GaussianProcess(
            _float64_copy(self.kernel),
            self.X.double(),
            noise=_float64_copy(self.noise),
            mean=_float64_copy(self.mean_function),
            mean_value=self.mean.double(),
            device=self.device,
            assume_sorted=True,
            parallel=self.solver.parallel,
        )

    def _check_test_points(self, X_test: Any | None) -> torch.Tensor | None:
        """``X_test`` on this process's device and dtype, with the inputs'
        trailing (per-point) shape."""
        if X_test is None:
            return None
        X_test = as_tensor(X_test, self.device, self.dtype)
        if X_test.ndim != self.X.ndim or X_test.shape[1:] != self.X.shape[1:]:
            raise ValueError(
                "`X_test` must have the same trailing (per-point) shape as "
                "the input `X`"
            )
        return X_test


class ConditionResult(NamedTuple):
    """The result of conditioning a :class:`GaussianProcess` on data."""

    log_probability: torch.Tensor
    """The marginal log likelihood of the observed data."""

    gp: GaussianProcess
    """The conditional process at the test points."""


def _float64_copy(module: nn.Module) -> nn.Module:
    """A copy of ``module`` in float64, ``module`` unchanged."""
    return mapped_module(module, torch.Tensor.double)


def _double(x: torch.Tensor | None) -> torch.Tensor | None:
    return None if x is None else x.double()


def _cast(x: Any, dtype: torch.dtype) -> Any:
    """A tensor, or a quasiseparable matrix part by part, in ``dtype``."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype)
    return x._map_parts(lambda part: _cast(part, dtype))


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
