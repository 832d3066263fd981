"""Scalable state-space (quasiseparable) kernels.

Counterpart of ``tinygp_tpu/kernels/quasisep.py``. A kernel is a linear
stochastic differential equation given by four ingredients:

- ``design_matrix``   F : the SDE drift, ``(m, m)``;
- ``stationary_covariance`` Pinf : the state's stationary covariance,
  ``(m, m)``;
- ``observation_model`` h(X) : the projection from state to observation;
- ``transition_matrix``(X1, X2) : the adjoint propagator
  ``expm(F^T (X2 - X1))``.

Where the JAX package writes each method for one point and lifts it with
``vmap``, the port writes it once over a trailing data axis: for
coordinates of shape ``s``, ``observation_model`` returns ``(m, *s)`` and
``transition_matrix`` returns ``(m, m, *s)``, the components-first layout
that :meth:`Quasisep.to_stacked_ssm` hands to the scans.

Not ported yet: ``CARMA`` (ROADMAP item N5) and the lazy ``Block``
transitions; a :class:`Sum` here builds dense block-diagonal matrices.
"""

from __future__ import annotations

__all__ = [
    "Quasisep",
    "Wrapper",
    "Sum",
    "Product",
    "Scale",
    "Celerite",
    "SHO",
    "Exp",
    "Matern32",
    "Matern52",
    "Cosine",
]

import math
from collections.abc import Sequence
from typing import Any

import torch

from tinygp_tpu_torch.helpers import as_hyper
from tinygp_tpu_torch.kernels.base import Kernel


def _mat(rows: Sequence[Sequence[Any]], ref: torch.Tensor) -> torch.Tensor:
    """Stack scalar or tensor entries into ``(len(rows), len(rows[0]),
    *shape)``, broadcasting every entry to one common shape."""
    entries = [
        torch.as_tensor(e, dtype=ref.dtype, device=ref.device)
        for row in rows
        for e in row
    ]
    shape = torch.broadcast_shapes(*(e.shape for e in entries))
    out = torch.stack([e.expand(shape) for e in entries])
    return out.reshape(len(rows), len(rows[0]), *shape)


def _vec(entries: Sequence[Any], X: torch.Tensor) -> torch.Tensor:
    """A constant observation vector broadcast to ``(m, *X.shape)``."""
    h = _mat([[e] for e in entries], X)[:, 0]
    return h.reshape(len(entries), *(1,) * X.ndim).expand(-1, *X.shape)


def _block_diag(m1: torch.Tensor, m2: torch.Tensor) -> torch.Tensor:
    """Dense block diagonal of ``(m1, m1, *s)`` and ``(m2, m2, *s)``."""
    shape = torch.broadcast_shapes(m1.shape[2:], m2.shape[2:])
    n1, n2 = m1.shape[0], m2.shape[0]
    top = torch.cat(
        [m1.expand(n1, n1, *shape), m1.new_zeros(n1, n2, *shape)], dim=1
    )
    bottom = torch.cat(
        [m2.new_zeros(n2, n1, *shape), m2.expand(n2, n2, *shape)], dim=1
    )
    return torch.cat([top, bottom], dim=0)


def _kron(m1: torch.Tensor, m2: torch.Tensor, ndim: int) -> torch.Tensor:
    """Kronecker product over the leading ``ndim`` (1 or 2) axes."""
    n1, n2 = m1.shape[0], m2.shape[0]
    if ndim == 1:
        out = m1[:, None] * m2[None, :]
        return out.reshape(n1 * n2, *out.shape[2:])
    out = m1[:, None, :, None] * m2[None, :, None, :]
    return out.reshape(n1 * n2, n1 * n2, *out.shape[4:])


class Quasisep(Kernel):
    """Base class of the quasiseparable kernels.

    Subclasses implement the state-space quadruple of the module docstring;
    the stacked operands and pointwise evaluation derive from it here.
    """

    def _hyper(self, **values: Any) -> None:
        for name, value in values.items():
            self.register_buffer(name, as_hyper(value))

    def design_matrix(self) -> torch.Tensor:
        """The SDE design (drift) matrix F."""
        raise NotImplementedError("the SSM quadruple requires design_matrix")

    def stationary_covariance(self) -> torch.Tensor:
        """The stationary state covariance Pinf."""
        raise NotImplementedError(
            "the SSM quadruple requires stationary_covariance"
        )

    def observation_model(self, X: torch.Tensor) -> torch.Tensor:
        """The observation vectors h, ``(m, *X.shape)``."""
        raise NotImplementedError(
            "the SSM quadruple requires observation_model"
        )

    def transition_matrix(
        self, X1: torch.Tensor, X2: torch.Tensor
    ) -> torch.Tensor:
        """The adjoint propagators from ``X1`` to ``X2``, ``(m, m, *s)``."""
        raise NotImplementedError(
            "the SSM quadruple requires transition_matrix"
        )

    def coord_to_sortable(self, X: torch.Tensor) -> torch.Tensor:
        """Map a coordinate to a sortable scalar."""
        return X

    def to_stacked_ssm(
        self, X: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(d, ps, qs, as_)`` of ``K(X, X)`` in the scans' stacked layout.

        ``d`` is ``(N,)``, the generators ``ps``/``qs`` are ``(m, N)`` and
        the transitions ``as_`` are ``(m*m, N)`` with row ``i*m+j`` holding
        ``a[i, j]`` of the adjoint ``a = raw^T``. The first point pairs
        with itself, so its transition is the identity.
        """
        Pinf = self.stationary_covariance()
        X_prev = torch.cat([X[:1], X[:-1]])
        raw = self.transition_matrix(X_prev, X)
        m, n = raw.shape[0], raw.shape[-1]
        as_ = raw.transpose(0, 1).reshape(m * m, n)
        t = self.coord_to_sortable(X)
        h = self.observation_model(X)
        h = torch.where(torch.isnan(t)[None, :], 0.0, h)
        qs = torch.sum(Pinf[:, :, None] * h[:, None, :], dim=0)
        d = torch.sum(qs * h, dim=0)
        ps = torch.sum(raw * h[None, :, :], dim=1)
        return d, ps, qs, as_

    # -- algebra (closed within the quasisep family) ------------------------
    def __add__(self, other: Any) -> Kernel:
        return Sum(self, _quasisep_only(other))

    def __radd__(self, other: Any) -> Kernel:
        # builtin sum() seeds its accumulator with the int 0; fold it away.
        if isinstance(other, int | float) and other == 0:
            return self
        return Sum(_quasisep_only(other), self)

    def __mul__(self, other: Any) -> Kernel:
        if isinstance(other, Quasisep):
            return Product(self, other)
        return Scale(self, _scalar_only(other))

    def __rmul__(self, other: Any) -> Kernel:
        if isinstance(other, Quasisep):
            return Product(other, self)
        return Scale(self, _scalar_only(other))

    def evaluate(self, X1: torch.Tensor, X2: torch.Tensor) -> torch.Tensor:
        """Pointwise evaluation through the state-space representation.

        Branches on time order, so non-reversible processes are handled.
        """
        Pinf = self.stationary_covariance()
        h1 = self.observation_model(X1)
        h2 = self.observation_model(X2)
        t1 = self.coord_to_sortable(X1)
        t2 = self.coord_to_sortable(X2)

        def form(ha, hb, trans):
            v = torch.einsum("ij...,j...->i...", trans, ha)
            return torch.einsum("i...,ik,k...->...", v, Pinf, hb)

        fwd = form(h2, h1, self.transition_matrix(X1, X2))
        bwd = form(h1, h2, self.transition_matrix(X2, X1))
        return torch.where(t1 < t2, fwd, bwd)

    def evaluate_diag(self, X: torch.Tensor) -> torch.Tensor:
        h = self.observation_model(X)
        Pinf = self.stationary_covariance()
        return torch.einsum("i...,ik,k...->...", h, Pinf, h)


def _quasisep_only(other: Any) -> Quasisep:
    if not isinstance(other, Quasisep):
        raise ValueError(
            "adding a non-quasiseparable term would lose the O(N) "
            "structure; build a dense kernel instead"
        )
    return other


def _scalar_only(other: Any) -> Any:
    if isinstance(other, Kernel) or torch.as_tensor(other).ndim != 0:
        raise ValueError(
            "Quasisep kernels can only be multiplied by scalars and "
            "other Quasisep kernels"
        )
    return other


class Wrapper(Quasisep):
    """Base class of kernels that delegate to a wrapped quasisep kernel."""

    def __init__(self, kernel: Quasisep):
        super().__init__()
        self.kernel = kernel

    def coord_to_sortable(self, X: torch.Tensor) -> torch.Tensor:
        return self.kernel.coord_to_sortable(X)

    def design_matrix(self) -> torch.Tensor:
        return self.kernel.design_matrix()

    def stationary_covariance(self) -> torch.Tensor:
        return self.kernel.stationary_covariance()

    def observation_model(self, X: torch.Tensor) -> torch.Tensor:
        return self.kernel.observation_model(self.coord_to_sortable(X))

    def transition_matrix(
        self, X1: torch.Tensor, X2: torch.Tensor
    ) -> torch.Tensor:
        return self.kernel.transition_matrix(
            self.coord_to_sortable(X1), self.coord_to_sortable(X2)
        )


class _Pair(Quasisep):
    """Shared structure of the binary combinations; ``kernel1`` is the
    authority for the sortable coordinate."""

    def __init__(self, kernel1: Quasisep, kernel2: Quasisep):
        super().__init__()
        self.kernel1 = kernel1
        self.kernel2 = kernel2

    def coord_to_sortable(self, X: torch.Tensor) -> torch.Tensor:
        return self.kernel1.coord_to_sortable(X)

    def _both(self, method: str, *args: Any) -> tuple[Any, Any]:
        return (
            getattr(self.kernel1, method)(*args),
            getattr(self.kernel2, method)(*args),
        )


class Sum(_Pair):
    """The sum of two quasisep kernels: states concatenate block-diagonally
    (densely: the port has no lazy ``Block``)."""

    def design_matrix(self) -> torch.Tensor:
        return _block_diag(*self._both("design_matrix"))

    def stationary_covariance(self) -> torch.Tensor:
        return _block_diag(*self._both("stationary_covariance"))

    def observation_model(self, X: torch.Tensor) -> torch.Tensor:
        return torch.cat(self._both("observation_model", X), dim=0)

    def transition_matrix(
        self, X1: torch.Tensor, X2: torch.Tensor
    ) -> torch.Tensor:
        return _block_diag(*self._both("transition_matrix", X1, X2))

    def to_stacked_ssm(
        self, X: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """Stacked SSM of a sum, composed from the terms' stacked SSMs.

        Generators concatenate, the diagonal adds, and the ``(m*m, N)``
        transitions interleave each term's rows with zero rows for the
        off-diagonal blocks, row for row as the JAX package composes them.
        """
        d1, ps1, qs1, as1 = self.kernel1.to_stacked_ssm(X)
        d2, ps2, qs2, as2 = self.kernel2.to_stacked_ssm(X)
        m1, m2 = ps1.shape[0], ps2.shape[0]
        n = d1.shape[-1]
        dtype = torch.promote_types(as1.dtype, as2.dtype)
        z1 = as1.new_zeros((m2, n), dtype=dtype)
        z2 = as1.new_zeros((m1, n), dtype=dtype)
        rows = []
        for i in range(m1):
            rows += [as1[i * m1 : (i + 1) * m1].to(dtype), z1]
        for i in range(m2):
            rows += [z2, as2[i * m2 : (i + 1) * m2].to(dtype)]
        return (
            d1 + d2,
            torch.cat([ps1, ps2], dim=0),
            torch.cat([qs1, qs2], dim=0),
            torch.cat(rows, dim=0),
        )


class Product(_Pair):
    """The product of two quasisep kernels: states combine as Kroneckers."""

    def design_matrix(self) -> torch.Tensor:
        F1, F2 = self._both("design_matrix")
        eye1 = torch.eye(F1.shape[0], dtype=F1.dtype, device=F1.device)
        eye2 = torch.eye(F2.shape[0], dtype=F2.dtype, device=F2.device)
        return _kron(F1, eye2, 2) + _kron(eye1, F2, 2)

    def stationary_covariance(self) -> torch.Tensor:
        return _kron(*self._both("stationary_covariance"), 2)

    def observation_model(self, X: torch.Tensor) -> torch.Tensor:
        return _kron(*self._both("observation_model", X), 1)

    def transition_matrix(
        self, X1: torch.Tensor, X2: torch.Tensor
    ) -> torch.Tensor:
        return _kron(*self._both("transition_matrix", X1, X2), 2)


class Scale(Wrapper):
    """A scalar multiple of a quasisep kernel (scales Pinf).

    The stacked operands come from the base route with the scaled Pinf for
    every operand, a :class:`Sum` included, since the port's Pinf is always
    dense (the JAX package pushes the scale into a lazily block-diagonal
    operand instead).
    """

    def __init__(self, kernel: Quasisep, scale: Any):
        super().__init__(kernel)
        self._hyper(scale=scale)

    def stationary_covariance(self) -> torch.Tensor:
        return self.scale * self.kernel.stationary_covariance()


class Celerite(Quasisep):
    r"""The celerite term :math:`k(\tau) = e^{-c\tau}[a\cos(d\tau) +
    b\sin(d\tau)]`; positive definite when ``a*c - b*d > 0``."""

    def __init__(self, a: Any, b: Any, c: Any, d: Any):
        super().__init__()
        self._hyper(a=a, b=b, c=c, d=d)

    def design_matrix(self) -> torch.Tensor:
        return _mat([[-self.c, -self.d], [self.d, -self.c]], self.c)

    def stationary_covariance(self) -> torch.Tensor:
        ratio = self.c / self.d
        return _mat(
            [[1.0, -ratio], [-ratio, 1.0 + 2.0 * torch.square(ratio)]], ratio
        )

    def observation_model(self, X: torch.Tensor) -> torch.Tensor:
        # The observation vector whose induced kernel matches the
        # (a, b, c, d) parameterization against this Pinf.
        a, b, c, d = self.a, self.b, self.c, self.d
        c2 = torch.square(c)
        d2 = torch.square(d)
        s2 = c2 + d2
        h2_2 = d2 * (a * c - b * d) / (2.0 * c * s2)
        h2 = torch.sqrt(h2_2)
        h1 = (c * h2 - torch.sqrt(a * d2 - s2 * h2_2)) / d
        return _vec([h1, h2], X)

    def transition_matrix(
        self, X1: torch.Tensor, X2: torch.Tensor
    ) -> torch.Tensor:
        dt = X2 - X1
        cos = torch.cos(self.d * dt)
        sin = torch.sin(self.d * dt)
        return torch.exp(-self.c * dt) * _mat([[cos, sin], [-sin, cos]], dt)


class SHO(Quasisep):
    r"""The stochastically driven damped simple harmonic oscillator.

    .. math::

        k(\tau) = \sigma^2 \exp(-\omega\tau/2Q) \times
        \begin{cases}
          1 + \omega\tau & Q = 1/2 \\
          \cosh(f\omega\tau/2Q) + \sinh(f\omega\tau/2Q)/f & Q < 1/2 \\
          \cos(g\omega\tau/2Q) + \sin(g\omega\tau/2Q)/g   & Q > 1/2
        \end{cases}

    with :math:`f = \sqrt{1-4Q^2}`, :math:`g = \sqrt{4Q^2-1}`. The
    propagator is branch-free: both damped regimes are evaluated with
    guarded operands and picked with ``where``, so the unselected branch
    stays finite at the critical point.
    """

    _CRITICAL_TOL = 1e-5

    def __init__(self, omega: Any, quality: Any, sigma: Any = 1.0):
        super().__init__()
        self._hyper(omega=omega, quality=quality, sigma=sigma)

    def design_matrix(self) -> torch.Tensor:
        w, q = self.omega, self.quality
        return _mat([[0.0, 1.0], [-torch.square(w), -w / q]], w)

    def stationary_covariance(self) -> torch.Tensor:
        w = self.omega
        return _mat([[1.0, 0.0], [0.0, torch.square(w)]], w)

    def observation_model(self, X: torch.Tensor) -> torch.Tensor:
        return _vec([self.sigma, 0.0], X)

    def transition_matrix(
        self, X1: torch.Tensor, X2: torch.Tensor
    ) -> torch.Tensor:
        dt = X2 - X1
        w = self.omega
        q = self.quality
        disc = 4.0 * torch.square(q) - 1.0
        near_critical = torch.abs(disc) < self._CRITICAL_TOL

        # Critical damping: polynomial-times-exponential propagator.
        crit = torch.exp(-w * dt) * _mat(
            [[1.0 + w * dt, -torch.square(w) * dt], [dt, 1.0 - w * dt]], dt
        )

        # Oscillatory and overdamped regimes share one algebraic shape with
        # (sin, cos) <-> (sinh, cosh); the sqrt and divisions are guarded
        # so the unselected branch stays finite.
        safe = torch.clamp(torch.abs(disc), min=self._CRITICAL_TOL)
        f = torch.sqrt(safe)
        arg = 0.5 * f * w * dt / q
        damp = torch.exp(-0.5 * w * dt / q)

        def regime(s, c):
            return damp * _mat(
                [
                    [c + s / f, -2.0 * q * w * s / f],
                    [2.0 * q * s / (w * f), c - s / f],
                ],
                dt,
            )

        under = regime(torch.sin(arg), torch.cos(arg))
        over = regime(torch.sinh(arg), torch.cosh(arg))
        out = torch.where(disc > 0.0, under, over)
        return torch.where(near_critical, crit, out)


class Exp(Quasisep):
    r"""The exponential kernel :math:`k(\tau)=\sigma^2\exp(-\tau/\ell)`."""

    def __init__(self, scale: Any, sigma: Any = 1.0):
        super().__init__()
        self._hyper(scale=scale, sigma=sigma)

    def design_matrix(self) -> torch.Tensor:
        return _mat([[-1.0 / self.scale]], self.scale)

    def stationary_covariance(self) -> torch.Tensor:
        return _mat([[1.0]], self.scale)

    def observation_model(self, X: torch.Tensor) -> torch.Tensor:
        return _vec([self.sigma], X)

    def transition_matrix(
        self, X1: torch.Tensor, X2: torch.Tensor
    ) -> torch.Tensor:
        dt = X2 - X1
        return torch.exp(-dt / self.scale)[None, None]


class Matern32(Quasisep):
    r"""Matern-3/2: :math:`k(\tau)=\sigma^2(1+f\tau)\exp(-f\tau)`,
    :math:`f=\sqrt{3}/\ell`."""

    def __init__(self, scale: Any, sigma: Any = 1.0):
        super().__init__()
        self._hyper(scale=scale, sigma=sigma)

    def design_matrix(self) -> torch.Tensor:
        f = math.sqrt(3.0) / self.scale
        return _mat([[0.0, 1.0], [-torch.square(f), -2.0 * f]], f)

    def stationary_covariance(self) -> torch.Tensor:
        return _mat(
            [[1.0, 0.0], [0.0, 3.0 / torch.square(self.scale)]], self.scale
        )

    def observation_model(self, X: torch.Tensor) -> torch.Tensor:
        return _vec([self.sigma, 0.0], X)

    def transition_matrix(
        self, X1: torch.Tensor, X2: torch.Tensor
    ) -> torch.Tensor:
        dt = X2 - X1
        f = math.sqrt(3.0) / self.scale
        return torch.exp(-f * dt) * _mat(
            [[1.0 + f * dt, -torch.square(f) * dt], [dt, 1.0 - f * dt]], dt
        )


class Matern52(Quasisep):
    r"""Matern-5/2: :math:`k(\tau)=\sigma^2(1+f\tau+f^2\tau^2/3)
    \exp(-f\tau)`, :math:`f=\sqrt{5}/\ell`."""

    def __init__(self, scale: Any, sigma: Any = 1.0):
        super().__init__()
        self._hyper(scale=scale, sigma=sigma)

    def design_matrix(self) -> torch.Tensor:
        f = math.sqrt(5.0) / self.scale
        f2 = torch.square(f)
        return _mat(
            [[0.0, 1.0, 0.0], [0.0, 0.0, 1.0], [-f2 * f, -3.0 * f2, -3.0 * f]],
            f,
        )

    def stationary_covariance(self) -> torch.Tensor:
        f = math.sqrt(5.0) / self.scale
        f2 = torch.square(f)
        f2o3 = f2 / 3.0
        return _mat(
            [
                [1.0, 0.0, -f2o3],
                [0.0, f2o3, 0.0],
                [-f2o3, 0.0, torch.square(f2)],
            ],
            f,
        )

    def observation_model(self, X: torch.Tensor) -> torch.Tensor:
        return _vec([self.sigma, 0.0, 0.0], X)

    def transition_matrix(
        self, X1: torch.Tensor, X2: torch.Tensor
    ) -> torch.Tensor:
        dt = X2 - X1
        f = math.sqrt(5.0) / self.scale
        f2 = torch.square(f)
        d2 = torch.square(dt)
        return torch.exp(-f * dt) * _mat(
            [
                [
                    0.5 * f2 * d2 + f * dt + 1.0,
                    -0.5 * f * f2 * d2,
                    0.5 * f2 * f * dt * (f * dt - 2.0),
                ],
                [
                    dt * (f * dt + 1.0),
                    -f2 * d2 + f * dt + 1.0,
                    f2 * dt * (f * dt - 3.0),
                ],
                [
                    0.5 * d2,
                    0.5 * dt * (2.0 - f * dt),
                    0.5 * f2 * d2 - 2.0 * f * dt + 1.0,
                ],
            ],
            dt,
        )


class Cosine(Quasisep):
    r"""The cosine kernel :math:`k(\tau)=\sigma^2\cos(2\pi\tau/\ell)`."""

    def __init__(self, scale: Any, sigma: Any = 1.0):
        super().__init__()
        self._hyper(scale=scale, sigma=sigma)

    def design_matrix(self) -> torch.Tensor:
        f = 2.0 * math.pi / self.scale
        return _mat([[0.0, -f], [f, 0.0]], f)

    def stationary_covariance(self) -> torch.Tensor:
        return torch.eye(2, dtype=self.scale.dtype, device=self.scale.device)

    def observation_model(self, X: torch.Tensor) -> torch.Tensor:
        return _vec([self.sigma, 0.0], X)

    def transition_matrix(
        self, X1: torch.Tensor, X2: torch.Tensor
    ) -> torch.Tensor:
        dt = X2 - X1
        f = 2.0 * math.pi / self.scale
        cos = torch.cos(f * dt)
        sin = torch.sin(f * dt)
        return _mat([[cos, sin], [-sin, cos]], dt)
