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

Not ported: the lazy ``Block`` transitions; a :class:`Sum` here builds
dense block-diagonal matrices.
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
    "CARMA",
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
    ``evaluate`` takes bare ``(N,)`` coordinates, without a feature axis.
    """

    _features = False

    def gram(self, X1: torch.Tensor, X2: torch.Tensor) -> torch.Tensor:
        return self.evaluate(X1[:, None], X2[None, :])

    def diag(self, X: torch.Tensor) -> torch.Tensor:
        return self.evaluate_diag(X)

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
        self, X: torch.Tensor, *, X_prev: torch.Tensor | None = None
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(d, ps, qs, as_)`` of ``K(X, X)`` in the scans' stacked layout.

        ``d`` is ``(N,)``, the generators ``ps``/``qs`` are ``(m, N)`` and
        the transitions ``as_`` are ``(m*m, N)`` with row ``i*m+j`` holding
        ``a[i, j]`` of the adjoint ``a = raw^T``. ``X_prev`` overrides the
        previous-point coordinates (a shard's first point takes its left
        neighbour's last); by default the first point pairs with itself,
        so its transition is the identity.
        """
        Pinf = self.stationary_covariance()
        if X_prev is None:
            X_prev = torch.cat([X[:1], X[:-1]])
        raw = self.transition_matrix(X_prev, X)
        m, n = raw.shape[0], raw.shape[-1]
        as_ = raw.transpose(0, 1).reshape(m * m, n)
        h = self._masked_observations(X)
        qs = torch.sum(Pinf[:, :, None] * h[:, None, :], dim=0)
        d = torch.sum(qs * h, dim=0)
        ps = torch.sum(raw * h[None, :, :], dim=1)
        return d, ps, qs, as_

    def _masked_observations(self, X: torch.Tensor) -> torch.Tensor:
        """The observation vectors ``(m, N)``, zero where the sortable
        coordinate is NaN (the JAX package's ``_anchor`` masking)."""
        h = self.observation_model(X)
        return torch.where(torch.isnan(self.coord_to_sortable(X))[None, :], 0.0, h)

    def to_symm_qsm(self, X: torch.Tensor) -> Any:
        """``K(X, X)`` as a :class:`~tinygp_tpu_torch.solvers.quasisep.core.SymmQSM`
        in the row-major layout (``(N, m)`` generators, ``(N, m, m)``
        transitions)."""
        from tinygp_tpu_torch.solvers.quasisep.core import SymmQSM

        return SymmQSM.from_stacked(*self.to_stacked_ssm(X))

    def to_general_qsm(self, X1: torch.Tensor, X2: torch.Tensor) -> Any:
        """``K(X1, X2)`` as a
        :class:`~tinygp_tpu_torch.solvers.quasisep.general.GeneralQSM`;
        ``X2`` must be sorted."""
        from tinygp_tpu_torch.solvers.quasisep.general import GeneralQSM

        t1 = self.coord_to_sortable(X1)
        t2 = self.coord_to_sortable(X2)
        idx = torch.searchsorted(t2, t1, right=True) - 1
        n2 = X2.shape[0]

        X2_prev = torch.cat([X2[:1], X2[:-1]])
        # The adjoint transitions, a[k] = raw_k^T.
        a = self.transition_matrix(X2_prev, X2).permute(2, 1, 0)
        Pinf = self.stationary_covariance()
        h1 = self._masked_observations(X1)
        h2 = self._masked_observations(X2)
        ql = torch.einsum("in,ji->nj", h2, Pinf)
        qu = torch.einsum("in,ij->nj", h1, Pinf)

        # Carry each row's generators from its anchor column (past) and to
        # the next column (future).
        anchor = torch.clamp(idx, 0, n2 - 1)
        past = self.transition_matrix(X2[anchor], X1)
        pl = torch.einsum("in,jin->nj", h1, past)
        anchor = torch.clamp(idx + 1, 0, n2 - 1)
        future = self.transition_matrix(X1, X2[anchor])
        qu = torch.einsum("ni,ijn->nj", qu, future)
        return GeneralQSM(pl=pl, ql=ql, pu=h2.T, qu=qu, a=a, idx=idx)

    def matmul(
        self,
        X1: torch.Tensor,
        X2: torch.Tensor | None = None,
        y: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """``K(X1, X2) @ y`` in O(N) (``K(X1, X1) @ y`` without ``X2``)."""
        if y is None:
            X2, y = None, X2
            if y is None:
                raise TypeError("matmul() needs a right-hand side `y`")
        if X2 is None:
            return self.to_symm_qsm(X1).matmul(y)
        return self.to_general_qsm(X1, X2).matmul(y)

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
        self, X: torch.Tensor, *, X_prev: torch.Tensor | None = None
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """Stacked SSM of a sum, composed from the terms' stacked SSMs.

        Generators concatenate, the diagonal adds, and the ``(m*m, N)``
        transitions interleave each term's rows with zero rows for the
        off-diagonal blocks, row for row as the JAX package composes them.
        """
        d1, ps1, qs1, as1 = self.kernel1.to_stacked_ssm(X, X_prev=X_prev)
        d2, ps2, qs2, as2 = self.kernel2.to_stacked_ssm(X, X_prev=X_prev)
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


def _diag(v: torch.Tensor, offset: int = 0) -> torch.Tensor:
    """The matrices ``(p, p, *s)`` with ``v (p - |offset|, *s)`` on the
    diagonal ``offset``, components first."""
    out = torch.diag_embed(v.movedim(0, -1), offset=offset)
    return out.movedim(-2, 0).movedim(-1, 1)


class CARMA(Quasisep):
    r"""A continuous-time ARMA(p, q) process kernel (Kelly et al. 2014).

    The power spectrum is the ratio of two polynomials in :math:`i\omega`
    with AR coefficients ``alpha`` (length p, excluding the leading 1) and
    MA coefficients ``beta`` (length q+1 <= p, with the amplitude absorbed).
    The autocovariance is a mixture of real and complex exponentials: each
    real root maps to an :class:`Exp`-like state and each conjugate pair to
    a :class:`Celerite`-like 2-state block, selected by real/complex masks
    instead of control flow.

    Stationarity requires all AR roots to have negative real parts; use
    :meth:`from_quads` for an automatically stationary parameterization.

    The roots and the autocovariance are computed when the kernel is
    built, on the device and in the dtype of ``alpha`` and ``beta``, in the
    JAX package's ``(re, im)`` pair arithmetic (:func:`_carma_roots_ri`).
    The observation model gives each conjugate pair its own two celerite
    components at every order; the JAX package's does so at p = 2 only, so
    above that the two packages' kernels differ, and the port's is the
    autocovariance of Kelly et al. (2014, Eq. 4). Where a pair's own
    celerite term is not positive (``a c < b d``) the observation model is
    NaN, in both packages.
    """

    # Fields computed from alpha and beta; convert.kernel_from_tree
    # recomputes them rather than carrying them over.
    _derived = ("sigma", "arroots_re", "arroots_im", "acf_re", "acf_im", "_real_mask",
                "_complex_mask", "_complex_select", "obsmodel")

    def __init__(self, alpha: Any, beta: Any):
        super().__init__()
        alpha = torch.atleast_1d(as_hyper(alpha))
        beta = torch.atleast_1d(as_hyper(beta))
        if alpha.ndim != 1 or beta.ndim != 1 or beta.shape[0] > alpha.shape[0]:
            raise ValueError("CARMA needs 1-d alpha and beta with len(beta) <= len(alpha)")
        dtype = torch.promote_types(alpha.dtype, beta.dtype)
        alpha, beta = alpha.to(dtype), beta.to(device=alpha.device, dtype=dtype)
        sigma = alpha.new_ones(())

        re, im = _carma_roots_ri(torch.cat([alpha, alpha.new_ones(1)]))
        acf_re, acf_im = _carma_acvf_ri(re, im, alpha, beta * sigma)

        # Real roots get a 1-state exponential; each complex-conjugate pair
        # shares a 2-state rotation block. The select mask marks the first
        # member of each pair (where the off-diagonal couplings live).
        real_mask = torch.abs(im) < 10 * torch.finfo(im.dtype).eps
        complex_mask = ~real_mask
        pair_rank = torch.cumsum(complex_mask, 0) * complex_mask
        complex_select = complex_mask * (pair_rank % 2)

        om_real = torch.sqrt(torch.abs(acf_re))
        a, b = 2.0 * acf_re, 2.0 * acf_im
        c, d = -re, -im
        c2, d2 = torch.square(c), torch.square(d)
        s2 = c2 + d2
        denom = torch.where(real_mask, 1.0, 2.0 * c * s2)
        h2_2 = d2 * (a * c - b * d) / denom
        h2 = torch.sqrt(h2_2)
        denom = torch.where(real_mask, 1.0, d)
        h1 = (c * h2 - torch.sqrt(a * d2 - s2 * h2_2)) / denom
        # A conjugate pair takes both celerite components of its first
        # member: h1 there and h2 at the second. (The JAX package takes
        # every other entry of the raveled (h1, h2), which is this at p = 2
        # only; ROADMAP.md, "Found in the reference".)
        obsmodel = torch.where(real_mask, om_real,
                               torch.where(complex_select.bool(), h1, torch.roll(h2, 1)))

        self._hyper(alpha=alpha, beta=beta)
        for name, value in (("sigma", sigma), ("arroots_re", re), ("arroots_im", im),
                            ("acf_re", acf_re), ("acf_im", acf_im), ("_real_mask", real_mask),
                            ("_complex_mask", complex_mask), ("_complex_select", complex_select),
                            ("obsmodel", obsmodel)):
            self.register_buffer(name, value)

    @property
    def arroots(self) -> torch.Tensor:
        """The complex AR roots."""
        return torch.complex(self.arroots_re, self.arroots_im)

    @property
    def acf(self) -> torch.Tensor:
        """The complex ACVF coefficients."""
        return torch.complex(self.acf_re, self.acf_im)

    @classmethod
    def init(cls, alpha: Any, beta: Any) -> CARMA:
        return cls(alpha, beta)

    @classmethod
    def from_quads(cls, alpha_quads: Any, beta_quads: Any, beta_mult: Any) -> CARMA:
        r"""Construct from quadratic factors of the characteristic polynomials.

        Positive quadratic coefficients guarantee negative-real-part roots,
        i.e. a stationary process (Kelly et al. 2014, Eq. 30).

        Args:
            alpha_quads: AR quadratic coefficients, length ``p``.
            beta_quads: MA quadratic coefficients, length ``q``.
            beta_mult: Multiplier for the MA polynomial (the highest-order
                beta).
        """
        alpha_quads = torch.atleast_1d(as_hyper(alpha_quads))
        beta_quads = torch.atleast_1d(as_hyper(beta_quads))
        beta_mult = torch.atleast_1d(as_hyper(beta_mult)).to(beta_quads)
        alpha = carma_quads2poly(torch.cat([alpha_quads, alpha_quads.new_ones(1)]))[:-1]
        beta = carma_quads2poly(torch.cat([beta_quads, beta_mult]))
        return cls(alpha, beta)

    def design_matrix(self) -> torch.Tensor:
        real = torch.diag(self.arroots_re * self._real_mask)
        cplx_diag = torch.diag(self.arroots_re * self._complex_mask)
        cplx_off = torch.diag((self.arroots_im * self._complex_select)[:-1], 1)
        return real + cplx_diag + cplx_off - cplx_off.T

    def stationary_covariance(self) -> torch.Tensor:
        ones = torch.ones_like(self.acf_re)
        sign = torch.diag(torch.where(self.acf_re > 0, ones, -ones))
        denom = torch.where(self._real_mask, 1.0, self.arroots_im)
        ratio = self.arroots_re / denom
        second = torch.diag(
            2.0 * torch.square(ratio * torch.roll(self._complex_select, 1) * self._complex_mask)
        )
        off = torch.diag((-ratio * self._complex_select)[:-1], 1)
        return sign + second + off + off.T

    def observation_model(self, X: torch.Tensor) -> torch.Tensor:
        p = self.obsmodel.shape[0]
        return self.obsmodel.reshape(p, *(1,) * X.ndim).expand(p, *X.shape)

    def transition_matrix(self, X1: torch.Tensor, X2: torch.Tensor) -> torch.Tensor:
        dt = X2 - X1
        shape = (-1, *(1,) * dt.ndim)
        c = -self.arroots_re.reshape(shape)
        d = -self.arroots_im.reshape(shape)
        decay = torch.exp(-c * dt)
        real = _diag(decay * self._real_mask.reshape(shape))
        cplx_diag = _diag(decay * torch.cos(d * dt) * self._complex_mask.reshape(shape))
        cplx_off = _diag((decay * torch.sin(d * dt) * self._complex_select.reshape(shape))[:-1], 1)
        return real + cplx_diag + cplx_off - cplx_off.transpose(0, 1)


# -- complex arithmetic on (re, im) pairs ------------------------------------
# The JAX package writes CARMA's roots and autocovariance on (real, imag)
# pairs of real arrays because its TPU backend lowers no complex primitives.
# The port keeps that arithmetic op for op, so that both packages compute
# the same roots in the same order; carma_roots and carma_acvf return
# complex views.


def _cmul(a, b):
    return a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0]


def _cdiv(a, b):
    d = b[0] * b[0] + b[1] * b[1]
    return (a[0] * b[0] + a[1] * b[1]) / d, (a[1] * b[0] - a[0] * b[1]) / d


def _carma_roots_ri(poly_coeffs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Roots (sorted by real part) of a real polynomial (low-to-high
    coefficients), as (re, im).

    Degrees 1-2 use closed forms; higher degrees run a fixed-iteration
    Durand-Kerner (Weierstrass) solver of 64 steps.
    """
    p = poly_coeffs.shape[0] - 1
    monic = poly_coeffs / poly_coeffs[-1]

    if p == 1:
        re, im = -monic[:1], monic.new_zeros(1)
    elif p == 2:
        b, c = monic[1], monic[0]
        disc = b * b - 4.0 * c
        sq = torch.sqrt(torch.abs(disc))
        is_real = disc >= 0
        re = torch.where(is_real, torch.stack([(-b - sq), (-b + sq)]) / 2.0,
                         torch.stack([-b, -b]) / 2.0)
        im = torch.where(is_real, monic.new_zeros(2), torch.stack([-sq, sq]) / 2.0)
    else:
        # Staggered ring start (radius > root bound, irrational-ish angles
        # so no start point is real or a symmetry fixed point).
        radius = 1.0 + torch.max(torch.abs(monic[:-1]))
        ang = 2.0 * math.pi * (torch.arange(p, dtype=monic.dtype, device=monic.device)
                               + 0.25) / p + 0.7
        z = (radius * torch.cos(ang), radius * torch.sin(ang))
        coef = monic.flip(0)  # high-to-low for Horner
        eye = torch.eye(p, dtype=torch.bool, device=monic.device)

        def poly(z):
            acc = (coef[0].expand(p), monic.new_zeros(p))
            for c in coef[1:]:
                acc = _cmul(acc, z)
                acc = (acc[0] + c, acc[1])
            return acc

        for _ in range(64):
            dr = z[0][:, None] - z[0][None, :]
            di = z[1][:, None] - z[1][None, :]
            dr = torch.where(eye, 1.0, dr)
            di = torch.where(eye, 0.0, di)
            denom = (monic.new_ones(p), monic.new_zeros(p))
            for j in range(p):
                denom = _cmul(denom, (dr[:, j], di[:, j]))
            upd = _cdiv(poly(z), denom)
            z = (z[0] - upd[0], z[1] - upd[1])
        re, im = z

    order = torch.argsort(re, stable=True)
    return re[order], im[order]


def carma_roots(poly_coeffs: Any) -> torch.Tensor:
    """Sorted complex roots of a real polynomial (low-to-high
    coefficients)."""
    re, im = _carma_roots_ri(as_hyper(poly_coeffs))
    return torch.complex(re, im)


def _convolve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The full discrete convolution of two 1-d tensors (``np.convolve``)."""
    lb = b.shape[0]
    return sum(torch.nn.functional.pad(a * b[j], (j, lb - 1 - j)) for j in range(lb))


def carma_quads2poly(quads_coeffs: Any) -> torch.Tensor:
    """Expand quadratic factors into a full polynomial (low-to-high).

    The last input entry is the multiplier (the highest-order output
    coefficient).
    """
    quads_coeffs = as_hyper(quads_coeffs)
    size = quads_coeffs.shape[0] - 1
    mult = quads_coeffs[-1:]
    one = quads_coeffs.new_ones(1)
    poly = torch.cat([one, quads_coeffs[-2:-1]]) if size % 2 == 1 else one
    for k in range(size // 2):
        quad = torch.cat([quads_coeffs[2 * k : 2 * k + 2], one])
        poly = _convolve(poly, quad.flip(0))
    return poly.flip(0) * mult


def carma_poly2quads(poly_coeffs: Any) -> torch.Tensor:
    """Factor a polynomial (low-to-high) into quadratic coefficients, on
    the host: which roots are complex decides the factors."""
    poly_coeffs = as_hyper(poly_coeffs)
    mult = poly_coeffs[-1]
    roots = carma_roots(poly_coeffs / mult)
    odd = bool(len(roots) & 1)
    roots_c = roots[roots.imag != 0]
    roots_r = roots[roots.imag == 0]

    # Pairs (i, i + 1), as the JAX package takes them.
    quads = []
    for i in range(len(roots_c) // 2):
        r1, r2 = roots_c[i], roots_c[i + 1]
        quads.extend([(r1 * r2).real, -(r1.real + r2.real)])
    for i in range(len(roots_r) // 2):
        r1, r2 = roots_r[i], roots_r[i + 1]
        quads.extend([(r1 * r2).real, -(r1.real + r2.real)])
    if odd:
        quads.append(-roots_r[-1].real)
    return torch.stack([*quads, mult])


def _carma_acvf_ri(
    roots_re: torch.Tensor,
    roots_im: torch.Tensor,
    arparam: torch.Tensor,
    maparam: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    r"""Autocovariance coefficients (Kelly+14 Eq. 4), in (re, im) pairs."""
    arparam = torch.atleast_1d(arparam)
    maparam = torch.atleast_1d(maparam)

    p = arparam.shape[0]
    q = maparam.shape[0] - 1
    sigma = maparam[0]
    maparam = maparam / sigma

    z = (roots_re, roots_im)
    zneg = (-roots_re, -roots_im)
    zero = roots_re.new_zeros(p)
    num_left = (zero, zero)
    num_right = (zero, zero)
    pow_l = (roots_re.new_ones(p), zero)
    pow_r = (roots_re.new_ones(p), zero)
    for k in range(q + 1):
        num_left = (num_left[0] + maparam[k] * pow_l[0], num_left[1] + maparam[k] * pow_l[1])
        num_right = (num_right[0] + maparam[k] * pow_r[0], num_right[1] + maparam[k] * pow_r[1])
        if k < q:
            pow_l = _cmul(pow_l, z)
            pow_r = _cmul(pow_r, zneg)

    denom = (-2.0 * roots_re, zero)
    idx = torch.arange(p, device=roots_re.device)
    for j in range(1, p):
        sh = torch.roll(idx, j)
        shifted = (roots_re[sh], roots_im[sh])
        denom = _cmul(denom, (shifted[0] - roots_re, shifted[1] - roots_im))
        # conj(shifted) + z
        denom = _cmul(denom, (shifted[0] + roots_re, roots_im - shifted[1]))

    out = _cdiv(_cmul(num_left, num_right), denom)
    return sigma**2 * out[0], sigma**2 * out[1]


def carma_acvf(arroots: Any, arparam: Any, maparam: Any) -> torch.Tensor:
    r"""Autocovariance coefficients, one per AR root (Kelly+14 Eq. 4)."""
    arroots = as_hyper(arroots)
    re, im = _carma_acvf_ri(arroots.real, arroots.imag, as_hyper(arparam), as_hyper(maparam))
    return torch.complex(re, im)
