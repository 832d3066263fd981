"""The quasiseparable matrix classes.

Counterpart of ``tinygp_tpu/solvers/quasisep/core.py``, with the same
field layout: per row k, generators ``p_k``, ``q_k`` of shape ``(N, m)``
and transitions ``a_k`` of shape ``(N, m, m)``, so that an order-m matrix
reads::

    M[i, j] = p_i^T (a_{i-1} @ ... @ a_{j+1}) q_j        (i > j)
    M[i, i] = d_i
    M[i, j] = q_i^T (a_{i+1}^T @ ... @ a_{j-1}^T) p_j    (i < j)

The classes are frozen dataclasses of tensors with the operator sugar of
the JAX package (``+``, ``-``, ``*``, ``@``, ``.T``, ``to_dense``). Every
O(N) algorithm goes through :mod:`tinygp_tpu_torch.solvers.quasisep.ops`
and takes a ``parallel`` flag: the monoid scan (kernel B3 on the card) or
the sequential oracle. Where the JAX package defaults to the sequential
oracle, the port defaults to ``parallel=True``, which runs on the card.

The port has no lazy ``Block`` transitions (a ``Sum`` kernel's transitions
are dense), so the JAX package's ``block.py`` and its ``ensure_dense``
have nothing to do here and are not ported.
"""

from __future__ import annotations

__all__ = [
    "QSM",
    "DiagQSM",
    "StrictLowerTriQSM",
    "StrictUpperTriQSM",
    "LowerTriQSM",
    "UpperTriQSM",
    "SquareQSM",
    "SymmQSM",
]

import dataclasses
import functools
from typing import Any

import torch


def _ops():
    """The O(N) algorithms, imported late: ``ops`` builds on these classes."""
    from tinygp_tpu_torch.solvers.quasisep import ops

    return ops


def _matvec_shape(matmul):
    """Run on a 2-d right-hand side and restore the caller's shape."""

    @functools.wraps(matmul)
    def wrapped(self: Any, x: torch.Tensor, **kwargs: Any) -> torch.Tensor:
        shape = x.shape
        return matmul(self, x.reshape(shape[0], -1), **kwargs).reshape(shape)

    return wrapped


class QSM:
    """Operator sugar shared by the square quasiseparable classes."""

    def transpose(self) -> QSM:
        raise NotImplementedError("each QSM class defines its transpose")

    @property
    def T(self) -> QSM:
        """The transpose."""
        return self.transpose()

    def _terms(self) -> tuple[QSM, ...]:
        """The parts whose matvecs sum to this matrix's (composites only)."""
        raise NotImplementedError

    def _map_parts(self, f: Any) -> QSM:
        """This matrix with ``f`` applied to each stored part."""
        return type(self)(
            **{fl.name: f(getattr(self, fl.name)) for fl in dataclasses.fields(self)}
        )

    def _leaves(self) -> list[torch.Tensor]:
        out = []
        for fl in dataclasses.fields(self):
            value = getattr(self, fl.name)
            out += value._leaves() if isinstance(value, QSM) else [value]
        return out

    @_matvec_shape
    def matmul(self, x: torch.Tensor, *, parallel: bool = True) -> torch.Tensor:
        """The product ``self @ x`` with a tensor of leading dimension N."""
        out = None
        for term in self._terms():
            y = term.matmul(x, parallel=parallel)
            out = y if out is None else out + y
        return out

    def scale(self, other: Any) -> QSM:
        """A scalar multiple of this matrix."""
        return self._map_parts(lambda part: part.scale(other))

    def __neg__(self) -> QSM:
        return self._map_parts(lambda part: -part)

    def to_dense(self) -> torch.Tensor:
        """The dense matrix (for tests: O(N^2) memory)."""
        leaf = self._leaves()[0]
        n = leaf.shape[0]
        return self.matmul(torch.eye(n, dtype=leaf.dtype, device=leaf.device))

    @property
    def dtype(self) -> torch.dtype:
        return self._leaves()[0].dtype

    @property
    def device(self) -> torch.device:
        return self._leaves()[0].device

    @property
    def shape(self) -> tuple[int, int]:
        n = self._leaves()[0].shape[0]
        return (n, n)

    def _check_scale_operand(self, other: Any) -> Any:
        if torch.as_tensor(other).ndim != 0:
            raise ValueError("a QSM can be scaled by a scalar only")
        return other

    def __add__(self, other: Any) -> Any:
        return _ops().elementwise_add(self, other)

    def __sub__(self, other: Any) -> Any:
        return _ops().elementwise_add(self, -other)

    def __mul__(self, other: Any) -> Any:
        if isinstance(other, QSM):
            return _ops().elementwise_mul(self, other)
        return self.scale(self._check_scale_operand(other))

    def __rmul__(self, other: Any) -> Any:
        return self.scale(self._check_scale_operand(other))

    def __matmul__(self, other: Any) -> Any:
        if isinstance(other, QSM):
            return _ops().qsm_mul(self, other)
        return self.matmul(other)

    def __rmatmul__(self, other: Any) -> Any:
        # x @ M == (M^T @ x^T)^T, and a QSM's transpose is free.
        if other.ndim == 1:
            return self.T @ other
        return (self.T @ other.T).T


def _block_diag_rows(a1: torch.Tensor, a2: torch.Tensor) -> torch.Tensor:
    """Per-row block diagonal of ``(N, m1, m1)`` and ``(N, m2, m2)``."""
    n, m1, m2 = a1.shape[0], a1.shape[1], a2.shape[1]
    top = torch.cat([a1, a1.new_zeros(n, m1, m2)], dim=2)
    bottom = torch.cat([a2.new_zeros(n, m2, m1), a2], dim=2)
    return torch.cat([top, bottom], dim=1)


@dataclasses.dataclass(frozen=True, eq=False)
class DiagQSM(QSM):
    """A diagonal matrix: order-0 quasiseparable.

    Args:
        d: The ``(N,)`` diagonal.
    """

    d: torch.Tensor

    def transpose(self) -> DiagQSM:
        return self

    @_matvec_shape
    def matmul(self, x: torch.Tensor, *, parallel: bool = True) -> torch.Tensor:
        del parallel  # no scan
        return x * self.d[:, None]

    def scale(self, other: Any) -> DiagQSM:
        return DiagQSM(d=self.d * other)

    def self_add(self, other: DiagQSM) -> DiagQSM:
        return DiagQSM(d=self.d + other.d)

    def self_mul(self, other: DiagQSM) -> DiagQSM:
        return DiagQSM(d=self.d * other.d)

    def __neg__(self) -> DiagQSM:
        return DiagQSM(d=-self.d)


@dataclasses.dataclass(frozen=True, eq=False)
class StrictLowerTriQSM(QSM):
    """A strictly lower triangular quasiseparable matrix.

    Args:
        p: Left (row) generators, ``(N, m)``.
        q: Right (column) generators, ``(N, m)``.
        a: Transitions, ``(N, m, m)``.
    """

    p: torch.Tensor
    q: torch.Tensor
    a: torch.Tensor

    def transpose(self) -> StrictUpperTriQSM:
        return StrictUpperTriQSM(p=self.p, q=self.q, a=self.a)

    @_matvec_shape
    def matmul(self, x: torch.Tensor, *, parallel: bool = True) -> torch.Tensor:
        return _ops().strict_lower_matmul(self.p, self.q, self.a, x, parallel=parallel)

    def scale(self, other: Any) -> StrictLowerTriQSM:
        return StrictLowerTriQSM(p=self.p * other, q=self.q, a=self.a)

    def self_add(self, other: StrictLowerTriQSM) -> StrictLowerTriQSM:
        """The sum: generators concatenate, transitions go block-diagonal."""
        return StrictLowerTriQSM(
            p=torch.cat([self.p, other.p], dim=1),
            q=torch.cat([self.q, other.q], dim=1),
            a=_block_diag_rows(self.a, other.a),
        )

    def self_mul(self, other: StrictLowerTriQSM) -> StrictLowerTriQSM:
        """The Hadamard product: generators and transitions combine as
        Kronecker products, so the orders multiply."""
        n, m1, m2 = self.p.shape[0], self.p.shape[1], other.p.shape[1]

        def kron_vec(u, v):
            return (u[:, :, None] * v[:, None, :]).reshape(n, m1 * m2)

        a = torch.einsum("nij,nkl->nikjl", self.a, other.a).reshape(n, m1 * m2, m1 * m2)
        return StrictLowerTriQSM(
            p=kron_vec(self.p, other.p), q=kron_vec(self.q, other.q), a=a
        )

    def __neg__(self) -> StrictLowerTriQSM:
        return StrictLowerTriQSM(p=-self.p, q=self.q, a=self.a)


@dataclasses.dataclass(frozen=True, eq=False)
class StrictUpperTriQSM(QSM):
    """A strictly upper triangular quasiseparable matrix, stored as the
    transpose of a :class:`StrictLowerTriQSM` with the same fields."""

    p: torch.Tensor
    q: torch.Tensor
    a: torch.Tensor

    def transpose(self) -> StrictLowerTriQSM:
        return StrictLowerTriQSM(p=self.p, q=self.q, a=self.a)

    @_matvec_shape
    def matmul(self, x: torch.Tensor, *, parallel: bool = True) -> torch.Tensor:
        return _ops().strict_upper_matmul(self.p, self.q, self.a, x, parallel=parallel)

    def scale(self, other: Any) -> StrictUpperTriQSM:
        return StrictUpperTriQSM(p=self.p, q=self.q * other, a=self.a)

    def self_add(self, other: StrictUpperTriQSM) -> StrictUpperTriQSM:
        return self.T.self_add(other.T).T

    def self_mul(self, other: StrictUpperTriQSM) -> StrictUpperTriQSM:
        return self.T.self_mul(other.T).T

    def __neg__(self) -> StrictUpperTriQSM:
        return StrictUpperTriQSM(p=-self.p, q=self.q, a=self.a)


@dataclasses.dataclass(frozen=True, eq=False)
class LowerTriQSM(QSM):
    """A lower triangular quasiseparable matrix: diagonal plus strict lower."""

    diag: DiagQSM
    lower: StrictLowerTriQSM

    def transpose(self) -> UpperTriQSM:
        return UpperTriQSM(diag=self.diag, upper=self.lower.T)

    def _terms(self):
        return (self.diag, self.lower)

    def inv(self) -> LowerTriQSM:
        """The closed-form inverse, also lower triangular quasiseparable:
        with ``g = 1/d``, diagonal ``g``, generators ``(-g p, g q)`` and
        transitions ``a - (g q) p^T``."""
        g = 1.0 / self.diag.d
        p, q, a = self.lower.p, self.lower.q, self.lower.a
        v = g[:, None] * q
        return LowerTriQSM(
            diag=DiagQSM(d=g),
            lower=StrictLowerTriQSM(
                p=-g[:, None] * p, q=v, a=a - v[:, :, None] * p[:, None, :]
            ),
        )

    @_matvec_shape
    def solve(self, y: torch.Tensor, *, parallel: bool = True) -> torch.Tensor:
        """Forward substitution: solve ``L @ x = y``."""
        return _ops().lower_triangular_solve(
            self.diag.d, self.lower.p, self.lower.q, self.lower.a, y, parallel=parallel
        )


@dataclasses.dataclass(frozen=True, eq=False)
class UpperTriQSM(QSM):
    """An upper triangular quasiseparable matrix: diagonal plus strict upper."""

    diag: DiagQSM
    upper: StrictUpperTriQSM

    def transpose(self) -> LowerTriQSM:
        return LowerTriQSM(diag=self.diag, lower=self.upper.T)

    def _terms(self):
        return (self.diag, self.upper)

    def inv(self) -> UpperTriQSM:
        return self.T.inv().T

    @_matvec_shape
    def solve(self, y: torch.Tensor, *, parallel: bool = True) -> torch.Tensor:
        """Backward substitution: solve ``U @ x = y``."""
        return _ops().upper_triangular_solve(
            self.diag.d, self.upper.p, self.upper.q, self.upper.a, y, parallel=parallel
        )


@dataclasses.dataclass(frozen=True, eq=False)
class SquareQSM(QSM):
    """A general square quasiseparable matrix: diagonal, strict lower and
    strict upper."""

    diag: DiagQSM
    lower: StrictLowerTriQSM
    upper: StrictUpperTriQSM

    def transpose(self) -> SquareQSM:
        return SquareQSM(diag=self.diag, lower=self.upper.T, upper=self.lower.T)

    def _terms(self):
        return (self.diag, self.lower, self.upper)

    def gram(self) -> SymmQSM:
        """``self.T @ self`` as a symmetric quasiseparable matrix."""
        M = self.T @ self
        return SymmQSM(diag=M.diag, lower=M.lower)

    def inv(self) -> SquareQSM:
        """The general inverse by the JAX package's two sequential passes.

        The forward pass eliminates the lower part while carrying the
        coupling ``f`` between the lower and upper generator histories; the
        backward pass builds the inverse's diagonal and generators from the
        suffix state ``z``. Both are Python loops over N, as the JAX
        package's are ``lax.scan`` loops: this is off the conditioning path.
        """
        d = self.diag.d
        p, q, a = self.lower.p, self.lower.q, self.lower.a
        h, g, b = self.upper.p, self.upper.q, self.upper.a
        n = d.shape[0]

        f = q.new_zeros(q.shape[1], g.shape[1])
        ig, s, ell, v, delta = ([None] * n for _ in range(5))
        for k in range(n):
            fh = f @ h[k]
            fbT = f @ b[k].T
            left = q[k] - a[k] @ fh
            right = g[k] - p[k] @ fbT
            ig[k] = 1.0 / (d[k] - p[k] @ fh)
            s[k] = ig[k] * left
            ell[k] = a[k] - torch.outer(s[k], p[k])
            v[k] = ig[k] * right
            delta[k] = b[k] - torch.outer(v[k], h[k])
            f = a[k] @ fbT + ig[k] * torch.outer(left, right)

        z = h.new_zeros(h.shape[1], p.shape[1])
        lam, t, u = ([None] * n for _ in range(3))
        for k in range(n - 1, -1, -1):
            zs = z @ s[k]
            za = z @ a[k]
            lam[k] = ig[k] + v[k] @ zs
            t[k] = v[k] @ za - lam[k] * p[k]
            u[k] = b[k].T @ zs - lam[k] * h[k]
            z = (
                b[k].T @ za
                - torch.outer(u[k] + lam[k] * h[k], p[k])
                - torch.outer(h[k], t[k])
            )
        stack = torch.stack
        return SquareQSM(
            diag=DiagQSM(d=stack(lam)),
            lower=StrictLowerTriQSM(p=stack(t), q=stack(s), a=stack(ell)),
            upper=StrictUpperTriQSM(p=stack(u), q=stack(v), a=stack(delta)),
        )


@dataclasses.dataclass(frozen=True, eq=False)
class SymmQSM(QSM):
    """A symmetric quasiseparable matrix: the upper part mirrors the lower."""

    diag: DiagQSM
    lower: StrictLowerTriQSM

    @classmethod
    def from_stacked(cls, d, ps, qs, as_) -> SymmQSM:
        """The matrix of the scans' stacked operands: ``d`` ``(N,)``,
        ``ps``/``qs`` ``(m, N)`` and ``as_`` ``(m*m, N)``, row ``i*m+j``
        holding ``a[i, j]``."""
        m, n = ps.shape
        return cls(
            diag=DiagQSM(d=d),
            lower=StrictLowerTriQSM(p=ps.T, q=qs.T, a=as_.T.reshape(n, m, m)),
        )

    def transpose(self) -> SymmQSM:
        return self

    def _terms(self):
        return (self.diag, self.lower, self.lower.transpose())

    def inv(self, *, parallel: bool = True) -> SymmQSM:
        """The inverse, again symmetric quasiseparable."""
        lam, t, s, ell = _ops().symm_solve_generators(
            self.diag.d, self.lower.p, self.lower.q, self.lower.a, parallel=parallel
        )
        return SymmQSM(diag=DiagQSM(d=lam), lower=StrictLowerTriQSM(p=t, q=s, a=ell))

    def cholesky(self, *, parallel: bool = True) -> LowerTriQSM:
        """The lower Cholesky factor ``L`` with ``L @ L.T = self``."""
        c, w = _ops().symm_cholesky(
            self.diag.d, self.lower.p, self.lower.q, self.lower.a, parallel=parallel
        )
        return LowerTriQSM(
            diag=DiagQSM(d=c),
            lower=StrictLowerTriQSM(p=self.lower.p, q=w, a=self.lower.a),
        )
