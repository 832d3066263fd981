"""Named quasiseparable operations and the structural algebra of QSMs.

Counterpart of ``tinygp_tpu/solvers/quasisep/ops.py``: the triangular
matmuls and solves, the Cholesky factor, the symmetric inverse, the fused
log-likelihood terms, and the algebra on whole QSMs (``elementwise_add``,
``elementwise_mul``, ``qsm_mul``).

Every O(N) operation is one of the scans of
:mod:`~tinygp_tpu_torch.solvers.quasisep.scan` with elementwise work
around it. With ``parallel=True`` the scans run through kernel B3 on the
card and through the blocked plain scan on the CPU; ``parallel=False`` is
the sequential oracle. The QSM product's coupling recurrences, which the
JAX package runs as sequential ``lax.scan`` loops, run as monoid scans
here (kernel B3 on the card), since a loop of N steps is seconds on the
card at N = 1e5. Every operation here is differentiable on either device:
the scans are ``autograd.Function`` s whose backwards are their
hand-written adjoints (a reverse launch of B3 on the card), and nothing
between them writes into a tensor autograd saved or reads a value back to
the host.
"""

from __future__ import annotations

__all__ = [
    "stacked_loglik_terms",
    "strict_lower_matmul",
    "strict_upper_matmul",
    "lower_triangular_solve",
    "upper_triangular_solve",
    "symm_cholesky",
    "symm_solve_generators",
    "elementwise_add",
    "elementwise_mul",
    "qsm_mul",
    "lower_matmul",
    "lower_matmul_parallel",
    "upper_matmul",
    "upper_matmul_parallel",
    "lower_solve",
    "lower_solve_parallel",
    "upper_solve",
    "upper_solve_parallel",
    "cholesky",
    "cholesky_parallel",
    "symm_inv",
    "symm_inv_parallel",
]

import torch

from tinygp_tpu_torch.solvers.quasisep import cuda_loglik, cuda_scan
from tinygp_tpu_torch.solvers.quasisep.scan import (
    _pack3,
    _unpack3,
    affine_scan,
    congruence_scan,
    riccati_scan,
)

# ---------------------------------------------------------------------------
# Triangular matmuls: y = T @ x for a strictly triangular T with generators
# (p, q, a). The state e_k carries the generator-weighted history and the
# output contracts it with the row generator.
# ---------------------------------------------------------------------------


def _outer_rows(u: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-row outer products: (N, m) x (N, r) -> (N, m, r)."""
    return u[:, :, None] * x[:, None, :]


def _contract_rows(u: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """Per-row contractions: (N, m) x (N, m, r) -> (N, r)."""
    return torch.einsum("nj,njk->nk", u, e)


def strict_lower_matmul(p, q, a, x, *, parallel: bool = True):
    e = affine_scan(a, _outer_rows(q, x), parallel=parallel)
    return _contract_rows(p, e)


def strict_upper_matmul(p, q, a, x, *, parallel: bool = True):
    e = affine_scan(a.mT, _outer_rows(p, x), reverse=True, parallel=parallel)
    return _contract_rows(q, e)


# ---------------------------------------------------------------------------
# Triangular solves: the diagonal folds into the transition, so a solve is
# an affine scan. For L = diag(d) + strict_lower(p, q, a):
#   x_k = (y_k - p_k^T e_k) / d_k,  e' = a e + q x
#       => e' = (a - (q/d) p^T) e + (q/d) y
# ---------------------------------------------------------------------------


def lower_triangular_solve(d, p, q, a, y, *, parallel: bool = True):
    inv_d = 1.0 / d[:, None]
    qd = q * inv_d
    A = a - _outer_rows(qd, p)
    e = affine_scan(A, _outer_rows(qd, y), parallel=parallel)
    return (y - _contract_rows(p, e)) * inv_d


def upper_triangular_solve(d, p, q, a, y, *, parallel: bool = True):
    inv_d = 1.0 / d[:, None]
    pd = p * inv_d
    A = a.mT - _outer_rows(pd, q)
    e = affine_scan(A, _outer_rows(pd, y), reverse=True, parallel=parallel)
    return (y - _contract_rows(q, e)) * inv_d


# ---------------------------------------------------------------------------
# Cholesky of K = diag(d) + L + L^T with L strictly lower (p, q, a): the
# factor keeps p and a, and from the Riccati flow F
#   c_k = sqrt(d_k - p_k^T F_k p_k),  w_k = (q_k - a_k F_k p_k) / c_k.
# ---------------------------------------------------------------------------


def _row_matvec(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Per-row ``M_k @ v_k``: (N, m, k) x (N, k) -> (N, m)."""
    return torch.einsum("nij,nj->ni", M, v)


def symm_cholesky(d, p, q, a, *, parallel: bool = True):
    F = riccati_scan(d, p, q, a, parallel=parallel)
    Fp = _row_matvec(F, p)
    c = torch.sqrt(d - torch.sum(p * Fp, dim=1))
    w = (q - _row_matvec(a, Fp)) / c[:, None]
    return c, w


# ---------------------------------------------------------------------------
# The symmetric inverse is again quasiseparable: the forward (Riccati) pass
# gives its right generator s and transition ell; the reverse congruence
# pass z_k = ell_k^T z ell_k + p p^T / c2_k gives its diagonal and left
# generator.
# ---------------------------------------------------------------------------


def symm_solve_generators(d, p, q, a, *, parallel: bool = True):
    F = riccati_scan(d, p, q, a, parallel=parallel)
    Fp = _row_matvec(F, p)
    ig = 1.0 / (d - torch.sum(p * Fp, dim=1))
    s = ig[:, None] * (q - _row_matvec(a, Fp))
    ell = a - _outer_rows(s, p)

    B = ig[:, None, None] * _outer_rows(p, p)
    z = congruence_scan(ell.mT, B, reverse=True, parallel=parallel)

    sz = torch.einsum("ni,nij->nj", s, z)
    lam = ig + torch.sum(sz * s, dim=1)
    t = torch.einsum("ni,nij->nj", sz, a) - lam[:, None] * p
    return lam, t, s, ell


# ---------------------------------------------------------------------------
# The fused log-likelihood on stacked operands.
# ---------------------------------------------------------------------------


def stacked_loglik_terms(
    d: torch.Tensor,
    ps: torch.Tensor,
    qs: torch.Tensor,
    as_: torch.Tensor,
    y: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(alpha . alpha, sum(log c))`` for ``K = diag(d) + tril + tril^T``.

    Operands are stacked: ``d``/``y`` of shape ``(N,)``, generators
    ``ps``/``qs`` of ``(m, N)``, dense transitions ``as_`` of ``(m*m, N)``.
    Mixed dtypes promote here; on the card the CUDA kernel does the whole
    job, on the CPU its plain version
    (:func:`~tinygp_tpu_torch.solvers.quasisep.cuda_loglik.fused_loglik_terms`).
    """
    dtype = d.dtype
    for x in (ps, qs, as_, y):
        dtype = torch.promote_types(dtype, x.dtype)
    d, ps, qs, as_, y = (x.to(dtype).contiguous() for x in (d, ps, qs, as_, y))
    return cuda_loglik.fused_loglik_terms(d, ps, qs, as_, y)


def lower_matmul(p, q, a, x):
    return strict_lower_matmul(p, q, a, x, parallel=False)


def lower_matmul_parallel(p, q, a, x):
    return strict_lower_matmul(p, q, a, x, parallel=True)


def upper_matmul(p, q, a, x):
    return strict_upper_matmul(p, q, a, x, parallel=False)


def upper_matmul_parallel(p, q, a, x):
    return strict_upper_matmul(p, q, a, x, parallel=True)


def lower_solve(d, p, q, a, y):
    return lower_triangular_solve(d, p, q, a, y, parallel=False)


def lower_solve_parallel(d, p, q, a, y):
    return lower_triangular_solve(d, p, q, a, y, parallel=True)


def upper_solve(d, p, q, a, y):
    return upper_triangular_solve(d, p, q, a, y, parallel=False)


def upper_solve_parallel(d, p, q, a, y):
    return upper_triangular_solve(d, p, q, a, y, parallel=True)


def cholesky(d, p, q, a):
    return symm_cholesky(d, p, q, a, parallel=False)


def cholesky_parallel(d, p, q, a):
    return symm_cholesky(d, p, q, a, parallel=True)


def symm_inv(d, p, q, a):
    return symm_solve_generators(d, p, q, a, parallel=False)


def symm_inv_parallel(d, p, q, a):
    return symm_solve_generators(d, p, q, a, parallel=True)


# ---------------------------------------------------------------------------
# Structural algebra on whole QSMs, by their (diag, lower, upper) parts;
# missing parts are None.
# ---------------------------------------------------------------------------


def _decompose(m):
    """Split any QSM into its (diag, strict-lower, strict-upper) parts."""
    from tinygp_tpu_torch.solvers.quasisep.core import (
        DiagQSM,
        StrictLowerTriQSM,
        StrictUpperTriQSM,
        SymmQSM,
    )

    diag = m if isinstance(m, DiagQSM) else getattr(m, "diag", None)
    lower = m if isinstance(m, StrictLowerTriQSM) else getattr(m, "lower", None)
    if isinstance(m, StrictUpperTriQSM):
        upper = m
    elif isinstance(m, SymmQSM):
        upper = m.lower.transpose()
    else:
        upper = getattr(m, "upper", None)
    return diag, lower, upper


def _is_symmetric(m) -> bool:
    from tinygp_tpu_torch.solvers.quasisep.core import DiagQSM, SymmQSM

    return isinstance(m, DiagQSM | SymmQSM)


def _recompose(diag, lower, upper, symmetric: bool):
    """Assemble a QSM from parts, choosing the tightest class."""
    from tinygp_tpu_torch.solvers.quasisep.core import (
        LowerTriQSM,
        SquareQSM,
        SymmQSM,
        UpperTriQSM,
    )

    if lower is None and upper is None:
        return diag
    if symmetric:
        if diag is None or lower is None:
            raise ValueError("a symmetric QSM needs a diagonal and a lower part")
        return SymmQSM(diag=diag, lower=lower)
    if lower is None:
        return upper if diag is None else UpperTriQSM(diag=diag, upper=upper)
    if upper is None:
        return lower if diag is None else LowerTriQSM(diag=diag, lower=lower)
    if diag is None:
        # e.g. strict lower + strict upper: no compact class for this.
        return None
    return SquareQSM(diag=diag, lower=lower, upper=upper)


def _maybe(f, x, y):
    if x is None:
        return y
    if y is None:
        return x
    return f(x, y)


def elementwise_add(a, b):
    """``a + b`` for two QSMs, staying quasiseparable."""
    da, la, ua = _decompose(a)
    db, lb, ub = _decompose(b)

    def add(x, y):
        return x.self_add(y)

    return _recompose(
        _maybe(add, da, db),
        _maybe(add, la, lb),
        _maybe(add, ua, ub),
        _is_symmetric(a) and _is_symmetric(b),
    )


def elementwise_mul(a, b):
    """The Hadamard product of two QSMs (orders multiply)."""
    da, la, ua = _decompose(a)
    db, lb, ub = _decompose(b)

    def mul(x, y):
        return None if x is None or y is None else x.self_mul(y)

    return _recompose(
        mul(da, db), mul(la, lb), mul(ua, ub), _is_symmetric(a) and _is_symmetric(b)
    )


def _coupling_scan(A, Bt, C, *, reverse: bool = False):
    """The exclusive prefix of the two-sided recurrence ``g' = A g Bt^T + C``
    with ``A`` ``(N, m1, m1)``, ``Bt`` ``(N, m2, m2)`` and ``C``
    ``(N, m1, m2)``: the coupling terms of the QSM product. A monoid scan
    here (kernel B3 on the card) where the JAX package loops."""
    m1, m2 = A.shape[-1], Bt.shape[-1]
    g = cuda_scan.coupling(
        _pack3(A), _pack3(Bt), _pack3(C), m1, m2, reverse=reverse, exclusive=True
    )
    return _unpack3(g, m1, m2)


def _stack_cols(*parts):
    parts = [x for x in parts if x is not None]
    return torch.cat(parts, dim=-1) if parts else None


def _block_upper_2x2(a_top, a_bot, coupling):
    """Per-row ``[[a_top, coupling], [0, a_bot]]``."""
    m1, m2 = a_top.shape[-1], a_bot.shape[-1]
    top = torch.cat([a_top, coupling], dim=-1)
    bot = torch.cat([a_bot.new_zeros(a_bot.shape[:-2] + (m2, m1)), a_bot], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _block_lower_2x2(a_top, a_bot, coupling):
    """Per-row ``[[a_top, 0], [coupling, a_bot]]``."""
    m1, m2 = a_top.shape[-1], a_bot.shape[-1]
    top = torch.cat([a_top, a_top.new_zeros(a_top.shape[:-2] + (m1, m2))], dim=-1)
    bot = torch.cat([coupling, a_bot], dim=-1)
    return torch.cat([top, bot], dim=-2)


def qsm_mul(a, b):
    """The product ``a @ b`` of two QSMs as a QSM (orders add).

    Two coupling scans carry the interactions across the diagonal: ``phi``
    couples a's lower history with b's upper history (forward), ``psi`` a's
    upper future with b's lower future (reverse). The product's generators
    concatenate the operands' with coupling-corrected terms, and its
    transitions become 2x2 block triangles. Every row is assembled at once,
    with the row axis leading.
    """
    from tinygp_tpu_torch.solvers.quasisep.core import (
        DiagQSM,
        StrictLowerTriQSM,
        StrictUpperTriQSM,
    )

    da, la, ua = _decompose(a)
    db, lb, ub = _decompose(b)

    if la is None and ua is None and lb is None and ub is None:
        return DiagQSM(d=da.d * db.d)

    # Notation: the product's lower generators are [t | s], its upper ones
    # [u | v], with the four coupling-corrected terms below.
    alpha = beta = theta = eta = lam = None
    if db is not None and la is not None:
        alpha = la.q * db.d[:, None]
    if da is not None and lb is not None:
        beta = da.d[:, None] * lb.p
    if da is not None and ub is not None:
        theta = da.d[:, None] * ub.q
    if db is not None and ua is not None:
        eta = ua.p * db.d[:, None]
    if da is not None and db is not None:
        lam = da.d * db.d

    if la is not None and ub is not None:
        phi = _coupling_scan(la.a, ub.a, _outer_rows(la.q, ub.q))
        alpha = _maybe(torch.add, alpha, torch.einsum("nij,njk,nk->ni", la.a, phi, ub.p))
        theta = _maybe(torch.add, theta, torch.einsum("ni,nij,nkj->nk", la.p, phi, ub.a))
        lam = _maybe(torch.add, lam, torch.einsum("ni,nij,nj->n", la.p, phi, ub.p))

    if ua is not None and lb is not None:
        psi = _coupling_scan(ua.a.mT, lb.a.mT, _outer_rows(ua.p, lb.p), reverse=True)
        beta = _maybe(torch.add, beta, torch.einsum("ni,nij,njk->nk", ua.q, psi, lb.a))
        eta = _maybe(torch.add, eta, torch.einsum("nji,njk,nk->ni", ua.a, psi, lb.q))
        lam = _maybe(torch.add, lam, torch.einsum("ni,nij,nj->n", ua.q, psi, lb.q))

    s = _stack_cols(alpha, None if lb is None else lb.q)
    t = _stack_cols(None if la is None else la.p, beta)
    v = _stack_cols(None if ua is None else ua.q, theta)
    u = _stack_cols(eta, None if ub is None else ub.p)

    if la is not None and lb is not None:
        ell = _block_upper_2x2(la.a, lb.a, _outer_rows(la.q, lb.p))
    else:
        ell = la.a if la is not None else (lb.a if lb is not None else None)

    if ua is not None and ub is not None:
        delta = _block_lower_2x2(ua.a, ub.a, _outer_rows(ub.q, ua.p))
    else:
        delta = ua.a if ua is not None else (ub.a if ub is not None else None)

    diag = DiagQSM(d=lam) if lam is not None else None
    lower = (
        StrictLowerTriQSM(p=t, q=s, a=ell)
        if s is not None and t is not None and ell is not None
        else None
    )
    upper = (
        StrictUpperTriQSM(p=u, q=v, a=delta)
        if u is not None and v is not None and delta is not None
        else None
    )
    # A product of symmetric matrices is symmetric only when they commute,
    # which cannot be assumed: keep both triangles.
    return _recompose(diag, lower, upper, symmetric=False)
