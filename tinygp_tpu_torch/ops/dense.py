"""The blocked dense Cholesky and the fused dense log-likelihood.

Counterpart of ``tinygp_tpu/ops/dense.py``, with its constants and its
algorithm: a right-looking blocked factorization of the unit-diagonal
scaled matrix, padded to a block multiple with identity rows, whose panel
products (kernel B5) and trailing updates (kernel B4, in place, lower part
only) run through :mod:`~tinygp_tpu_torch.ops.cuda_dense`. Each diagonal
block is factored by ``torch.linalg.cholesky_ex`` on its lower triangle
(beyond the first panel the upper triangle is stale, since B4 skips it)
and inverted by a triangular solve.

Where the JAX package reads breakdown as NaN, PyTorch's Cholesky raises:
:func:`_native_cholesky` uses ``cholesky_ex`` and turns ``info > 0`` into
a factor of NaNs, so the guards read breakdown as the JAX ones do. The
guards (NaN or non-positive pivots; the diagonal reconstruction residual)
are host branches here, one read-back per call, where the JAX package has
``lax.cond``; each time one takes the native branch it adds one to
:data:`NATIVE_REFACTORS`.

The split order ``terms`` (2 or 3, picked from ``rel_floor``) is the JAX
package's choice and is passed to the kernels: B4 computes the 3-term
products with float32 sums for either, and so does B5 at 2 terms
(``csrc/dense_tc.cu``); B5 at 3 terms sums in float64
(``csrc/dense_syrk.cu``). The plain float32 products
here (``split_syrk``, the 512 x 512 steps, the backward) run in full
float32 whatever the global setting: the public functions and the
backwards are :func:`~tinygp_tpu_torch.helpers.pinned`.

Each ``jax.custom_vjp`` is a ``torch.autograd.Function`` whose backward is
the JAX backward written out; its forward's panel loop runs without grad,
so no kernel output ever needs a ``grad_fn``.
"""

from __future__ import annotations

__all__ = [
    "NATIVE_REFACTORS",
    "blocked_cholesky",
    "blocked_loglik_terms",
    "cholesky_with_fallback",
    "kernel_loglik_terms",
    "split_matmul",
    "split_syrk",
]

import torch

from tinygp_tpu_torch.helpers import pinned
from tinygp_tpu_torch.ops import cuda_dense

# Panel width (measured best for the TPU at N ~ 1e4; kept for parity).
_BLOCK = 512
# Below this size the native Cholesky is used.
_MIN_BLOCKED = 4096
# The split order asked of the kernels: 3 = float32 grade, 2 = ~2^-16.
_TERMS = 3
# Relative eigenvalue floor above which the 2-term order is safe.
_FAST_FLOOR = 1e-2
# Largest relative error of diag(L L^T) against diag(K) before a factor is
# declared inaccurate and re-done natively.
_DIAG_RESID_TOL = 3e-3

NATIVE_REFACTORS = 0
"""Times a guard of :func:`cholesky_with_fallback` or of the fused
log-likelihood took the native re-factorization."""


def _count_refactor() -> None:
    global NATIVE_REFACTORS
    NATIVE_REFACTORS += 1


def _native_cholesky(K: torch.Tensor) -> torch.Tensor:
    """The lower factor of ``K``'s lower triangle, NaN in its lower triangle
    on breakdown (where ``torch.linalg.cholesky`` would raise), as the JAX
    kernel returns it."""
    L, info = torch.linalg.cholesky_ex(K)
    return torch.where(info[..., None, None] > 0, torch.full_like(L, float("nan")).tril(), L)


def _solve_lower(L: torch.Tensor, b: torch.Tensor, *, trans: bool = False) -> torch.Tensor:
    """``L^-1 b`` (or ``L^-T b``) for a vector or matrix ``b``."""
    A = L.mT if trans else L
    if b.ndim == 1:
        return torch.linalg.solve_triangular(A, b[:, None], upper=trans)[:, 0]
    return torch.linalg.solve_triangular(A, b, upper=trans)


@pinned
def split_matmul(X: torch.Tensor, Y: torch.Tensor, *, transpose_y: bool = False) -> torch.Tensor:
    """``X @ Y`` (or ``X @ Y.T``) by the three-term bf16 split: the six
    products of the pieces (:func:`cuda_dense.split_pieces`) summed in the
    JAX package's order, each exact in float32 and accumulated in float32
    (about 6e-8 relative operand error). Other dtypes take a plain
    product."""
    Yt = Y.mT if transpose_y else Y
    if X.dtype != torch.float32 or Y.dtype != torch.float32:
        return X @ Yt
    Xh, Xm, Xl = (x.float() for x in cuda_dense.split_pieces(X, 3))
    Yh, Ym, Yl = (y.float() for y in cuda_dense.split_pieces(Yt, 3))
    return Xh @ Yh + (Xh @ Ym + Xm @ Yh) + (Xh @ Yl + Xl @ Yh + Xm @ Ym)


@pinned
def split_syrk(L: torch.Tensor) -> torch.Tensor:
    """``L @ L.T``: the JAX package's split product, here one float32
    product (full float32 on the card, TF32 being off)."""
    return L @ L.mT


def _safe_rsqrt(d: torch.Tensor) -> torch.Tensor:
    tiny = torch.finfo(d.dtype).tiny
    return torch.where(d > 0, torch.rsqrt(torch.clamp(d, min=tiny)), torch.ones_like(d))


def _pad_identity(K: torch.Tensor, pad: int) -> torch.Tensor:
    """``blockdiag(K, I)``, whose factor is ``blockdiag(chol(K), I)``."""
    if not pad:
        return K
    return torch.block_diag(K, torch.eye(pad, dtype=K.dtype, device=K.device))


@pinned
def blocked_cholesky(
    K: torch.Tensor,
    *,
    block: int = _BLOCK,
    min_size: int = _MIN_BLOCKED,
    terms: int = _TERMS,
) -> torch.Tensor:
    """The lower Cholesky factor of a symmetric positive definite matrix,
    blocked over kernels B5 and B4; the native factor below ``min_size``
    and for any dtype but float32. On breakdown the factor holds NaNs, as
    the native one does (see :func:`cholesky_with_fallback`)."""
    n = K.shape[0]
    if n < max(min_size, block) or K.dtype != torch.float32:
        return _native_cholesky(K)
    return _BlockedChol.apply(K, block, terms)


class _BlockedChol(torch.autograd.Function):
    """The blocked factorization, differentiated by the standard Cholesky
    reverse rule (two triangular solves), never through its internals."""

    @staticmethod
    def forward(ctx, K: torch.Tensor, block: int, terms: int) -> torch.Tensor:
        L = _blocked_cholesky_impl(K, block, terms)
        ctx.save_for_backward(L)
        return L

    @staticmethod
    @pinned
    def backward(ctx, Lbar: torch.Tensor):
        # With X = L^T Lbar and P = tril(X) - diag(X)/2,
        # Kbar = sym(L^-T P L^-1).
        (L,) = ctx.saved_tensors
        X = L.mT @ Lbar
        P = torch.tril(X) - 0.5 * torch.diag(torch.diagonal(X))
        S = _solve_lower(L, P, trans=True)
        S = _solve_lower(L, S.mT, trans=True).mT
        return 0.5 * (S + S.mT), None, None


def _blocked_cholesky_impl(K: torch.Tensor, block: int, terms: int) -> torch.Tensor:
    n = K.shape[0]
    s = _safe_rsqrt(torch.diagonal(K))
    # T is a new tensor (scaled, padded): B4 updates it in place, and only
    # its lower triangle is kept valid.
    T = _pad_identity(K * s[:, None] * s[None, :], (-n) % block)
    m = T.shape[0]
    nb = m // block
    tile = 256 if block % 256 == 0 else block
    eye = torch.eye(block, dtype=T.dtype, device=T.device)
    L = torch.zeros_like(T)
    for k in range(nb):
        lo, hi = k * block, (k + 1) * block
        L11 = _native_cholesky(torch.tril(T[lo:hi, lo:hi]))
        L[lo:hi, lo:hi] = L11
        if k + 1 < nb:
            L11invT = _solve_lower(L11, eye).mT
            # The panel L21 = A21 inv(L11)^T, read out of T in place (B5),
            # then the trailing update T[hi:, hi:] -= L21 L21^T (B4).
            L21 = cuda_dense.split_panel_matmul(
                T, L11invT, tile=tile, terms=terms, at=(hi, lo), rows=m - hi
            )
            cuda_dense.syrk_sub_inplace(T, L21, offset=hi, tile=tile, terms=terms)
            L[hi:, lo:hi] = L21
    return L[:n, :n] * (1.0 / s)[:, None]


@pinned
def cholesky_with_fallback(
    K: torch.Tensor,
    *,
    block: int = _BLOCK,
    min_size: int = _MIN_BLOCKED,
    terms: int | None = None,
    rel_floor: torch.Tensor | None = None,
) -> torch.Tensor:
    """:func:`blocked_cholesky`, re-factored natively when it breaks down.

    With ``rel_floor`` (a lower bound on the smallest eigenvalue of the
    unit-diagonal scaled matrix, e.g. the GP noise floor) and no forced
    ``terms``, the split order is 2 above ``_FAST_FLOOR`` and 3 below.
    Two guards, as in the JAX package: NaN or non-positive pivots, and the
    diagonal reconstruction residual ``max |sum_j L[i, j]^2 - K[i, i]| /
    |K[i, i]|`` above ``_DIAG_RESID_TOL``. Either takes the native factor
    and counts in :data:`NATIVE_REFACTORS`.
    """
    n = K.shape[0]
    if n < max(min_size, block) or K.dtype != torch.float32:
        return _native_cholesky(K)
    if terms is None:
        terms = _TERMS if rel_floor is None else (2 if float(rel_floor.detach()) > _FAST_FLOOR else 3)
    L = blocked_cholesky(K, block=block, min_size=min_size, terms=terms)
    with torch.no_grad():
        dL = torch.diagonal(L)
        bad = torch.any(torch.isnan(dL)) | torch.any(dL <= 0)
        dK = torch.diagonal(K)
        resid = torch.abs(torch.sum(torch.square(L), dim=1) - dK)
        rel = torch.max(resid / torch.clamp(torch.abs(dK), min=torch.finfo(K.dtype).tiny))
        bad = bad | (rel > _DIAG_RESID_TOL) | torch.isnan(rel)
    if bool(bad):
        _count_refactor()
        return _native_cholesky(K)
    return L


def _native_loglik_terms(K: torch.Tensor, r: torch.Tensor):
    """``(r^T K^-1 r, log|chol(K)|)`` through the native factor."""
    L = _native_cholesky(K)
    a = _solve_lower(L, r)
    return torch.sum(torch.square(a)), torch.sum(torch.log(torch.diagonal(L)))


def _scaled_loglik_impl(
    T: torch.Tensor, rs: torch.Tensor, block: int, terms: int, want_factor: bool
):
    """Factor a scaled padded system and whiten ``rs`` in one panel loop.

    ``T`` ``(m, m)`` is the unit-diagonal scaled covariance padded with
    identity rows; only its lower triangle is read. ``rs`` is the scaled
    residual (zero in the pad). Both are working copies, updated in place.
    The loop is :func:`blocked_cholesky`'s with the forward substitution
    inside it (``alpha_k`` from the panel inverse; the running residual
    updated with B4's ``L21 @ alpha_k``) and the reconstruction guard from
    B4's row sums of squares against the scaled diagonal, exactly 1.

    Returns ``(quad, half_logdet_scaled, bad, Ls_or_None)``.
    """
    m = T.shape[0]
    nb = m // block
    tile = block if block % 512 == 0 else 256
    eye = torch.eye(block, dtype=T.dtype, device=T.device)
    quad = T.new_zeros(())
    half_logdet = T.new_zeros(())
    bad_pivot = torch.zeros((), dtype=torch.bool, device=T.device)
    rowsq = T.new_zeros(m)
    factor = torch.zeros_like(T) if want_factor else None
    for k in range(nb):
        lo, hi = k * block, (k + 1) * block
        L11 = _native_cholesky(torch.tril(T[lo:hi, lo:hi]))
        dL = torch.diagonal(L11)
        bad_pivot = bad_pivot | torch.any(~(dL > 0))
        half_logdet = half_logdet + torch.sum(torch.log(dL))
        rk = rs[lo:hi]
        if k + 1 < nb:
            L11invT = _solve_lower(L11, eye).mT
            ak = rk @ L11invT
            L21 = cuda_dense.split_panel_matmul(
                T, L11invT, tile=tile, terms=terms, at=(hi, lo), rows=m - hi
            )
            _, l21_sq, rsu = cuda_dense.syrk_sub_inplace(
                T, L21, offset=hi, tile=tile, terms=terms, ak=ak
            )
            rs[hi:] -= rsu
            body_sq = torch.cat([torch.sum(torch.square(L11), dim=1), l21_sq])
            if want_factor:
                factor[lo:hi, lo:hi] = L11
                factor[hi:, lo:hi] = L21
        else:
            ak = _solve_lower(L11, rk)
            body_sq = torch.sum(torch.square(L11), dim=1)
            if want_factor:
                factor[lo:, lo:] = L11
        quad = quad + torch.sum(torch.square(ak))
        rowsq[lo:] += body_sq
    maxdev = torch.max(torch.abs(rowsq - 1.0))
    bad = bad_pivot | (maxdev > _DIAG_RESID_TOL) | torch.isnan(maxdev)
    return quad, half_logdet, bad, factor


class _ScaledLoglik(torch.autograd.Function):
    """``(rs^T T^-1 rs, log|chol(T)|)`` of the scaled padded system, with
    the native rescue; the JAX package's ``_scaled_loglik``."""

    @staticmethod
    def forward(ctx, T, rs, block: int, terms: int, lower_only: bool):
        want_factor = any(ctx.needs_input_grad[:2])
        # B4 writes into its operand, so the loop works on copies. The copy
        # of T is made even without a gradient: the native rescue below
        # re-factors the original.
        quad, half_logdet, bad, Ls = _scaled_loglik_impl(
            T.clone(), rs.clone(), block, terms, want_factor
        )
        if bool(bad):
            _count_refactor()
            Ls = _native_cholesky(torch.tril(T))
            a = _solve_lower(Ls, rs)
            quad = torch.sum(torch.square(a))
            half_logdet = torch.sum(torch.log(torch.diagonal(Ls)))
        if want_factor:
            ctx.save_for_backward(Ls, rs)
        ctx.lower_only = lower_only
        return quad, half_logdet

    @staticmethod
    @pinned
    def backward(ctx, qbar, lbar):
        # quad = rs^T T^-1 rs, half_logdet = 0.5 log|T|: with cotangents
        # (qbar, lbar), Tbar = -qbar beta beta^T + 0.5 lbar T^-1 and
        # rsbar = 2 qbar beta, where beta = T^-1 rs. Computed in float64
        # from the factor whatever its type: a float32 explicit inverse errs
        # by about cond(T) eps, which left the float32 gradient at N = 1e4
        # at the mercy of the factor's last bits (PERF.md, PR 7). On the
        # H100 the float64 inverse and product cost no more than float32's.
        Ls, rs = ctx.saved_tensors
        dtype = rs.dtype
        Ls, rs = Ls.to(torch.float64), rs.to(torch.float64)
        beta = _solve_lower(Ls, _solve_lower(Ls, rs), trans=True)
        Linv = _solve_lower(Ls, torch.eye(Ls.shape[0], dtype=Ls.dtype, device=Ls.device))
        Tinv = split_syrk(Linv.mT)
        Tbar = -qbar * torch.outer(beta, beta) + (0.5 * lbar) * Tinv
        Tbar = 0.5 * (Tbar + Tbar.mT)
        if ctx.lower_only:
            # The forward reads only tril(T) (strip-built operands have a
            # zero upper triangle), so the gradient with respect to T as
            # consumed doubles the strict lower part and zeroes the upper.
            Tbar = 2.0 * torch.tril(Tbar, -1) + torch.diag(torch.diagonal(Tbar))
        return Tbar.to(dtype), ((2.0 * qbar) * beta).to(dtype), None, None, None


def _scaled_terms_dispatch(T, rs, block, terms, rel_floor, lower_only=False):
    """The split order from ``rel_floor`` (a host branch), then the fused
    loop."""
    if terms is None:
        terms = _TERMS if rel_floor is None else (2 if float(rel_floor.detach()) > _FAST_FLOOR else 3)
    return _ScaledLoglik.apply(T, rs, block, terms, lower_only)


@pinned
def blocked_loglik_terms(
    K: torch.Tensor,
    r: torch.Tensor,
    *,
    block: int = _BLOCK,
    min_size: int = _MIN_BLOCKED,
    terms: int | None = None,
    rel_floor: torch.Tensor | None = None,
):
    """``(r^T K^-1 r, log|chol(K)|)`` in one fused blocked pass, with the
    split-order choice and the native rescue of
    :func:`cholesky_with_fallback`. Differentiable: the factorization by
    its autograd Function, the scaling by ordinary autograd."""
    n = K.shape[0]
    if n < max(min_size, block) or K.dtype != torch.float32:
        return _native_loglik_terms(K, r)
    s = _safe_rsqrt(torch.diagonal(K))
    pad = (-n) % block
    Ks = _pad_identity(K * s[:, None] * s[None, :], pad)
    rs = torch.cat([(r * s).to(K.dtype), K.new_zeros(pad)])
    quad, hld_scaled = _scaled_terms_dispatch(Ks, rs, block, terms, rel_floor)
    return quad, hld_scaled - torch.sum(torch.log(s))


@pinned
def kernel_loglik_terms(
    kernel,
    X: torch.Tensor,
    noise_diag: torch.Tensor,
    r: torch.Tensor,
    *,
    variance: torch.Tensor | None = None,
    block: int = _BLOCK,
    terms: int | None = None,
    rel_floor: torch.Tensor | None = None,
):
    """The fused log-likelihood terms straight from the kernel.

    The scaled padded working matrix is built in per-panel strips, each
    evaluated from ``kernel`` on slices of ``X`` at and below the diagonal
    only, with the noise, the unit-diagonal scaling and the padding folded
    into the strip; the covariance itself is never built. Any dtype but
    float32 builds the whole matrix and takes the native factor.

    Float32 inputs build the strips in float64 and round the working
    matrix to float32 once, for the factorization: the gradient then flows
    back through the strip build in float64. Built in float32, that sum
    over N^2 entries, whose terms largely cancel, erred past the
    gradient's limit at N = 1e4 with any rounding of the factor (PERF.md
    §6, B4 on the tensor cores). The returned terms are float32.
    """
    n = X.shape[0]
    if variance is None:
        variance = kernel(X) + noise_diag
    dtype = torch.promote_types(variance.dtype, r.dtype)
    if dtype != torch.float32:
        like = dict(dtype=dtype, device=X.device)
        eq = torch.eye(n, dtype=torch.bool, device=X.device)
        K = kernel(X, X) + torch.where(eq, noise_diag[:, None], torch.zeros((), **like))
        return _native_loglik_terms(K, r)
    like = dict(dtype=torch.float64, device=X.device)
    X, noise_diag, r = X.double(), noise_diag.double(), r.double()
    s = _safe_rsqrt(variance.double())
    pad = (-n) % block
    m = n + pad
    strips = []
    for k in range(m // block):
        lo = k * block
        cr = min(lo + block, n)  # the strip's last real column
        G = kernel(X[lo:n], X[lo:cr])
        eq = torch.eye(n - lo, cr - lo, dtype=torch.bool, device=X.device)
        G = G + torch.where(eq, noise_diag[lo:cr][None, :], torch.zeros((), **like))
        strip = G * s[lo:n, None] * s[None, lo:cr]
        if cr < lo + block:  # pad columns (the last strip only)
            strip = torch.cat([strip, torch.zeros(n - lo, lo + block - cr, **like)], dim=1)
        if pad:  # pad rows: identity in the pad block, zeros elsewhere
            bottom = torch.zeros(pad, block, **like)
            if cr < lo + block:
                bottom = torch.cat(
                    [torch.zeros(pad, cr - lo, **like), torch.eye(pad, **like)], dim=1
                )
            strip = torch.cat([strip, bottom], dim=0)
        strips.append(torch.cat([torch.zeros(lo, block, **like), strip], dim=0))
    T = torch.cat(strips, dim=1).to(dtype)
    rs = torch.cat([r * s, torch.zeros(pad, **like)]).to(dtype)
    quad, hld_scaled = _scaled_terms_dispatch(T, rs, block, terms, rel_floor, lower_only=True)
    return quad, (hld_scaled - torch.sum(torch.log(s))).to(dtype)
