"""Scan primitives for quasiseparable linear algebra and their adjoints.

Counterpart of ``tinygp_tpu/solvers/quasisep/scan.py``. Four first-order
recurrences over the data axis carry every O(N) operation:

1. the **affine** recurrence ``g_k = A_k g_prev + B_k``;
2. the **congruence** recurrence ``g_k = A_k g_prev A_k^T + B_k``, which
   carries the Riccati flow's adjoint;
3. the **Riccati** covariance flow ``F' = a F a^T + u u^T / c2`` with
   ``u = q - a F p`` and ``c2 = d - p^T F p``, composed in parallel as a
   linear-fractional (Möbius) map on the triple ``(A, F, G)``;
4. the two-sided **coupling** ``g_k = A_k g_prev B_k^T + C_k`` of the
   QSM product (``ops.qsm_mul``).

Operands are *stacked*: an ``(N, m, k)`` array is one ``(m*k, N)`` tensor
with the components on the second-to-last axis and the data axis last, so
any leading axes (the blocked scan's step axis) broadcast through the m×m
algebra, which is written out as elementwise products of rows.

:func:`monoid_scan` is the JAX package's blocked strategy on the CPU,
with the same ``_BLOCK``, ``_SEQ_CUTOFF`` and ``_ASSOC_CUTOFF`` and the
same block scaling, so that in float64 its association order is the one
the JAX CPU route uses. The TPU-only associative-scan level and the
Pallas branch are not part of the port. The stacked scans
(:func:`_affine_scan_s`, :func:`_congruence_scan_s`,
:func:`_riccati_scan_s`, :func:`_coupling_scan_s`) are plain PyTorch on
any device: they are the plain versions of the CUDA kernels. The hand-written
adjoints (:func:`_affine_bwd_s`, :func:`_congruence_bwd_s`,
:func:`_riccati_bwd_s`, :func:`_coupling_bwd_s`) are the backwards of
the ``autograd.Function`` s of ``cuda_scan`` (each one opposite-direction
scan, through the scan it is given) and, with the plain scans, the two
reverse scans of the backward kernel's plain version
(``cuda_loglik.plain_loglik_bwd``).

The row-major API of the QSM classes (:func:`affine_scan`,
:func:`congruence_scan`, :func:`riccati_scan`) takes ``(N, m, k)``
operands. With ``parallel=True`` it goes through the wrappers of
:mod:`~tinygp_tpu_torch.solvers.quasisep.cuda_scan`: kernel B3 for CUDA
tensors, the stacked plain scans for CPU tensors. ``parallel=False`` is the
JAX package's sequential oracle, a Python loop over N on any device. The
port has no lazy ``Block`` transitions, so the JAX package's
``_dense_transitions`` has nothing to do here and is not ported.
"""

from __future__ import annotations

__all__ = [
    "monoid_scan",
    "affine_scan",
    "congruence_scan",
    "riccati_scan",
    "riccati_fold_rank_one",
]

from collections.abc import Callable

import torch

# Sequential steps per level of the blocked scan.
_BLOCK = 64
# Below this length a single sequential scan is used.
_SEQ_CUTOFF = 128
# The block grows until the totals level has at most this many entries,
# keeping the depth at block + log(N / block) levels for any N.
_ASSOC_CUTOFF = 8192

Tree = tuple[torch.Tensor, ...]


def monoid_scan(
    combine: Callable[[Tree, Tree], Tree],
    identity: Tree,
    elems: Tree,
    *,
    reverse: bool = False,
) -> Tree:
    """Exclusive scan of an associative ``combine`` along the LAST axis.

    Args:
        combine: ``combine(earlier, later) -> composed``, associative in
            index order, broadcasting over any leading axes.
        identity: The identity element; each leaf carries a singleton lane
            axis (e.g. ``(m*m, 1)``) so it broadcasts against any width.
        elems: A tuple of tensors, all with the scan axis last (length N).
        reverse: Scan right-to-left.

    Returns:
        A tuple like ``elems``: at lane k, the composition of all elements
        strictly before (after, if ``reverse``) k.

    Strategy: split the lane axis into blocks of ``_BLOCK``; phase 1 runs
    the block-local exclusive scan sequentially over the block position,
    batched across blocks on the lane axis; phase 2 recurses on the block
    totals; phase 3 folds each block's prefix into its local states.
    """
    n = elems[0].shape[-1]

    def seq(front: Tree) -> tuple[Tree, Tree]:
        """Sequential exclusive scan over leading-axis-stacked elements."""
        carry = tuple(
            torch.broadcast_to(i, e.shape[1:]) for e, i in zip(front, identity)
        )
        steps = front[0].shape[0]
        excl: list[Tree] = [()] * steps
        for k in range(steps - 1, -1, -1) if reverse else range(steps):
            elem = tuple(e[k] for e in front)
            excl[k] = carry
            carry = combine(elem, carry) if reverse else combine(carry, elem)
        stacked = tuple(
            torch.stack([x[j] for x in excl]) for j in range(len(front))
        )
        return stacked, carry

    if n <= _SEQ_CUTOFF:
        # Move the lane axis to the step position, keeping a singleton lane
        # axis so the combine's lane-major contraction stays valid.
        front = tuple(torch.movedim(x, -1, 0)[..., None] for x in elems)
        excl, _ = seq(front)
        return tuple(torch.movedim(x[..., 0], 0, -1) for x in excl)

    block = _BLOCK
    while n > block * _ASSOC_CUTOFF:
        block *= 2
    num_blocks = -(-n // block)
    pad = num_blocks * block - n

    def pad_and_fill(x: torch.Tensor, ident: torch.Tensor) -> torch.Tensor:
        if pad:
            fill = torch.broadcast_to(ident, x.shape[:-1] + (pad,))
            x = torch.cat([fill, x] if reverse else [x, fill], dim=-1)
        # (..., nb*c) -> (c, ..., nb): the block index stays on lanes.
        x = x.reshape(x.shape[:-1] + (num_blocks, block))
        return torch.movedim(x, -1, 0)

    blocked = tuple(pad_and_fill(x, i) for x, i in zip(elems, identity))

    # Phase 1: block-local exclusive scan, batched over blocks on lanes.
    local_excl, totals = seq(blocked)
    # Phase 2: recurse on the per-block totals (lane axis = num_blocks).
    block_prefix = monoid_scan(combine, identity, totals, reverse=reverse)
    # Phase 3: fold each block's prefix into its local states.
    out = (
        combine(local_excl, block_prefix)
        if reverse
        else combine(block_prefix, local_excl)
    )

    def unblock(x: torch.Tensor) -> torch.Tensor:
        x = torch.movedim(x, 0, -1)  # (..., nb, c)
        x = x.reshape(x.shape[:-2] + (num_blocks * block,))
        return x[..., pad:] if (reverse and pad) else x[..., :n]

    return tuple(unblock(x) for x in out)


# ---------------------------------------------------------------------------
# Stacked m×m algebra: (..., m*k, N) tensors, components at axis -2.
#
# Up to 4 rows and columns each product is written out as elementwise
# products of rows, the JAX package's form. Above that, which the Python
# loops would make O(m^3) tensor operations, the stacked operands are viewed
# as batched matrices, data axis first, and multiplied with one `matmul`.
# ---------------------------------------------------------------------------

_ROW_LOOP_MAX = 4


def _big(*dims: int) -> bool:
    return max(dims) > _ROW_LOOP_MAX


def _mat(X, rows, cols):
    """Stacked (..., rows*cols, N) -> batched matrices (..., N, rows, cols)."""
    return torch.movedim(X.unflatten(-2, (rows, cols)), -1, -3)


def _unmat(Y):
    """Batched matrices (..., N, rows, cols) -> stacked (..., rows*cols, N)."""
    return torch.movedim(Y, -3, -1).flatten(-3, -2)


def _smm(A, B, m, k, r):
    """Stacked matmul: (..., m*k, N) x (..., k*r, N) -> (..., m*r, N)."""
    if _big(m, k, r):
        return _unmat(torch.matmul(_mat(A, m, k), _mat(B, k, r)))
    rows = []
    for i in range(m):
        for j in range(r):
            acc = A[..., i * k, :] * B[..., j, :]
            for l in range(1, k):
                acc = acc + A[..., i * k + l, :] * B[..., l * r + j, :]
            rows.append(acc)
    return torch.stack(rows, dim=-2)


def _smm_t(A, B, m, k, r):
    """Stacked ``A @ B^T``: (..., m*k, N) x (..., r*k, N) -> (..., m*r, N)."""
    if _big(m, k, r):
        return _unmat(torch.matmul(_mat(A, m, k), _mat(B, r, k).mT))
    rows = []
    for i in range(m):
        for j in range(r):
            acc = A[..., i * k, :] * B[..., j * k, :]
            for l in range(1, k):
                acc = acc + A[..., i * k + l, :] * B[..., j * k + l, :]
            rows.append(acc)
    return torch.stack(rows, dim=-2)


def _st(A, m, k):
    """Stacked transpose: (..., m*k, N) -> (..., k*m, N)."""
    if _big(m, k):
        return _unmat(_mat(A, m, k).mT)
    return torch.stack(
        [A[..., i * k + j, :] for j in range(k) for i in range(m)], dim=-2
    )


def _sadd_eye(X, m):
    """Add the m x m identity to a stacked (..., m*m, N) matrix."""
    if _big(m):
        return X + _seye(m, X)
    return torch.stack(
        [
            X[..., c, :] + 1.0 if c % (m + 1) == 0 else X[..., c, :]
            for c in range(m * m)
        ],
        dim=-2,
    )


def _smv(M, v, m, k):
    """Stacked matvec: (..., m*k, N) x (..., k, N) -> (..., m, N)."""
    if _big(m, k):
        return _smm(M, v, m, k, 1)
    rows = []
    for i in range(m):
        acc = M[..., i * k, :] * v[..., 0, :]
        for l in range(1, k):
            acc = acc + M[..., i * k + l, :] * v[..., l, :]
        rows.append(acc)
    return torch.stack(rows, dim=-2)


def _souter(u, v):
    """Stacked outer: (..., m, N) x (..., r, N) -> (..., m*r, N)."""
    m, r = u.shape[-2], v.shape[-2]
    if _big(m, r):
        return (u.unsqueeze(-2) * v.unsqueeze(-3)).flatten(-3, -2)
    return torch.stack(
        [u[..., i, :] * v[..., j, :] for i in range(m) for j in range(r)],
        dim=-2,
    )


def _seye(m: int, like: torch.Tensor) -> torch.Tensor:
    """Stacked identity with a broadcastable singleton lane axis."""
    return torch.eye(m, dtype=like.dtype, device=like.device).reshape(m * m, 1)


def _inv4_components(Mc):
    """Closed-form 4x4 inverse as 16 components, via block-Schur on 2x2s.

    With ``M = [[P, Q], [R, S]]`` in 2x2 blocks and ``T = S - R P^-1 Q``::

        M^-1 = [[P^-1 + P^-1 Q T^-1 R P^-1,  -P^-1 Q T^-1],
                [-T^-1 R P^-1,                T^-1        ]]

    The scan merges' ``M = I + F G`` operands are near the identity, so the
    pivot-free block elimination is safe there.
    """

    def inv2(x):
        a, b, c, d = x
        idet = 1.0 / (a * d - b * c)
        return [d * idet, -b * idet, -c * idet, a * idet]

    def mul2(x, y):
        a, b, c, d = x
        e, f, g, h = y
        return [a * e + b * g, a * f + b * h, c * e + d * g, c * f + d * h]

    p = [Mc[0], Mc[1], Mc[4], Mc[5]]
    q = [Mc[2], Mc[3], Mc[6], Mc[7]]
    r_ = [Mc[8], Mc[9], Mc[12], Mc[13]]
    s = [Mc[10], Mc[11], Mc[14], Mc[15]]
    pinv = inv2(p)
    rpinv = mul2(r_, pinv)
    t = [si - xi for si, xi in zip(s, mul2(rpinv, q))]
    tinv = inv2(t)
    pinvq = mul2(pinv, q)
    tl = mul2(tinv, rpinv)  # T^-1 R P^-1
    tr = mul2(pinvq, tinv)  # P^-1 Q T^-1
    topleft = [pi + xi for pi, xi in zip(pinv, mul2(tr, rpinv))]
    out = [None] * 16
    out[0], out[1], out[4], out[5] = topleft
    out[2], out[3], out[6], out[7] = [-x for x in tr]
    out[8], out[9], out[12], out[13] = [-x for x in tl]
    out[10], out[11], out[14], out[15] = tinv
    return out


def _ssolve(M, B, m, r):
    """Stacked ``solve(M, B)`` with closed-form inverses for m <= 4."""
    if m == 1:
        return B / M[..., :1, :]
    if m == 2:
        a, b = M[..., 0, :], M[..., 1, :]
        c, d = M[..., 2, :], M[..., 3, :]
        inv_det = 1.0 / (a * d - b * c)
        inv = torch.stack([d, -b, -c, a], dim=-2) * inv_det[..., None, :]
        return _smm(inv, B, m, m, r)
    if m == 3:
        a, b, c = M[..., 0, :], M[..., 1, :], M[..., 2, :]
        d, e, f = M[..., 3, :], M[..., 4, :], M[..., 5, :]
        g, h, i = M[..., 6, :], M[..., 7, :], M[..., 8, :]
        A = e * i - f * h
        Bc = -(d * i - f * g)
        C = d * h - e * g
        D = -(b * i - c * h)
        E = a * i - c * g
        F = -(a * h - b * g)
        G = b * f - c * e
        H = -(a * f - c * d)
        I = a * e - b * d
        inv_det = 1.0 / (a * A + b * Bc + c * C)
        inv = (
            torch.stack([A, D, G, Bc, E, H, C, F, I], dim=-2)
            * inv_det[..., None, :]
        )
        return _smm(inv, B, m, m, r)
    if m == 4:
        comps = [M[..., k, :] for k in range(16)]
        inv = torch.stack(_inv4_components(comps), dim=-2)
        return _smm(inv, B, m, m, r)
    # General case: unstack to batched matrices for an LU solve.
    Mb = torch.movedim(M.reshape(M.shape[:-2] + (m, m, M.shape[-1])), -1, -3)
    Bb = torch.movedim(B.reshape(B.shape[:-2] + (m, r, B.shape[-1])), -1, -3)
    out = torch.movedim(torch.linalg.solve(Mb, Bb), -3, -1)
    return out.reshape(out.shape[:-3] + (m * r, out.shape[-1]))


# ---------------------------------------------------------------------------
# The recurrences.
# ---------------------------------------------------------------------------


def _affine_scan_s(As, Bs, m, r, *, reverse: bool, exclusive: bool):
    """Stacked affine scan: As (m*m, N), Bs (m*r, N) -> the states.

    With r > 1 columns, the columns ride on a leading batch axis as r
    single-column scans that share the transitions, so the combine's
    Python-level rows stay m wide (the algebra per column is the same).
    """
    if r > 1:
        Bb = Bs.reshape(m, r, -1).transpose(0, 1)
        e = _affine_scan_s(As[None], Bb, m, 1, reverse=reverse, exclusive=exclusive)
        return e.transpose(0, 1).reshape(m * r, -1)

    def combine(earlier, later):
        A_e, B_e = earlier
        A_l, B_l = later
        if reverse:
            # Suffix composition: the earlier map applies on the outside.
            return (
                _smm(A_e, A_l, m, m, m),
                _smm(A_e, B_l, m, m, r) + B_e,
            )
        return (
            _smm(A_l, A_e, m, m, m),
            _smm(A_l, B_e, m, m, r) + B_l,
        )

    identity = (_seye(m, As), Bs.new_zeros((m * r, 1)))
    excl = monoid_scan(combine, identity, (As, Bs), reverse=reverse)
    if exclusive:
        return excl[1]
    pair = (As, Bs)
    incl = combine(pair, excl) if reverse else combine(excl, pair)
    return incl[1]


def _riccati_elements(d, ps, qs, as_):
    """The Riccati flow's elements ``(A, F, G)``, stacked::

        A_k = a_k - q_k p_k^T / d_k,  F_k = q_k q_k^T / d_k,
        G_k = -p_k p_k^T / d_k.
    """
    inv_d = 1.0 / d
    return (as_ - _souter(qs, ps) * inv_d, _souter(qs, qs) * inv_d,
            -_souter(ps, ps) * inv_d)


def _riccati_combine(m):
    """The Möbius merge of two stacked Riccati values: with
    ``M = I + F_e G_l``::

        A = A_l M^-1 A_e
        F = F_l + A_l M^-1 F_e A_l^T
        G = G_e + A_e^T M^-T G_l A_e
    """

    def combine(earlier, later):
        A_e, F_e, G_e = earlier
        A_l, F_l, G_l = later
        M = _sadd_eye(_smm(F_e, G_l, m, m, m), m)
        A = _smm(A_l, _ssolve(M, A_e, m, m), m, m, m)
        F = F_l + _smm_t(
            _smm(A_l, _ssolve(M, F_e, m, m), m, m, m), A_l, m, m, m
        )
        G = G_e + _smm(
            _smm(_st(A_e, m, m), _ssolve(_st(M, m, m), G_l, m, m), m, m, m),
            A_e,
            m,
            m,
            m,
        )
        return A, F, G

    return combine


def _riccati_scan_s(d, ps, qs, as_, m):
    """Stacked Riccati flow: the exclusive prefix F (m*m, N) from F_0 = 0,
    the elements of :func:`_riccati_elements` composed by the merge of
    :func:`_riccati_combine`."""
    zeros = ps.new_zeros((m * m, 1))
    identity = (_seye(m, ps), zeros, zeros)
    _, F, _ = monoid_scan(
        _riccati_combine(m), identity, _riccati_elements(d, ps, qs, as_)
    )
    return F


def riccati_fold_rank_one(d, ps, qs, as_, m, init=None):
    """Fold a chunk of Riccati elements, in order, into a running value
    ``(A, F, G)`` with the rank-one step: the plain version of the
    one-launch kernels' team fold (``csrc/quasisep_tc.cuh``:
    ``RicOp::fold``, ``RicOp::fold_map``).

    Each element's map is rank-one (:func:`_riccati_elements`), so its
    merge after ``(A, F, G)`` needs no inverse: with ``f = F p``, the
    chunk-local Schur complement ``c = d - p^T f``, ``u = q - a f`` and
    ``w = A^T p``::

        A' = a A - u w^T / c
        F' = a F a^T + u u^T / c
        G' = G - w w^T / c

    equal to :func:`_riccati_combine` of the running value and the
    element. Operands are stacked over the chunk's last axis (any leading
    axes broadcast): ``d`` ``(..., L)``, ``ps``/``qs`` ``(..., m, L)``,
    ``as_`` ``(..., m*m, L)``. ``init`` is a running value ``(A, F, G)``,
    each ``(..., m*m, 1)``; by default the identity (``A = I``,
    ``F = G = 0``). Returns the folded value, each ``(..., m*m, 1)``.
    """
    if init is None:
        zeros = ps.new_zeros((m * m, 1))
        init = (_seye(m, ps), zeros, zeros)
    A, F, G = init
    for k in range(ps.shape[-1]):
        p, q, a = ps[..., k : k + 1], qs[..., k : k + 1], as_[..., k : k + 1]
        f = _smv(F, p, m, m)
        c = (d[..., k : k + 1] - torch.sum(p * f, dim=-2)).unsqueeze(-2)
        u = q - _smv(a, f, m, m)
        w = _smv(_st(A, m, m), p, m, m)
        A = _smm(a, A, m, m, m) - _souter(u, w) / c
        F = _smm_t(_smm(a, F, m, m, m), a, m, m, m) + _souter(u, u) / c
        G = G - _souter(w, w) / c
    return A, F, G


def _sshift_lane(X, fill, reverse: bool):
    """Shift stacked leaves one step along the lane axis, filling the end."""
    fill = torch.broadcast_to(fill, X.shape[:-1] + (1,))
    if reverse:
        return torch.cat([fill, X[..., :-1]], dim=-1)
    return torch.cat([X[..., 1:], fill], dim=-1)


def _affine_bwd_s(As, es, ebar_s, m, r, *, reverse: bool, exclusive: bool, scan=None):
    """Stacked cotangents ``(Abar, Bbar)`` of :func:`_affine_scan_s`.

    The adjoint of a linear recurrence is one opposite-direction affine
    scan with the transposed transitions, plus outer products (indices of
    the forward scan; reverse mirrors)::

        gbar_k = A_{k+1}^T gbar_{k+1} + ebar_{k(+1)}
        Bbar_k = gbar_k
        Abar_k = gbar_k g_{k-1}^T

    ``es`` are the scan's outputs for the same ``reverse``/``exclusive``.
    ``scan`` runs the adjoint scan (the signature of
    :func:`_affine_scan_s`, which is the default): the differentiable
    wrapper ``cuda_scan.affine`` in the scans' own backward.
    """
    At = _st(As, m, m)
    if not exclusive:
        # The inclusive scan's adjoint consumes transitions shifted by one
        # step (identity fill) and pairs gbar with the exclusive outputs.
        At = _sshift_lane(At, _seye(m, At), reverse)
        es = _sshift_lane(es, es.new_zeros(()), not reverse)
    gbar = (scan or _affine_scan_s)(
        At, ebar_s, m, r, reverse=not reverse, exclusive=exclusive
    )
    return _smm_t(gbar, es, m, r, m), gbar


def _congruence_scan_s(As, Bs, m, *, reverse: bool):
    """Stacked congruence scan: the exclusive prefix of
    ``g = A g A^T + B`` from ``g = 0``; As, Bs (m*m, N)."""

    def combine(earlier, later):
        A_e, B_e = earlier
        A_l, B_l = later
        if reverse:
            return (
                _smm(A_e, A_l, m, m, m),
                _smm_t(_smm(A_e, B_l, m, m, m), A_e, m, m, m) + B_e,
            )
        return (
            _smm(A_l, A_e, m, m, m),
            _smm_t(_smm(A_l, B_e, m, m, m), A_l, m, m, m) + B_l,
        )

    identity = (_seye(m, As), Bs.new_zeros((m * m, 1)))
    return monoid_scan(combine, identity, (As, Bs), reverse=reverse)[1]


def _coupling_scan_s(As, Bs, Cs, m1, m2, *, reverse: bool, exclusive: bool):
    """Stacked coupling scan: the prefix of ``g = A g B^T + C`` from
    ``g = 0``, with As (m1*m1, N), Bs (m2*m2, N), Cs (m1*m2, N).

    The JAX package runs this recurrence (``ops._coupling_scan``) as a
    sequential ``lax.scan``; as a monoid ``(A, B, C)`` with the combine
    ``(A_l A_e, B_l B_e, A_l C_e B_l^T + C_l)`` it runs through the same
    blocked scan, and on the card through kernel B3.
    """

    def combine(earlier, later):
        if reverse:
            earlier, later = later, earlier
        A_e, B_e, C_e = earlier
        A_l, B_l, C_l = later
        return (
            _smm(A_l, A_e, m1, m1, m1),
            _smm(B_l, B_e, m2, m2, m2),
            _smm_t(_smm(A_l, C_e, m1, m1, m2), B_l, m1, m2, m2) + C_l,
        )

    identity = (_seye(m1, As), _seye(m2, Bs), Cs.new_zeros((m1 * m2, 1)))
    excl = monoid_scan(combine, identity, (As, Bs, Cs), reverse=reverse)
    if exclusive:
        return excl[2]
    elems = (As, Bs, Cs)
    incl = combine(elems, excl) if reverse else combine(excl, elems)
    return incl[2]


def _congruence_bwd_s(As, es, ebar_s, m, *, reverse: bool, scan=None):
    """Stacked cotangents ``(Abar, Bbar)`` of :func:`_congruence_scan_s`.

    The recurrence is linear in the state, so its adjoint is one
    opposite-direction congruence scan with the transposed transitions
    (indices of the forward scan; ``es`` its exclusive outputs)::

        gbar_k = A_{k+1}^T gbar_{k+1} A_{k+1} + ebar_{k+1}
        Bbar_k = gbar_k
        Abar_k = gbar_k A_k e_k^T + gbar_k^T A_k e_k

    which is the JAX package's ``(gbar + gbar^T) A e`` where the loads,
    and so the states, are symmetric; the general form keeps a second
    derivative through the Riccati adjoint (whose loads are not) exact.
    ``scan`` runs the adjoint scan (default :func:`_congruence_scan_s`).
    """
    gbar = (scan or _congruence_scan_s)(_st(As, m, m), ebar_s, m, reverse=not reverse)
    Abar = _smm_t(_smm(gbar, As, m, m, m), es, m, m, m) + _smm(
        _smm(_st(gbar, m, m), As, m, m, m), es, m, m, m
    )
    return Abar, gbar


def _coupling_bwd_s(As, Bs, es, ebar_s, m1, m2, *, reverse: bool, exclusive: bool, scan=None):
    """Stacked cotangents ``(Abar, Bbar, Cbar)`` of :func:`_coupling_scan_s`.

    The adjoint is one opposite-direction coupling scan with both
    transitions transposed, plus products with the states before each step
    (indices of the forward scan; reverse mirrors)::

        lam_k = A_{k+1}^T lam_{k+1} B_{k+1} + ebar_{k(+1)}
        Cbar_k = lam_k
        Abar_k = lam_k B_k g_{k-1}^T
        Bbar_k = lam_k^T A_k g_{k-1}

    ``es`` are the scan's outputs for the same ``reverse``/``exclusive``;
    the inclusive scan shifts as :func:`_affine_bwd_s` does. ``scan`` runs
    the adjoint scan (default :func:`_coupling_scan_s`).
    """
    At, Bt = _st(As, m1, m1), _st(Bs, m2, m2)
    if not exclusive:
        At = _sshift_lane(At, _seye(m1, At), reverse)
        Bt = _sshift_lane(Bt, _seye(m2, Bt), reverse)
        es = _sshift_lane(es, es.new_zeros(()), not reverse)
    lam = (scan or _coupling_scan_s)(
        At, Bt, ebar_s, m1, m2, reverse=not reverse, exclusive=exclusive
    )
    Abar = _smm_t(_smm(lam, Bs, m1, m2, m2), es, m1, m2, m1)
    Bbar = _smm(_smm(_st(lam, m1, m2), As, m2, m1, m1), es, m2, m1, m2)
    return Abar, Bbar, lam


def _riccati_bwd_s(res, Ybar_s, inv_c2=None, scan=None):
    """Adjoint of the Riccati flow via a reverse congruence scan.

    ``res = (d, ps, qs, as_, Fs)`` with ``Fs`` the flow's exclusive prefix;
    ``Ybar_s`` (m*m, N) is the cotangent of ``Fs``. ``inv_c2``, where
    given, is ``1 / c2`` as the caller already has it (``d`` is then not
    read). ``scan`` runs the congruence scan (default
    :func:`_congruence_scan_s`). Linearising
    ``phi(F) = a F a^T + u u^T / c2`` (``u = q - a F p``,
    ``c2 = d - p^T F p``) gives ``(dphi/dF)^T [G] = A~^T G A~`` with
    ``A~ = a - u p^T / c2``, so the state adjoint
    ``Fbar_k = Ybar_k + A~_k^T Fbar_{k+1} A~_k`` is a reverse congruence
    scan. With ``Gbar_k = Fbar_{k+1}`` and ``S = Gbar + Gbar^T``::

        qbar = S u / c2
        dbar = -(u . S u) / (2 c2^2)
        pbar = -F a^T S u / c2 + (u . S u) / c2^2 * F p
        abar = S a F - S u (F p)^T / c2

    Returns ``(dbar, pbar, qbar, abar)``.
    """
    d, ps, qs, as_, Fs = res
    m = ps.shape[0]
    Fp = _smv(Fs, ps, m, m)
    if inv_c2 is None:
        inv_c2 = 1.0 / (d - torch.sum(ps * Fp, dim=0))
    u = qs - _smv(as_, Fp, m, m)
    atil = as_ - _souter(u, ps) * inv_c2

    Gbar = (scan or _congruence_scan_s)(_st(atil, m, m), Ybar_s, m, reverse=True)
    S = Gbar + _st(Gbar, m, m)
    Su = _smv(S, u, m, m)
    uSu = torch.sum(u * Su, dim=0)

    qbar = Su * inv_c2
    dbar = -0.5 * uSu * inv_c2**2
    aTSu = _smv(_st(as_, m, m), Su, m, m)
    pbar = -_smv(Fs, aTSu, m, m) * inv_c2 + (uSu * inv_c2**2) * Fp
    abar = _smm(_smm(S, as_, m, m, m), Fs, m, m, m) - _souter(Su, Fp) * inv_c2
    return dbar, pbar, qbar, abar


# ---------------------------------------------------------------------------
# The row-major API of the QSM classes: (N, m, k) operands at the edges.
# ---------------------------------------------------------------------------


def _pack3(a: torch.Tensor) -> torch.Tensor:
    """(N, m, k) -> stacked (m*k, N), contiguous."""
    n, m, k = a.shape
    return a.permute(1, 2, 0).reshape(m * k, n).contiguous()


def _unpack3(s: torch.Tensor, m: int, k: int) -> torch.Tensor:
    """Stacked (m*k, N) -> (N, m, k)."""
    return s.reshape(m, k, s.shape[-1]).permute(2, 0, 1)


def affine_scan(
    A: torch.Tensor,
    B: torch.Tensor,
    *,
    reverse: bool = False,
    parallel: bool = True,
    exclusive: bool = True,
) -> torch.Tensor:
    """Prefix states of the affine recurrence ``g_k = A_k g_prev + B_k``.

    Args:
        A: Transitions, ``(N, m, m)``.
        B: Loads, ``(N, m, r)`` (or ``(N, m)`` for one right-hand side).
        reverse: Run right-to-left (``g_k = A_k g_{k+1} + B_k``).
        parallel: The monoid scan (kernel B3 on the card, the blocked plain
            scan on the CPU) or the sequential oracle, a loop over N.
        exclusive: Return the state before step k (the default) rather
            than after it.

    Returns:
        ``e`` with ``e.shape == B.shape``.
    """
    squeeze = B.ndim == 2
    if squeeze:
        B = B[..., None]
    if parallel:
        from tinygp_tpu_torch.solvers.quasisep import cuda_scan

        m, r = B.shape[1], B.shape[2]
        e = _unpack3(
            cuda_scan.affine(
                _pack3(A), _pack3(B), m, r, reverse=reverse, exclusive=exclusive
            ),
            m,
            r,
        )
    else:
        e = _sequential(
            lambda g, k: A[k] @ g + B[k], B, reverse=reverse, exclusive=exclusive
        )
    return e[..., 0] if squeeze else e


def congruence_scan(
    A: torch.Tensor,
    B: torch.Tensor,
    *,
    reverse: bool = False,
    parallel: bool = True,
) -> torch.Tensor:
    """Exclusive prefix of the congruence recurrence
    ``g_k = A_k g A_k^T + B_k``; ``A`` and ``B`` are ``(N, m, m)``."""
    if parallel:
        from tinygp_tpu_torch.solvers.quasisep import cuda_scan

        m = A.shape[-1]
        e = cuda_scan.congruence(_pack3(A), _pack3(B), m, reverse=reverse)
        return _unpack3(e, m, m)
    return _sequential(
        lambda g, k: A[k] @ g @ A[k].T + B[k], B, reverse=reverse, exclusive=True
    )


def riccati_scan(
    d: torch.Tensor,
    p: torch.Tensor,
    q: torch.Tensor,
    a: torch.Tensor,
    *,
    parallel: bool = True,
) -> torch.Tensor:
    """Exclusive prefix ``F`` ``(N, m, m)`` of the Riccati covariance flow
    ``F' = a F a^T + u u^T / c2`` with ``u = q - a F p`` and
    ``c2 = d - p^T F p``, from ``F_0 = 0``; ``d`` ``(N,)``, ``p``/``q``
    ``(N, m)``, ``a`` ``(N, m, m)``. The monoid form is
    :func:`_riccati_scan_s`'s."""
    m = p.shape[1]
    if parallel:
        from tinygp_tpu_torch.solvers.quasisep import cuda_scan

        F = cuda_scan.riccati(d, p.T.contiguous(), q.T.contiguous(), _pack3(a))
        return _unpack3(F, m, m)

    def step(F, k):
        Fp = F @ p[k]
        u = q[k] - a[k] @ Fp
        return a[k] @ F @ a[k].T + torch.outer(u, u) / (d[k] - p[k] @ Fp)

    return _sequential(step, p.new_zeros(p.shape[0], m, m), reverse=False, exclusive=True)


def _sequential(step, like: torch.Tensor, *, reverse: bool, exclusive: bool):
    """The sequential oracle: ``g <- step(g, k)`` over k from ``g = 0``,
    stacking the state before (``exclusive``) or after each step."""
    n = like.shape[0]
    g = like.new_zeros(like.shape[1:])
    out = [None] * n
    for k in range(n - 1, -1, -1) if reverse else range(n):
        new = step(g, k)
        out[k] = g if exclusive else new
        g = new
    return torch.stack(out)
