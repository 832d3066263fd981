"""The fused quasiseparable log-likelihood and its gradient: CUDA kernels,
wrappers and plain versions.

Counterpart of ``tinygp_tpu/solvers/quasisep/pallas_loglik.py``. For
``K = diag(d) + tril(p, q, a) + tril^T`` the forward computes ``(quad,
logdet) = (sum alpha^2, sum log c)``, running the Riccati scan, the
Cholesky emissions, the whitening scan and both reductions on the card.
Three kernels replace the TPU's:

- **B1** (``csrc/quasisep_loglik.cu``, entries ``qsl_loglik_*``) replaces
  ``pallas_loglik._loglik_kernel`` with ``residuals=False``: the value
  alone, for calls that need no gradient.
- **B1r** (the same source, entries ``qsl_loglik_res_*``) replaces it with
  ``residuals=True``: the value plus the residuals the backward reads,
  the Riccati prefix ``Fs (m*m, N)``, the whitening states ``e (m, N)``
  and ``ic = 1/c (N,)``. Up to m = 4 each is one launch (and one memset
  of its flags): tiles taken by a ticket, each staged once in shared
  memory, the Riccati flow folded with the rank-one step, and a look-back
  that combines the earlier tiles' aggregates in one fixed order, so two
  launches agree bit for bit; :func:`plain_loglik_terms_res_tiled` is its
  association in plain PyTorch, :func:`b1_schedule` its tiles.
- **B2** (``csrc/quasisep_loglik_bwd.cu``) replaces
  ``pallas_loglik._bwd_kernel``: from the residuals and the two scalar
  cotangents, the cotangents of ``(d, ps, qs, as_, y)``, through a reverse
  affine-adjoint scan and a reverse congruence scan: one launch, in the
  same design run backwards; :func:`plain_loglik_bwd_tiled` is its
  association in plain PyTorch, :func:`b2_schedule` its tiles.

Those sources are templated for m = 1..4. For 4 < m <= 32 the same three
entry points run sources with the same C interface, each kernel one launch
and one memset: ``csrc/quasisep_loglik_generic.cu`` at m = 5..16 (a warp
a team, at m = 9..16 for B2 and at every order for B1 and B1r each
product on the float64 tensor cores) and ``csrc/quasisep_loglik_wide.cu``
at m = 17..32 (a block a team). Above 32 a CUDA operand raises (ROADMAP
item N10).

Every scan runs in float64 for float32 operands too: composed in float32,
the Riccati maps of long spans lose the state (see the note in the
source). The residuals are stored in the operands' type.

:func:`fused_loglik_terms` is the entry. When grad is enabled and an
operand requires it, it goes through :class:`FusedLoglik`, a
``torch.autograd.Function`` whose forward is B1r and whose backward is B2
(itself a ``Function``, :class:`_LoglikBwd`); otherwise it runs B1 (the
``Function`` :class:`_LoglikValue`). Each of the three wrappers
(:func:`fused_loglik_terms` without grad, :func:`fused_loglik_res`,
:func:`fused_loglik_bwd`) runs its plain PyTorch version for CPU tensors
and launches its kernel for CUDA tensors, or raises; none falls back. Each
launch adds one to its counter: :data:`LAUNCHES` (B1), :data:`LAUNCHES_RES`
(B1r), :data:`LAUNCHES_BWD` (B2); a launch above m = 4 also to
:data:`LAUNCHES_GENERIC`.

**A chain axis.** The three ``Function`` classes have ``vmap`` rules, so that
``torch.func.vmap(torch.func.grad_and_value(f))`` of a log density that
reaches them (the samplers' batched gradient) launches one kernel for all
chains: :func:`fused_loglik_res_chains`, :func:`fused_loglik_bwd_chains` and
:func:`fused_loglik_terms_chains` take operands with a leading chain axis,
or without one where every chain shares them (such as the data ``y``), and
up to m = 4 run B1r, B2 or B1 once over (chain, tile) (the C entries
``qsl_loglik_chains_*``, ``qsl_loglik_bwd_chains_*``), each chain's result
bit for bit the unbatched launch's on its operands. Each such launch also
adds one to :data:`LAUNCHES_CHAINS`. Above m = 4 they launch the unbatched
kernel once for each chain (ROADMAP N9b). On CPU tensors they run the
plain chain-axis versions (:func:`plain_loglik_terms_res_chains`,
:func:`plain_loglik_bwd_chains`): up to N = 512 the sequential recurrences
for all chains at once, above it the plain versions mapped with
``torch.func.vmap``.
"""

from __future__ import annotations

__all__ = [
    "LAUNCHES",
    "LAUNCHES_RES",
    "LAUNCHES_BWD",
    "LAUNCHES_GENERIC",
    "LAUNCHES_CHAINS",
    "FusedLoglik",
    "fused_loglik_terms",
    "fused_loglik_res",
    "fused_loglik_bwd",
    "fused_loglik_terms_chains",
    "fused_loglik_res_chains",
    "fused_loglik_bwd_chains",
    "plain_loglik_terms",
    "plain_loglik_terms_res",
    "plain_loglik_bwd",
    "plain_loglik_terms_res_chains",
    "plain_loglik_bwd_chains",
    "plain_loglik_terms_tiled",
    "plain_loglik_terms_res_tiled",
    "plain_loglik_bwd_tiled",
    "b1_schedule",
    "b2_schedule",
]

import ctypes
import functools

import torch

from tinygp_tpu_torch import cuda_build
from tinygp_tpu_torch.solvers.quasisep import scan as _scan

LAUNCHES = 0
"""Calls that launched kernel B1 (one per call of its C entry: one kernel
launch and one memset)."""
LAUNCHES_RES = 0
"""Calls that launched kernel B1r, the forward with residuals."""
LAUNCHES_BWD = 0
"""Calls that launched kernel B2, the backward."""
LAUNCHES_GENERIC = {"b1": 0, "b1r": 0, "b2": 0}
"""Of those, the calls above m = 4 (``quasisep_loglik_generic.cu``,
``quasisep_loglik_wide.cu``)."""
LAUNCHES_CHAINS = {"b1": 0, "b1r": 0, "b2": 0}
"""Of those, the launches over a chain axis (every chain in one kernel,
m <= 4)."""

_MAX_M = 4  # the templated kernels' orders
_MAX_TC_M = 16  # quasisep_loglik_generic.cu's; quasisep_loglik_wide.cu's above
_MAX_GENERIC_M = 32
_DTYPES = {torch.float32: "f32", torch.float64: "f64"}


# ---------------------------------------------------------------------------
# Plain versions.
# ---------------------------------------------------------------------------


def plain_loglik_terms_res(
    d: torch.Tensor,
    ps: torch.Tensor,
    qs: torch.Tensor,
    as_: torch.Tensor,
    y: torch.Tensor,
) -> tuple[torch.Tensor, ...]:
    """``(quad, logdet, Fs, e, ic)`` in plain PyTorch: the Riccati scan,
    the Cholesky emissions and the whitening affine scan, all stacked, with
    the residuals of B1r (``pallas_loglik._call_kernel(residuals=True)``)."""
    m = ps.shape[0]
    Fs = _scan._riccati_scan_s(d, ps, qs, as_, m)

    # Cholesky emissions: c_k = sqrt(d_k - p^T F p), w_k = (q - a F p) / c.
    Fp = _scan._smv(Fs, ps, m, m)
    c2 = d - torch.sum(ps * Fp, dim=0)
    c = torch.sqrt(c2)
    inv_c = 1.0 / c
    w = (qs - _scan._smv(as_, Fp, m, m)) * inv_c

    # Whitening solve L alpha = y with L = diag(c) + strict_lower(p, w, a):
    # the diagonal folds into the transition.
    wd = w * inv_c
    A = as_ - _scan._souter(wd, ps)
    e = _scan._affine_scan_s(A, wd * y, m, 1, reverse=False, exclusive=True)
    alpha = (y - torch.sum(ps * e, dim=0)) * inv_c
    quad = torch.sum(torch.square(alpha))
    # The scans return strided views; the residuals are stored contiguous,
    # as the kernels write and read them.
    return quad, torch.sum(torch.log(c)), Fs.contiguous(), e.contiguous(), inv_c


def plain_loglik_terms(
    d: torch.Tensor,
    ps: torch.Tensor,
    qs: torch.Tensor,
    as_: torch.Tensor,
    y: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(alpha . alpha, sum(log c))`` in plain PyTorch (B1's plain
    version)."""
    return plain_loglik_terms_res(d, ps, qs, as_, y)[:2]


def plain_loglik_bwd(
    ps: torch.Tensor,
    qs: torch.Tensor,
    as_: torch.Tensor,
    y: torch.Tensor,
    Fs: torch.Tensor,
    e: torch.Tensor,
    ic: torch.Tensor,
    qbar: torch.Tensor,
    lbar: torch.Tensor,
) -> tuple[torch.Tensor, ...]:
    """``(dbar, psbar, qsbar, asbar, ybar)``: B2's plain version.

    The formulas of ``pallas_loglik._bwd_kernel``, stacked. The emissions
    are recomputed elementwise from the residuals; the two reverse scans
    are the hand-written adjoints of ``scan.py``:
    :func:`~tinygp_tpu_torch.solvers.quasisep.scan._affine_bwd_s` for the
    whitening scan (loads ``ebar``) and
    :func:`~tinygp_tpu_torch.solvers.quasisep.scan._riccati_bwd_s` for the
    Riccati flow (loads ``Ybar``), with the glue between them. The
    whitening transitions ``A = a - wd p^T`` equal the Riccati
    linearisation, so both scans run over ``A^T``, as B2's do.
    ``qbar``/``lbar`` are the scalar cotangents of ``quad``/``logdet``.
    """
    m = ps.shape[0]
    smv, st, souter = _scan._smv, _scan._st, _scan._souter

    # Elementwise recompute of the forward emissions.
    ic2 = ic * ic
    Fp = smv(Fs, ps, m, m)
    u = qs - smv(as_, Fp, m, m)
    wd = u * ic2
    alpha = (y - torch.sum(ps * e, dim=0)) * ic
    alphabar = 2.0 * qbar * alpha
    ebar = -(alphabar * ic) * ps

    # Adjoint of the whitening scan e = exclusive affine scan of
    # (A, wd * y): a reverse exclusive scan of (A^T, ebar) gives
    # mu_k = lambda_{k+1}, and Abar = mu e^T.
    A = as_ - souter(wd, ps)
    Abar, mu = _scan._affine_bwd_s(A, e, ebar, m, 1, reverse=False, exclusive=True)

    # Cotangent glue: the direct F cotangent (the congruence loads).
    wdbar = mu * y - smv(Abar, ps, m, m)
    ubar = wdbar * ic2
    icbar = -lbar / ic + alphabar * alpha / ic + 2.0 * ic * torch.sum(u * wdbar, dim=0)
    c2bar = -0.5 * icbar * ic * ic2
    Fpbar = -smv(st(as_, m, m), ubar, m, m) - c2bar * ps
    Ybar = souter(Fpbar, ps)

    # Adjoint of the Riccati flow: a reverse exclusive congruence scan of
    # (A^T, Ybar), Gbar_k = Fbar_{k+1}, whose transitions are the same A
    # (its linearisation a - u p^T / c2), then the input cotangents.
    r_dbar, r_psbar, r_qsbar, r_asbar = _scan._riccati_bwd_s(
        (None, ps, qs, as_, Fs), Ybar, inv_c2=ic2
    )

    dbar = c2bar + r_dbar
    psbar = (
        -alphabar * ic * e
        - smv(st(Abar, m, m), wd, m, m)
        - c2bar * Fp
        + smv(st(Fs, m, m), Fpbar, m, m)
        + r_psbar
    )
    qsbar = ubar + r_qsbar
    asbar = Abar - souter(ubar, Fp) + r_asbar
    ybar = alphabar * ic + torch.sum(wd * mu, dim=0)
    return dbar, psbar, qsbar, asbar, ybar


# The operands' ranks without a chain axis, in the order of the arguments
# of B1/B1r (d, ps, qs, as_, y) and of B2 (ps, qs, as_, y, Fs, e, ic, qbar,
# lbar), and their names.
_FWD = (("d", 1), ("ps", 2), ("qs", 2), ("as_", 2), ("y", 1))
_BWD = (("ps", 2), ("qs", 2), ("as_", 2), ("y", 1), ("Fs", 2), ("e", 2), ("ic", 1),
        ("qbar", 0), ("lbar", 0))


def _batched(operands, ranks) -> list[bool]:
    """Which operands carry a leading chain axis (one rank more than
    unbatched)."""
    return [x.ndim == r + 1 for x, (_, r) in zip(operands, ranks)]


# Up to this length the plain chain-axis versions run the sequential
# recurrences over the elements (about a dozen small operations a step for
# all chains); above it, the plain versions mapped with torch.func.vmap,
# whose blocked scans take about a hundred sequential merges at any length.
_SEQ_CHAINS_MAX = 512


def _bmv(A, x):
    """Batched matrix-vector product over leading axes."""
    return (A @ x[..., None])[..., 0]


def _outer(u, v):
    return u[..., :, None] * v[..., None, :]


def _mats(x, m=None):
    """Stacked ``(..., rows, N)`` -> element-major ``(..., N, rows)``, or
    with ``m`` (``rows = m * m``) ``(..., N, m, m)``."""
    x = torch.movedim(x, -1, -2)
    return x if m is None else x.unflatten(-1, (m, m))


def _seq_res_chains(d, ps, qs, as_, y):
    """B1r for every chain by the sequential recurrences: the Riccati flow
    ``F' = a F a^T + u u^T / c2`` and the whitening ``e' = a e + wd (y -
    p.e)`` from 0, one element at a time, all chains at once."""
    m, n = ps.shape[-2:]
    p, q, a = _mats(ps), _mats(qs), _mats(as_, m)
    lead = torch.broadcast_shapes(d.shape[:-1], p.shape[:-2], q.shape[:-2], a.shape[:-3],
                                  y.shape[:-1])
    F = ps.new_zeros(*lead, m, m)
    e = ps.new_zeros(*lead, m)
    Fs, es, c2s, rs = [], [], [], []
    for k in range(n):
        pk, ak = p[..., k, :], a[..., k, :, :]
        Fs.append(F)
        es.append(e)
        Fp = _bmv(F, pk)
        c2 = d[..., k] - torch.sum(pk * Fp, dim=-1)
        u = q[..., k, :] - _bmv(ak, Fp)
        wd = u / c2[..., None]
        r = y[..., k] - torch.sum(pk * e, dim=-1)
        e = _bmv(ak, e) + wd * r[..., None]
        F = ak @ F @ ak.mT + _outer(u, wd)
        c2s.append(c2)
        rs.append(r)
    ic = 1.0 / torch.sqrt(torch.stack(c2s, dim=-1))
    alpha = torch.stack(rs, dim=-1) * ic
    Fs = torch.stack(Fs, dim=-1).flatten(-3, -2)
    es = torch.stack(es, dim=-1)
    return (torch.sum(torch.square(alpha), dim=-1), -torch.sum(torch.log(ic), dim=-1),
            Fs, es, ic)


def _seq_bwd_chains(ps, qs, as_, y, Fs, e, ic, qbar, lbar):
    """B2 for every chain by the sequential reverse recurrences of
    :func:`plain_loglik_bwd_tiled` (the affine adjoint ``lambda' = A^T
    lambda + ebar`` and the congruence adjoint ``G' = A^T G A + Fpbar
    p^T`` from 0 at the last element), then its outputs elementwise."""
    m, n = ps.shape[-2:]
    p, q, ev = _mats(ps), _mats(qs), _mats(e)
    a, F = _mats(as_, m), _mats(Fs, m)
    qb = qbar[..., None]
    lb = torch.broadcast_to(lbar[..., None], torch.broadcast_shapes(lbar.shape + (1,), ic.shape))

    # The elements' emissions.
    ic2 = ic * ic
    Fp = _bmv(F, p)
    u = q - _bmv(a, Fp)
    wd = u * ic2[..., None]
    r = y - torch.sum(p * ev, dim=-1)
    alpha = r * ic
    alphabar = 2.0 * qb * alpha
    At = a.mT - _outer(p, wd)
    ebar = -(alphabar * ic)[..., None] * p

    def glue(mu, k):
        """ubar, c2bar and Fpbar at element(s) k from mu."""
        rk, ick, ic2k = r[..., k], ic[..., k], ic2[..., k]
        wdbar = mu * rk[..., None]
        ubar = wdbar * ic2k[..., None]
        uw = torch.sum(u[..., k, :] * wdbar, dim=-1)
        icbar = -lb[..., k] / ick + alphabar[..., k] * alpha[..., k] / ick + 2.0 * ick * uw
        c2bar = -0.5 * icbar * ick * ic2k
        Fpbar = -c2bar[..., None] * p[..., k, :] - _bmv(a[..., k, :, :].mT, ubar)
        return ubar, c2bar, Fpbar

    lead = torch.broadcast_shapes(alphabar.shape[:-1], At.shape[:-3])
    lam = ps.new_zeros(*lead, m)
    G = ps.new_zeros(*lead, m, m)
    mus, Gbars = [None] * n, [None] * n
    for k in range(n - 1, -1, -1):
        mus[k], Gbars[k] = lam, G
        Fpbar = glue(lam, k)[2]
        Atk = At[..., k, :, :]
        lam = _bmv(Atk, lam) + ebar[..., k, :]
        G = Atk @ G @ Atk.mT + _outer(Fpbar, p[..., k, :])
    mu, Gbar = torch.stack(mus, dim=-2), torch.stack(Gbars, dim=-3)

    ubar, c2bar, Fpbar = glue(mu, slice(None))
    Sm = Gbar + Gbar.mT
    Su = _bmv(Sm, u)
    uSu = torch.sum(u * Su, dim=-1)
    wmu = torch.sum(wd * mu, dim=-1)
    aTSu = _bmv(a.mT, Su)
    ic4 = ic2 * ic2
    dbar = c2bar - 0.5 * uSu * ic4
    psbar = (
        -(alphabar * ic + wmu)[..., None] * ev
        - c2bar[..., None] * Fp
        + (uSu * ic4)[..., None] * Fp
        + _bmv(F.mT, Fpbar)
        - ic2[..., None] * _bmv(F, aTSu)
    )
    qsbar = ubar + Su * ic2[..., None]
    asbar = (_outer(mu, ev) - _outer(ubar, Fp) + Sm @ a @ F
             - _outer(Su * ic2[..., None], Fp))
    ybar = alphabar * ic + wmu

    def stacked(x):  # element-major (..., N, rows) -> (..., rows, N)
        return torch.movedim(x, -2, -1)

    return dbar, stacked(psbar), stacked(qsbar), stacked(asbar.flatten(-2)), ybar


def plain_loglik_terms_res_chains(
    d: torch.Tensor,
    ps: torch.Tensor,
    qs: torch.Tensor,
    as_: torch.Tensor,
    y: torch.Tensor,
) -> tuple[torch.Tensor, ...]:
    """``(quad, logdet, Fs, e, ic)`` of every chain, each with a leading
    chain axis, in plain PyTorch: the operands with a chain axis of one
    length C, or without one where every chain shares them. Up to N =
    512 the sequential recurrences, all chains at once; above,
    :func:`plain_loglik_terms_res` mapped over the chain axis with
    ``torch.func.vmap``."""
    ops = (d, ps, qs, as_, y)
    if ps.shape[-1] <= _SEQ_CHAINS_MAX:
        return _seq_res_chains(*ops)
    dims = tuple(0 if b else None for b in _batched(ops, _FWD))
    return torch.func.vmap(plain_loglik_terms_res, in_dims=dims)(*ops)


def plain_loglik_bwd_chains(
    ps: torch.Tensor,
    qs: torch.Tensor,
    as_: torch.Tensor,
    y: torch.Tensor,
    Fs: torch.Tensor,
    e: torch.Tensor,
    ic: torch.Tensor,
    qbar: torch.Tensor,
    lbar: torch.Tensor,
) -> tuple[torch.Tensor, ...]:
    """``(dbar, psbar, qsbar, asbar, ybar)`` of every chain in plain
    PyTorch, operands as :func:`plain_loglik_terms_res_chains` takes them
    (``qbar``/``lbar`` ``(C,)`` or 0-d): up to N = 512 the sequential
    reverse recurrences, above :func:`plain_loglik_bwd` mapped with
    ``torch.func.vmap``."""
    ops = (ps, qs, as_, y, Fs, e, ic, qbar, lbar)
    if ps.shape[-1] <= _SEQ_CHAINS_MAX:
        return _seq_bwd_chains(*ops)
    dims = tuple(0 if b else None for b in _batched(ops, _BWD))
    return torch.func.vmap(plain_loglik_bwd, in_dims=dims)(*ops)


_SMEM_BLOCK = 232448  # 227 KB, a block's shared memory on sm_90
_SMEM_SM = 233472  # 228 KB, a multiprocessor's


def _b2_tc_sub(m: int, nbytes: int) -> int:
    """Elements per team of B2's tensor-core kernel at m = 9..16
    (csrc/quasisep_loglik_generic.cu: b2t_sub): the most, up to 32, whose
    block fits 1 KB short of a block's shared memory beside its look-back
    maps and states (maps padded to 16 x 16)."""
    mp, st = 16 * (2 * 16 + 4), 16 * (16 + 4)
    fixed = 8 * (3 * mp + 2 * st + 4 * (3 * mp + 2 * st))
    sub = 32
    while sub > 1 and (fixed + 4 * sub * (5 * m + 7) * 8
                       + (2 + 3 * m + 2 * m * m) * (4 * sub + 1) * nbytes + 16
                       > _SMEM_BLOCK - 1024):
        sub -= 1
    return sub


# B2's association on the card, (tile, sub) by (m, bytes per value): the
# elements of a tile and of a team's run (csrc/quasisep_loglik_bwd.cu:
# b2_sub, one thread a team, 64 a tile; csrc/quasisep_loglik_generic.cu:
# b2g_sub and b2t_sub, one warp a team, 4 a tile; csrc/quasisep_loglik_wide.cu
# above m = 16, a tile of 32 one team).
_B2_SCHEDULE = {
    (m, nbytes): (64 * sub, sub) if m <= 4 else (4 * sub, sub) if m <= _MAX_TC_M else (sub, sub)
    for m in range(1, _MAX_GENERIC_M + 1) for nbytes in (4, 8)
    for sub in [(8 if m <= 2 else 2) if m <= 4
                else 32 if m > _MAX_TC_M
                else _b2_tc_sub(m, nbytes) if m > 8
                else (8 if nbytes == 8 else 16) if m == 8
                else 16 if m == 7 or (nbytes == 8 and m == 6) else 32]
}
# Above m = 8 (the tensor-core kernels) and for B1 and B1r above m = 4 the
# look-back folds a group of 16 tiles in runs of 4 (csrc/quasisep_tc.cuh:
# mono_lookback; quasisep_wide.cuh: wide_lookback).
_B2_TC_LOOK = {"runs": 4, "group": 16}


def _b1_tc_sub(m: int, nbytes: int) -> int:
    """Elements per team of B1's tensor-core kernel at m = 5..16
    (csrc/quasisep_loglik_generic.cu: b1t_sub): with maps padded to 8 the
    most, up to 64, whose block leaves two blocks a multiprocessor; padded
    to 16 the most, up to 32, whose block fits 1 KB short of a block's
    shared memory beside the Riccati flow's look-back maps and states."""
    P = 8 if m <= 8 else 16
    mp, st, scr = P * (3 * P + 4), P * (P + 4), P * (2 * P + 4)
    fixed = 8 * (3 * mp + 2 * st + 4 * (3 * mp + scr + st))
    room = _SMEM_SM // 2 - 1024 if P == 8 else _SMEM_BLOCK - 1024
    sub = 64 if P == 8 else 32
    while sub > 1 and (fixed + 4 * sub * (m + 1) * 8
                       + (2 + 2 * m + m * m) * (4 * sub + 1) * nbytes + 16 > room):
        sub -= 1
    return sub


# B1 and B1r's association on the card, (tile, sub) by (m, bytes per value)
# (csrc/quasisep_loglik.cu: b1_sub, one thread a team, 64 a tile, m <= 4;
# csrc/quasisep_loglik_generic.cu: b1t_sub, one warp a team, 4 a tile,
# m = 5..16; csrc/quasisep_loglik_wide.cu above, a tile of 64 one team).
_B1_SCHEDULE = {
    (m, nbytes): (64 * sub, sub) if m <= 4 else (4 * sub, sub) if m <= _MAX_TC_M else (sub, sub)
    for m in range(1, _MAX_GENERIC_M + 1) for nbytes in (4, 8)
    for sub in [(8 if m <= 2 else 4) if m <= 4
                else _b1_tc_sub(m, nbytes) if m <= _MAX_TC_M else 64]
}


def b1_schedule(m: int, dtype: torch.dtype) -> tuple[int, int] | None:
    """``(tile, sub)`` of the one-launch B1 and B1r for order ``m`` and
    operands of ``dtype``, or None above m = 32."""
    return _B1_SCHEDULE.get((m, torch.empty((), dtype=dtype).element_size()))


def b2_schedule(m: int, dtype: torch.dtype) -> tuple[int, int] | None:
    """``(tile, sub)`` of B2's one-launch kernel for order ``m`` and
    operands of ``dtype``, or None above m = 32."""
    return _B2_SCHEDULE.get((m, torch.empty((), dtype=dtype).element_size()))


def _team_scan(x, combine):
    """Inclusive scan over axis 1 (a tile's teams) of the tuple of tensors
    ``x``, in the one-launch kernels' association: Kogge-Stone within each
    run of up to 32 teams (a warp's shuffles, or the teams of a block),
    each run then composed after the inclusive value of the run before
    it."""
    teams = x[0].shape[1]
    run = min(teams, 32)
    out = []
    prev = None
    for r0 in range(0, teams, run):
        v = [t[:, r0:r0 + run] for t in x]
        off = 1
        while off < run:
            later = [t[:, off:] for t in v]
            earlier = [t[:, :-off] for t in v]
            merged = combine(earlier, later)
            v = [torch.cat([t[:, :off], mt], dim=1) for t, mt in zip(v, merged)]
            off *= 2
        if prev is not None:
            v = combine([p[:, None].expand_as(t) for p, t in zip(prev, v)], v)
        prev = [t[:, -1] for t in v]
        out.append(v)
    return [torch.cat(parts, dim=1) for parts in zip(*out)]


def _exclusive(incl, identity):
    """Each team's exclusive prefix from the inclusive values."""
    return [torch.cat([i0.expand_as(t[:, :1]), t[:, :-1]], dim=1)
            for i0, t in zip(identity, incl)]


_LOOK_GROUP = 32  # tiles a group of the look-back (csrc: kLookGroup)


def _aff_combine(e_, l_):
    """The affine maps ``(A, B)`` composed, earlier then later."""
    (eA, eB), (lA, lB) = e_, l_
    return [lA @ eA, (lA @ eB[..., None])[..., 0] + lB]


def _aff_apply(A, B, s):
    return (A @ s[..., None])[..., 0] + B


def _ric_combine(e_, l_):
    """The Riccati flow's Moebius maps ``(A, F, G)`` composed, earlier then
    later: :func:`scan._riccati_combine` on stacked ``(..., m, m)``."""
    (Ae, Fe, Ge), (Al, Fl, Gl) = e_, l_
    Minv = torch.linalg.inv(torch.eye(Ae.shape[-1], dtype=Ae.dtype, device=Ae.device) + Fe @ Gl)
    return [Al @ Minv @ Ae, Fl + Al @ Minv @ Fe @ Al.mT, Ge + Ae.mT @ Minv.mT @ Gl @ Ae]


def _ric_apply(A, F, G, X):
    """The state ``X`` after the map ``(A, F, G)``:
    ``F + A (I + X G)^-1 X A^T``."""
    eye = torch.eye(X.shape[-1], dtype=X.dtype, device=X.device)
    return F + A @ torch.linalg.solve(eye + X @ G, X) @ A.mT


def _group_chain(aggs, combine, apply, state0, warp_fold=False, runs=None, group=_LOOK_GROUP):
    """Each tile's state at its start, from the tiles' aggregates ``aggs``
    (tensors, tile first) in the one-launch kernels' look-back association:
    within each group of ``group`` tiles ``start(b) =
    Q(b)(S(g - 1))``, and the state after each group ``S(g) = GA(g)(S(g -
    1))`` from ``S(-1) = state0``, where ``Q(b)`` composes the aggregates
    of the group's tiles before ``b`` one tile at a time (B2), or with
    ``warp_fold`` by a Kogge-Stone scan over them (B1: a warp's lanes), or
    with ``runs`` in runs of that many tiles, each folded in order, the runs
    composed pairwise, then the pairs (B3's one-launch generic scans: a warp
    a run), and ``GA(g)`` is ``Q`` of the group's last tile composed with
    its aggregate."""
    nt = aggs[0].shape[0]
    starts = []
    S = state0

    def fold_runs(lo, hi):
        parts = []
        for r0 in range(lo, hi, runs):
            P = [x[r0] for x in aggs]
            for k in range(r0 + 1, min(r0 + runs, hi)):
                P = combine(P, [x[k] for x in aggs])
            parts.append(P)
        while len(parts) > 1:
            parts = [combine(parts[k], parts[k + 1]) if k + 1 < len(parts) else parts[k]
                     for k in range(0, len(parts), 2)]
        return parts[0]

    for base in range(0, nt, group):
        end = min(base + group, nt)
        if warp_fold:
            prefix = [x[0] for x in _team_scan([x[None, base:end] for x in aggs], combine)]
        Q = None
        for b in range(base, end):
            starts.append(S if Q is None else apply(*Q, S))
            agg = [x[b] for x in aggs]
            if warp_fold and b + 1 < end:
                Q = [x[b - base] for x in prefix]
            elif runs and b + 1 < end:
                Q = fold_runs(base, b + 1)
            else:
                Q = agg if Q is None else combine(Q, agg)
        S = apply(*Q, S)
    return torch.stack(starts)


def plain_loglik_terms_res_tiled(
    d: torch.Tensor,
    ps: torch.Tensor,
    qs: torch.Tensor,
    as_: torch.Tensor,
    y: torch.Tensor,
    tile: int,
    sub: int,
) -> tuple[torch.Tensor, ...]:
    """``(quad, logdet, Fs, e, ic)``: B1r in the association of its
    one-launch kernel, in float64, stored in the operands' dtype.

    The elements are cut into tiles of ``tile``, each into teams of ``sub``
    consecutive elements. Phase A: each team folds its elements' Riccati
    maps with the rank-one step (:func:`scan.riccati_fold_rank_one`), the
    teams of a tile are scanned (:func:`_team_scan`, the Moebius merge),
    and the tiles' aggregates reach the flow's state from ``F = 0`` in the
    look-back association (:func:`_group_chain`); each team's start is its
    prefix applied to its tile's. Phase B: each team walks its elements
    with the sequential recurrence ``F' = a F a^T + u u^T / c2`` and folds
    the whitening elements ``(a - wd p^T, wd y)``; the same scan and chain
    give ``e`` from 0. Phase C: each team walks its elements once more for
    ``alpha``, ``log c`` and the residuals. The ragged end is padded with
    identity elements (``d = 1``, ``p = q = 0``, ``a = I``, ``y = 0``),
    which the kernel masks and which add nothing.

    Up to m = 4 each chain's look-back folds a group of 32 tiles as a
    warp's Kogge-Stone scan; above m = 4 (the tensor-core and block-a-team
    kernels) a group of 16 tiles in runs of 4, each chain its own groups.
    """
    m, n = ps.shape
    dtype = ps.dtype
    teams = tile // sub
    nt = -(-n // tile)
    pad = nt * tile - n
    f64 = {"dtype": torch.float64, "device": ps.device}
    eye = torch.eye(m, **f64)

    def tiled(x, rows, fill):  # (rows, n) -> (nt, teams, sub, rows)
        x = x.to(**f64).reshape(rows, n).T
        x = torch.cat([x, torch.as_tensor(fill, **f64).expand(pad, rows)])
        return x.reshape(nt, teams, sub, rows)

    dv, yv = tiled(d, 1, 1.0)[..., 0], tiled(y, 1, 0.0)[..., 0]
    p, q = tiled(ps, m, 0.0), tiled(qs, m, 0.0)
    a = tiled(as_, m * m, eye.reshape(m * m)).reshape(nt, teams, sub, m, m)

    def outer(u, v):
        return u[..., :, None] * v[..., None, :]

    def mv(A, v):
        return (A @ v[..., None])[..., 0]

    def step(F, jj):
        """The emission from the state F before element jj, the whitening
        element and the state after it."""
        pj, aj = p[:, :, jj], a[:, :, jj]
        Fp = mv(F, pj)
        c2 = dv[:, :, jj] - torch.sum(pj * Fp, dim=-1)
        u = q[:, :, jj] - mv(aj, Fp)
        wd = u / c2[..., None]
        return c2, aj - outer(wd, pj), wd * yv[:, :, jj, None], aj @ F @ aj.mT + outer(u, wd)

    # Phase A: the rank-one fold, the in-tile scan and the chain of tiles.
    A = eye.expand(nt, teams, m, m).clone()
    F = torch.zeros(nt, teams, m, m, **f64)
    G = torch.zeros(nt, teams, m, m, **f64)
    for jj in range(sub):
        pj, aj = p[:, :, jj], a[:, :, jj]
        f = mv(F, pj)
        c = (dv[:, :, jj] - torch.sum(pj * f, dim=-1))[..., None, None]
        u = q[:, :, jj] - mv(aj, f)
        w = mv(A.mT, pj)
        A = aj @ A - outer(u, w) / c
        F = aj @ F @ aj.mT + outer(u, u) / c
        G = G - outer(w, w) / c
    zeros = torch.zeros(m, m, **f64)
    incl = _team_scan([A, F, G], _ric_combine)
    pre = _exclusive(incl, [eye, zeros, zeros])
    look = {"warp_fold": True} if m <= _MAX_M else _B2_TC_LOOK
    start = _group_chain([t[:, -1] for t in incl], _ric_combine, _ric_apply, zeros, **look)
    F0 = _ric_apply(*pre, start[:, None])

    # Phase B: the sequential flow and the whitening elements' folds.
    TA = eye.expand(nt, teams, m, m).clone()
    TB = torch.zeros(nt, teams, m, **f64)
    F = F0
    for jj in range(sub):
        _, At, Bt, F = step(F, jj)
        TA, TB = At @ TA, mv(At, TB) + Bt
    incl = _team_scan([TA, TB], _aff_combine)
    pre_A, pre_B = _exclusive(incl, [eye, torch.zeros(m, **f64)])
    start = _group_chain([t[:, -1] for t in incl], _aff_combine, _aff_apply,
                         torch.zeros(m, **f64), **look)
    e = _aff_apply(pre_A, pre_B, start[:, None])

    # Phase C: alpha, log c and the residuals at each element.
    Fs = torch.empty(nt, teams, sub, m, m, **f64)
    es = torch.empty(nt, teams, sub, m, **f64)
    ic = torch.empty(nt, teams, sub, **f64)
    alpha = torch.empty(nt, teams, sub, **f64)
    F = F0
    for jj in range(sub):
        Fs[:, :, jj], es[:, :, jj] = F, e
        c2, At, Bt, F = step(F, jj)
        ic[:, :, jj] = 1.0 / torch.sqrt(c2)
        alpha[:, :, jj] = (yv[:, :, jj] - torch.sum(p[:, :, jj] * e, dim=-1)) * ic[:, :, jj]
        e = mv(At, e) + Bt

    def untiled(x, rows):  # (nt, teams, sub, ...) -> (rows, n)
        return x.reshape(nt * tile, rows)[:n].T.contiguous().to(dtype)

    quad = torch.sum(torch.square(alpha))
    logdet = -torch.sum(torch.log(ic))
    return (quad.to(dtype), logdet.to(dtype), untiled(Fs, m * m), untiled(es, m),
            untiled(ic, 1)[0])


def plain_loglik_terms_tiled(
    d: torch.Tensor,
    ps: torch.Tensor,
    qs: torch.Tensor,
    as_: torch.Tensor,
    y: torch.Tensor,
    tile: int,
    sub: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(quad, logdet)``: B1 in the association of its one-launch kernel
    (:func:`plain_loglik_terms_res_tiled`)."""
    return plain_loglik_terms_res_tiled(d, ps, qs, as_, y, tile, sub)[:2]


def plain_loglik_bwd_tiled(
    ps: torch.Tensor,
    qs: torch.Tensor,
    as_: torch.Tensor,
    y: torch.Tensor,
    Fs: torch.Tensor,
    e: torch.Tensor,
    ic: torch.Tensor,
    qbar: torch.Tensor,
    lbar: torch.Tensor,
    tile: int,
    sub: int,
) -> tuple[torch.Tensor, ...]:
    """``(dbar, psbar, qsbar, asbar, ybar)``: B2 in the association of its
    one-launch kernel, in float64, stored in the operands' dtype.

    The positions are mirrored (position ``j`` is element ``N - 1 - j``)
    and cut into tiles of ``tile``, each into teams of ``sub`` consecutive
    positions. Each team folds its elements one at a time (the affine
    adjoint's ``(A^T, ebar)``; the congruence adjoint's ``T' = A^T T``,
    ``B' = A^T B A + Fpbar p^T``); the teams of a tile are scanned
    (:func:`_team_scan`); the tiles' aggregates reach the scans' states in
    the kernel's look-back association (:func:`_group_chain`, from 0 at the
    first position); each team walks its elements with the sequential
    recurrences from its prefix. The
    outputs are elementwise in mu and Gbar (the kernel's phase C). The
    ragged end is padded with identity elements, which the kernel masks.

    Above m = 8 (the tensor-core and block-a-team kernels) the look-back
    folds a group of 16 tiles in runs of 4, and the congruence adjoint
    scans ``Gbar + Gbar^T``, the only form of Gbar the outputs read, with
    the loads symmetrized to match (the scan is linear in its loads).
    """
    m, n = ps.shape
    dtype = ps.dtype
    teams = tile // sub
    nt = -(-n // tile)
    pad = nt * tile - n
    f64 = torch.float64
    eye = torch.eye(m, dtype=f64)

    def mirror(x, rows):
        x = torch.flip(x.to(f64).reshape(rows, n), (-1,)).T  # (n, rows)
        return torch.cat([x, x.new_zeros(pad, rows)])

    p, q, ev = (mirror(x, m) for x in (ps, qs, e))
    a, F = (mirror(x, m * m).reshape(-1, m, m) for x in (as_, Fs))
    yv = mirror(y, 1)[:, 0]
    icv = torch.cat([torch.flip(ic.to(f64), (0,)), ic.new_ones(pad, dtype=f64)])
    valid = torch.arange(nt * tile) < n
    qb, lb = qbar.to(f64), lbar.to(f64)
    tc = m > 8
    look = _B2_TC_LOOK if tc else {}

    # The elements' emissions (padding: A^T = I, every load 0).
    ic2 = icv * icv
    Fp = torch.einsum("kij,kj->ki", F, p)
    u = q - torch.einsum("kij,kj->ki", a, Fp)
    wd = u * ic2[:, None]
    r = yv - torch.sum(p * ev, dim=-1)
    alpha = r * icv
    alphabar = 2.0 * qb * alpha
    At = a.transpose(-1, -2) - p[:, :, None] * wd[:, None, :]
    At = torch.where(valid[:, None, None], At, eye)
    ebar = -(alphabar * icv)[:, None] * p

    def glue(k, mu):
        """Fpbar of elements k from their mu (index or slice on axis 0)."""
        ubar = mu * r[k, None] * ic2[k, None]
        uw = torch.sum(u[k] * mu * r[k, None], dim=-1)
        icbar = -lb / icv[k] + alphabar[k] * alpha[k] / icv[k] + 2.0 * icv[k] * uw
        c2bar = -0.5 * icbar * icv[k] * ic2[k]
        Fpbar = -c2bar[..., None] * p[k] - torch.einsum("...ij,...i->...j", a[k], ubar)
        return Fpbar, ubar, c2bar

    def tiled(x):  # (nt * tile, ...) -> (nt, teams, sub, ...)
        return x.reshape(nt, teams, sub, *x.shape[1:])

    idx = tiled(torch.arange(nt * tile))
    At_t, ebar_t = tiled(At), tiled(ebar)

    def cong_combine(e_, l_):
        (eT, eB), (lT, lB) = e_, l_
        return [lT @ eT, lT @ eB @ lT.transpose(-1, -2) + lB]

    # Phase A: the affine adjoint, team folds, the in-tile scan, the chain.
    TA = eye.expand(nt, teams, m, m).clone()
    TB = torch.zeros(nt, teams, m, dtype=f64)
    for jj in range(sub):
        E = At_t[:, :, jj]
        TB = (E @ TB[..., None])[..., 0] + ebar_t[:, :, jj]
        TA = E @ TA
    incl = _team_scan([TA, TB], _aff_combine)
    pre_A, pre_B = _exclusive(incl, [eye, torch.zeros(m, dtype=f64)])
    start = _group_chain([t[:, -1] for t in incl], _aff_combine, _aff_apply,
                         torch.zeros(m, dtype=f64), **look)
    lam = (pre_A @ start[:, None, :, None])[..., 0] + pre_B

    def load(jj, k):  # the congruence loads of the teams' element jj
        Y = Fpbar[:, :, jj, :, None] * p[k][..., None, :]
        return Y + Y.transpose(-1, -2) if tc else Y

    # Phase B: the mu recurrence, the congruence loads and folds.
    mu = torch.empty(nt, teams, sub, m, dtype=f64)
    Fpbar = torch.empty(nt, teams, sub, m, dtype=f64)
    CT = eye.expand(nt, teams, m, m).clone()
    CB = torch.zeros(nt, teams, m, m, dtype=f64)
    for jj in range(sub):
        k = idx[:, :, jj]
        E = At_t[:, :, jj]
        mu[:, :, jj] = lam
        Fpbar[:, :, jj] = glue(k, lam)[0]
        CT = E @ CT
        CB = E @ CB @ E.transpose(-1, -2) + load(jj, k)
        lam = (E @ lam[..., None])[..., 0] + ebar_t[:, :, jj]
    incl = _team_scan([CT, CB], cong_combine)
    pre_T, pre_B = _exclusive(incl, [eye, torch.zeros(m, m, dtype=f64)])
    start = _group_chain([t[:, -1] for t in incl], cong_combine,
                         lambda T, B, G: T @ G @ T.T + B, torch.zeros(m, m, dtype=f64),
                         **look)
    G = pre_T @ start[:, None] @ pre_T.transpose(-1, -2) + pre_B

    # Phase C: Gbar at each element, then the outputs elementwise.
    Gbar = torch.empty(nt, teams, sub, m, m, dtype=f64)
    for jj in range(sub):
        k = idx[:, :, jj]
        E = At_t[:, :, jj]
        Gbar[:, :, jj] = G
        G = E @ G @ E.transpose(-1, -2) + load(jj, k)
    mu, Fpbar, Gbar = (x.reshape(nt * tile, *x.shape[3:]) for x in (mu, Fpbar, Gbar))
    _, ubar, c2bar = glue(slice(None), mu)
    Sm = Gbar if tc else Gbar + Gbar.transpose(-1, -2)
    Su = torch.einsum("kij,kj->ki", Sm, u)
    uSu = torch.sum(u * Su, dim=-1)
    wmu = torch.sum(wd * mu, dim=-1)
    aTSu = torch.einsum("kij,ki->kj", a, Su)
    SaF = Sm @ a @ F
    ic4 = ic2 * ic2
    dbar = c2bar - 0.5 * uSu * ic4
    psbar = (
        -(alphabar * icv + wmu)[:, None] * ev
        - c2bar[:, None] * Fp
        + (uSu * ic4)[:, None] * Fp
        + torch.einsum("kij,ki->kj", F, Fpbar)
        - ic2[:, None] * torch.einsum("kji,ki->kj", F, aTSu)
    )
    qsbar = ubar + Su * ic2[:, None]
    asbar = (mu[:, :, None] * ev[:, None, :] - ubar[:, :, None] * Fp[:, None, :] + SaF
             - (Su * ic2[:, None])[:, :, None] * Fp[:, None, :])
    ybar = alphabar * icv + wmu

    def unmirror(x, rows):  # (nt * tile, ...) -> (rows, n), element order
        return torch.flip(x[:n].reshape(n, rows).T, (-1,)).contiguous().to(dtype)

    return (unmirror(dbar, 1)[0], unmirror(psbar, m), unmirror(qsbar, m),
            unmirror(asbar, m * m), unmirror(ybar, 1)[0])


# ---------------------------------------------------------------------------
# Kernels.
# ---------------------------------------------------------------------------


def _bind(lib: ctypes.CDLL, prefix: str, n_ptrs: int) -> None:
    """Declare the C signatures ``(m, n, <n_ptrs pointers>, work_elems,
    stream) -> cudaError_t`` of ``<prefix>_f32``/``_f64``."""
    for suffix in _DTYPES.values():
        fn = getattr(lib, f"{prefix}_{suffix}")
        fn.argtypes = (
            [ctypes.c_int, ctypes.c_int]
            + [ctypes.c_void_p] * n_ptrs
            + [ctypes.c_longlong, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    lib.qsl_error_string.argtypes = [ctypes.c_int]
    lib.qsl_error_string.restype = ctypes.c_char_p


def _bind_chains(lib: ctypes.CDLL, prefix: str, n_ptrs: int) -> None:
    """Declare the chain-axis C signatures ``(m, n, chains, *strides,
    <n_ptrs pointers>, work_elems, stream) -> cudaError_t`` of
    ``<prefix>_chains_f32``/``_f64``."""
    for suffix in _DTYPES.values():
        fn = getattr(lib, f"{prefix}_chains_{suffix}")
        fn.argtypes = (
            [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]
            + [ctypes.c_void_p] * n_ptrs
            + [ctypes.c_longlong, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int


def _bind_schedule(lib: ctypes.CDLL, name: str = "qsl_bwd_schedule") -> None:
    """``<name>(m, bytes, *tile, *sub)``: a one-launch kernel's association
    on the card (``qsl_fwd_schedule``: B1's, which :data:`_B1_SCHEDULE`
    repeats; ``qsl_bwd_schedule``: B2's, :data:`_B2_SCHEDULE`)."""
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int


@functools.cache
def _library() -> ctypes.CDLL:
    """B1 and B1r's library, built at first use, with its C signatures."""
    lib = cuda_build.library("quasisep_loglik")
    lib.qsl_workspace_elems.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.qsl_workspace_elems.restype = ctypes.c_longlong
    _bind(lib, "qsl_loglik", 7)  # d ps qs as y | out | work
    _bind(lib, "qsl_loglik_res", 10)  # d ps qs as y | out Fs e ic | work
    _bind_chains(lib, "qsl_loglik", 10)  # the same, Fs e ic null for B1
    _bind_schedule(lib, "qsl_fwd_schedule")
    return lib


@functools.cache
def _bwd_library() -> ctypes.CDLL:
    """B2's library, built at first use, with its C signatures."""
    lib = cuda_build.library("quasisep_loglik_bwd")
    lib.qsl_bwd_workspace_elems.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.qsl_bwd_workspace_elems.restype = ctypes.c_longlong
    # ps qs as y Fs e ic qbar lbar | dbar psbar qsbar asbar ybar | work
    _bind(lib, "qsl_loglik_bwd", 15)
    _bind_chains(lib, "qsl_loglik_bwd", 15)
    _bind_schedule(lib)
    return lib


@functools.cache
def _generic_library(stem: str = "quasisep_loglik_generic") -> ctypes.CDLL:
    """B1, B1r and B2 for 4 < m <= 16 (``stem`` ``quasisep_loglik_wide``:
    16 < m <= 32), built at first use: the same C signatures as the
    templated libraries."""
    lib = cuda_build.library(stem)
    for name in ("qsl_workspace_elems", "qsl_bwd_workspace_elems"):
        getattr(lib, name).argtypes = [ctypes.c_int, ctypes.c_int]
        getattr(lib, name).restype = ctypes.c_longlong
    _bind(lib, "qsl_loglik", 7)
    _bind(lib, "qsl_loglik_res", 10)
    _bind(lib, "qsl_loglik_bwd", 15)
    _bind_schedule(lib)
    _bind_schedule(lib, "qsl_fwd_schedule")
    return lib


def _order_library(m: int, templated) -> ctypes.CDLL:
    """The library of order ``m``: ``templated()`` up to m = 4, then the
    generic and the wide sources."""
    if m <= _MAX_M:
        return templated()
    return _generic_library("quasisep_loglik_generic" if m <= _MAX_TC_M
                            else "quasisep_loglik_wide")


def _check(**operands: torch.Tensor) -> tuple[int, int]:
    """Validate what a kernel takes; return ``(m, n)``."""
    ps = operands["ps"]
    if ps.ndim != 2:
        raise ValueError(f"ps must be (m, N); got shape {tuple(ps.shape)}")
    m, n = ps.shape
    vec, mat = (m, n), (m * m, n)
    want = {"d": (n,), "y": (n,), "ic": (n,), "ps": vec, "qs": vec, "e": vec,
            "as_": mat, "Fs": mat, "qbar": (), "lbar": ()}
    for name, x in operands.items():
        if tuple(x.shape) != want[name]:
            raise ValueError(
                f"{name} must have shape {want[name]} (unbatched); got "
                f"{tuple(x.shape)}"
            )
        if x.device != ps.device:
            raise ValueError("all operands must be on one device")
        if x.dtype != ps.dtype:
            raise ValueError("all operands must have one dtype")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if ps.device.type != "cuda":
        raise ValueError(f"no kernel for device {ps.device}")
    if ps.dtype not in _DTYPES:
        raise ValueError(f"the kernel takes float32 or float64, not {ps.dtype}")
    if m > _MAX_GENERIC_M:
        raise NotImplementedError(
            f"the CUDA log-likelihood takes m <= {_MAX_GENERIC_M}; m = {m} is "
            "ROADMAP item N10 (orders above 32 on CUDA)"
        )
    if not 1 <= n < 2**31:
        raise ValueError(f"N must be in [1, 2**31); got {n}")
    return m, n


def _check_chains(ranks, operands) -> tuple[int, int, int, list[bool]]:
    """Validate a chain-axis launch's operands, each with a leading chain
    axis or without one where every chain shares it; return ``(chains, m,
    n, batched)``."""
    batched = _batched(operands, ranks)
    sizes = {x.shape[0] for x, b in zip(operands, batched) if b}
    if len(sizes) != 1:
        raise ValueError(f"the chain axes must be one length; got {sorted(sizes)}")
    (chains,) = sizes
    if not 1 <= chains < 2**31:
        raise ValueError(f"the number of chains must be in [1, 2**31); got {chains}")
    m, n = _check(**{name: x[0] if b else x for (name, _), x, b in zip(ranks, operands, batched)})
    for (name, _), x, b in zip(ranks, operands, batched):
        if b and not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return chains, m, n, batched


def _launch(lib, prefix, work_elems_fn, m, n, tensors, chains=None, batched=None) -> None:
    """Run ``<prefix>_<dtype>`` on the tensors' device and current stream,
    with a float64 workspace (the kernels' scans run in float64); raise on
    a refused argument or launch. With ``chains``, run the chain-axis entry
    ``<prefix>_chains_<dtype>``: the first ``len(batched)`` tensors are the
    operands, each with its chain stride (0 where not ``batched``), and a
    None tensor is a null pointer."""
    ref = tensors[0]
    ptrs = [None if t is None else t.data_ptr() for t in tensors]
    with torch.cuda.device(ref.device):
        work_elems = work_elems_fn(m, n) * (chains or 1)
        work = torch.empty(work_elems, dtype=torch.float64, device=ref.device)
        stream = torch.cuda.current_stream(ref.device).cuda_stream
        if chains is None:
            err = getattr(lib, f"{prefix}_{_DTYPES[ref.dtype]}")(
                m, n, *ptrs, work.data_ptr(), work_elems, stream,
            )
        else:
            strides = (ctypes.c_longlong * len(batched))(
                *(t[0].numel() if b else 0 for t, b in zip(tensors, batched)))
            err = getattr(lib, f"{prefix}_chains_{_DTYPES[ref.dtype]}")(
                m, n, chains, strides, *ptrs, work.data_ptr(), work_elems, stream,
            )
    if err:
        raise RuntimeError(
            f"quasisep log-likelihood kernel {prefix} failed: "
            f"{lib.qsl_error_string(err).decode()} (cudaError {err})"
        )


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(x.device.type == "cpu" for x in tensors)


def _loglik_b1(d, ps, qs, as_, y) -> tuple[torch.Tensor, torch.Tensor]:
    """``(quad, logdet)``: B1 for CUDA tensors, its plain version for CPU
    tensors."""
    global LAUNCHES
    if _on_cpu(d, ps, qs, as_, y):
        return plain_loglik_terms(d, ps, qs, as_, y)
    m, n = _check(d=d, ps=ps, qs=qs, as_=as_, y=y)
    lib = _order_library(m, _library)
    out = d.new_empty(2)
    _launch(lib, "qsl_loglik", lib.qsl_workspace_elems, m, n, (d, ps, qs, as_, y, out))
    LAUNCHES += 1
    LAUNCHES_GENERIC["b1"] += m > _MAX_M
    return out[0], out[1]


def fused_loglik_res(
    d: torch.Tensor,
    ps: torch.Tensor,
    qs: torch.Tensor,
    as_: torch.Tensor,
    y: torch.Tensor,
) -> tuple[torch.Tensor, ...]:
    """``(quad, logdet, Fs, e, ic)``: B1r for CUDA tensors, its plain
    version for CPU tensors. The residuals are in the operands' dtype."""
    global LAUNCHES_RES
    if _on_cpu(d, ps, qs, as_, y):
        return plain_loglik_terms_res(d, ps, qs, as_, y)
    m, n = _check(d=d, ps=ps, qs=qs, as_=as_, y=y)
    lib = _order_library(m, _library)
    out = d.new_empty(2)
    Fs, e, ic = d.new_empty(m * m, n), d.new_empty(m, n), d.new_empty(n)
    _launch(
        lib, "qsl_loglik_res", lib.qsl_workspace_elems, m, n,
        (d, ps, qs, as_, y, out, Fs, e, ic),
    )
    LAUNCHES_RES += 1
    LAUNCHES_GENERIC["b1r"] += m > _MAX_M
    return out[0], out[1], Fs, e, ic


def fused_loglik_bwd(
    ps: torch.Tensor,
    qs: torch.Tensor,
    as_: torch.Tensor,
    y: torch.Tensor,
    Fs: torch.Tensor,
    e: torch.Tensor,
    ic: torch.Tensor,
    qbar: torch.Tensor,
    lbar: torch.Tensor,
) -> tuple[torch.Tensor, ...]:
    """``(dbar, psbar, qsbar, asbar, ybar)``: B2 for CUDA tensors, its
    plain version for CPU tensors.

    ``qbar``/``lbar`` are 0-d tensors; the kernel reads them from device
    memory, so nothing waits on the host.
    """
    global LAUNCHES_BWD
    if _on_cpu(ps, qs, as_, y, Fs, e, ic, qbar, lbar):
        return plain_loglik_bwd(ps, qs, as_, y, Fs, e, ic, qbar, lbar)
    m, n = _check(ps=ps, qs=qs, as_=as_, y=y, Fs=Fs, e=e, ic=ic, qbar=qbar, lbar=lbar)
    lib = _order_library(m, _bwd_library)
    outs = (y.new_empty(n), y.new_empty(m, n), y.new_empty(m, n),
            y.new_empty(m * m, n), y.new_empty(n))
    _launch(
        lib, "qsl_loglik_bwd", lib.qsl_bwd_workspace_elems, m, n,
        (ps, qs, as_, y, Fs, e, ic, qbar, lbar) + outs,
    )
    LAUNCHES_BWD += 1
    LAUNCHES_GENERIC["b2"] += m > _MAX_M
    return outs


def _per_chain(fn, operands, batched):
    """``fn`` launched once for each chain (the generic-order kernels have no chain
    axis, ROADMAP N9b), its outputs stacked on a chain axis."""
    chains = next(x.shape[0] for x, b in zip(operands, batched) if b)
    outs = [fn(*(x[c] if b else x for x, b in zip(operands, batched))) for c in range(chains)]
    return tuple(torch.stack(t) for t in zip(*outs))


def _forward_chains(operands, residuals):
    """B1 or B1r over a chain axis (:func:`fused_loglik_res_chains`)."""
    global LAUNCHES, LAUNCHES_RES
    chains, m, n, batched = _check_chains(_FWD, operands)
    if m > _MAX_M:
        return _per_chain(fused_loglik_res if residuals else _loglik_b1, operands, batched)
    ref = operands[1]
    out = ref.new_empty(chains, 2)
    res = ((ref.new_empty(chains, m * m, n), ref.new_empty(chains, m, n), ref.new_empty(chains, n))
           if residuals else (None, None, None))
    lib = _library()
    _launch(lib, "qsl_loglik", lib.qsl_workspace_elems, m, n, (*operands, out, *res),
            chains=chains, batched=batched)
    if residuals:
        LAUNCHES_RES += 1
        LAUNCHES_CHAINS["b1r"] += 1
        return (out[:, 0], out[:, 1], *res)
    LAUNCHES += 1
    LAUNCHES_CHAINS["b1"] += 1
    return out[:, 0], out[:, 1]


def fused_loglik_terms_chains(
    d: torch.Tensor,
    ps: torch.Tensor,
    qs: torch.Tensor,
    as_: torch.Tensor,
    y: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(quad, logdet)`` of every chain, each ``(C,)``: B1 over a chain
    axis for CUDA tensors, its plain version mapped for CPU tensors.

    Each operand has a leading chain axis of one length C, or none where
    every chain shares it (a stride of 0: nothing is copied C times). Up to
    m = 4 this is one launch over (chain, tile); above, one launch a
    chain."""
    operands = (d, ps, qs, as_, y)
    if _on_cpu(*operands):
        return plain_loglik_terms_res_chains(*operands)[:2]
    return _forward_chains(operands, residuals=False)


def fused_loglik_res_chains(
    d: torch.Tensor,
    ps: torch.Tensor,
    qs: torch.Tensor,
    as_: torch.Tensor,
    y: torch.Tensor,
) -> tuple[torch.Tensor, ...]:
    """``(quad, logdet, Fs, e, ic)`` of every chain, each with a leading
    chain axis: B1r over a chain axis for CUDA tensors (operands as
    :func:`fused_loglik_terms_chains` takes them), its plain version
    mapped for CPU tensors."""
    operands = (d, ps, qs, as_, y)
    if _on_cpu(*operands):
        return plain_loglik_terms_res_chains(*operands)
    return _forward_chains(operands, residuals=True)


def fused_loglik_bwd_chains(
    ps: torch.Tensor,
    qs: torch.Tensor,
    as_: torch.Tensor,
    y: torch.Tensor,
    Fs: torch.Tensor,
    e: torch.Tensor,
    ic: torch.Tensor,
    qbar: torch.Tensor,
    lbar: torch.Tensor,
) -> tuple[torch.Tensor, ...]:
    """``(dbar, psbar, qsbar, asbar, ybar)`` of every chain, each with a
    leading chain axis: B2 over a chain axis for CUDA tensors (each input
    with a leading chain axis or shared, ``qbar``/``lbar`` ``(C,)`` or 0-d),
    its plain version mapped for CPU tensors. Up to m = 4 one launch over
    (chain, tile); above, one launch a chain."""
    global LAUNCHES_BWD
    operands = (ps, qs, as_, y, Fs, e, ic, qbar, lbar)
    if _on_cpu(*operands):
        return plain_loglik_bwd_chains(*operands)
    chains, m, n, batched = _check_chains(_BWD, operands)
    if m > _MAX_M:
        return _per_chain(fused_loglik_bwd, operands, batched)
    ref = operands[0]
    outs = (ref.new_empty(chains, n), ref.new_empty(chains, m, n), ref.new_empty(chains, m, n),
            ref.new_empty(chains, m * m, n), ref.new_empty(chains, n))
    lib = _bwd_library()
    _launch(lib, "qsl_loglik_bwd", lib.qsl_bwd_workspace_elems, m, n, operands + outs,
            chains=chains, batched=batched)
    LAUNCHES_BWD += 1
    LAUNCHES_CHAINS["b2"] += 1
    return outs


def _to_chains(in_dims, operands):
    """A ``vmap`` rule's operands with their chain axis first and
    contiguous; those without one (``None``) as they are, contiguous."""
    return tuple(
        (x if dim is None else x.movedim(dim, 0)).contiguous() for x, dim in zip(operands, in_dims)
    )


_ONCE = (
    "the fused log-likelihood is once differentiable: its backward kernel "
    "has no derivative (create_graph=True)"
)


class FusedLoglik(torch.autograd.Function):
    """``(quad, logdet, Fs, e, ic)`` with a hand-written gradient of the
    first two: forward B1r, whose residuals ``(Fs, e, ic)`` are returned
    (not differentiable) and saved, and backward B2 (:class:`_LoglikBwd`);
    on the CPU, their plain versions. Once differentiable: a second
    derivative raises. Under ``torch.func.vmap`` its rule runs
    :func:`fused_loglik_res_chains`, one launch for every chain."""

    @staticmethod
    def forward(d, ps, qs, as_, y):
        return fused_loglik_res(d, ps, qs, as_, y)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ps, qs, as_, y = inputs
        _, _, Fs, e, ic = output
        ctx.mark_non_differentiable(Fs, e, ic)
        ctx.save_for_backward(ps, qs, as_, y, Fs, e, ic)

    @staticmethod
    def backward(ctx, qbar, lbar, *_):
        _refuse_graph()
        ps, qs, as_, y, Fs, e, ic = ctx.saved_tensors
        qbar, lbar = (g.to(ps.dtype).reshape(()).contiguous() for g in (qbar, lbar))
        return _LoglikBwd.apply(ps, qs, as_, y, Fs, e, ic, qbar, lbar)

    @staticmethod
    def vmap(info, in_dims, *operands):
        return _FusedLoglikChains.apply(*_to_chains(in_dims, operands)), (0,) * 5


def _refuse_graph() -> None:
    """Raise where a backward is asked for a graph of the gradient.

    Outside torch.func, grad mode is on in a backward exactly when the
    caller asked for one (create_graph=True), which B2 cannot give;
    torch.func.grad always asks for one, and a second derivative through
    it raises in B2's own ``Function``."""
    if torch.is_grad_enabled() and not torch._C._are_functorch_transforms_active():
        raise RuntimeError(_ONCE)


class _FusedLoglikChains(torch.autograd.Function):
    """:class:`FusedLoglik` over a chain axis, the form its ``vmap`` rule
    returns: forward B1r over every chain (:func:`fused_loglik_res_chains`),
    backward B2 over every chain (:class:`_LoglikBwdChains`), the
    cotangents of operands that every chain shares summed over the chains.

    Through it an autograd level outside the ``vmap`` (``.backward()`` or
    ``torch.func.grad`` of an ELBO built on ``vmap(log_prob)``) records the
    launch; a launch writes into fresh tensors and records nothing of its
    own. On CPU tensors the forward runs the plain chain version, without
    grad like the launch, so the CPU path takes this backward too."""

    @staticmethod
    def forward(d, ps, qs, as_, y):
        return fused_loglik_res_chains(d, ps, qs, as_, y)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ps, qs, as_, y = inputs
        _, _, Fs, e, ic = output
        ctx.mark_non_differentiable(Fs, e, ic)
        ctx.save_for_backward(ps, qs, as_, y, Fs, e, ic)
        ctx.batched = _batched(inputs, _FWD)

    @staticmethod
    def backward(ctx, qbar, lbar, *_):
        _refuse_graph()
        ps, qs, as_, y, Fs, e, ic = ctx.saved_tensors
        qbar, lbar = (g.to(ps.dtype).contiguous() for g in (qbar, lbar))
        grads = _LoglikBwdChains.apply(ps, qs, as_, y, Fs, e, ic, qbar, lbar)
        return tuple(g if b else g.sum(0) for g, b in zip(grads, ctx.batched))

    @staticmethod
    def vmap(info, in_dims, *operands):
        raise RuntimeError("the chain-axis log-likelihood takes one chain axis, not two")


class _LoglikBwdChains(torch.autograd.Function):
    """B2 over a chain axis (:func:`fused_loglik_bwd_chains`) as a
    ``Function``: it has no derivative and takes no second chain axis."""

    @staticmethod
    def forward(*operands):
        return fused_loglik_bwd_chains(*operands)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError(_ONCE)

    @staticmethod
    def vmap(info, in_dims, *operands):
        raise RuntimeError("the chain-axis log-likelihood takes one chain axis, not two")


class _LoglikBwd(torch.autograd.Function):
    """B2 (:func:`fused_loglik_bwd`) as a ``Function``, so that a vmapped
    backward reaches :func:`fused_loglik_bwd_chains`; it has no derivative."""

    @staticmethod
    def forward(*operands):
        return fused_loglik_bwd(*operands)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError(_ONCE)

    @staticmethod
    def vmap(info, in_dims, *operands):
        return fused_loglik_bwd_chains(*_to_chains(in_dims, operands)), (0,) * 5


class _LoglikValue(torch.autograd.Function):
    """B1 (the value alone) as a ``Function``, so that ``torch.func.vmap``
    reaches :func:`fused_loglik_terms_chains`; used where no gradient is
    wanted."""

    @staticmethod
    def forward(*operands):
        return _loglik_b1(*operands)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("B1 has no gradient; the gradient goes through FusedLoglik")

    @staticmethod
    def vmap(info, in_dims, *operands):
        return fused_loglik_terms_chains(*_to_chains(in_dims, operands)), (0, 0)


def fused_loglik_terms(
    d: torch.Tensor,
    ps: torch.Tensor,
    qs: torch.Tensor,
    as_: torch.Tensor,
    y: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(quad, logdet)``, differentiable.

    Operands are stacked and unbatched: ``d``/``y`` ``(N,)``, ``ps``/``qs``
    ``(m, N)``, ``as_`` ``(m*m, N)``, one dtype, contiguous. With grad
    enabled and an operand requiring it (at any autograd level, one outside
    a ``vmap`` too), this is :class:`FusedLoglik` (B1r, then B2 in the
    backward); otherwise B1. CPU tensors take the
    plain versions on either route. Under ``torch.func.vmap`` (over any
    operands but one chain axis) both routes launch once for all chains.
    """
    operands = (d, ps, qs, as_, y)
    if torch.is_grad_enabled() and any(_requires_grad(x) for x in operands):
        return FusedLoglik.apply(*operands)[:2]
    return _LoglikValue.apply(*operands)


def _requires_grad(x: torch.Tensor) -> bool:
    """Whether ``x`` requires grad at some autograd level. Under
    ``torch.func.vmap`` a batched tensor reads False whatever the tensor it
    wraps, so the wrappers are peeled: an autograd level outside the
    ``vmap`` (``.backward()``, ``torch.func.grad``) needs the gradient."""
    functorch = torch._C._functorch
    while not x.requires_grad and functorch.is_batchedtensor(x):
        x = functorch.get_unwrapped(x)
    return x.requires_grad
