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
  and ``ic = 1/c (N,)``.
- **B2** (``csrc/quasisep_loglik_bwd.cu``) replaces
  ``pallas_loglik._bwd_kernel``: from the residuals and the two scalar
  cotangents, the cotangents of ``(d, ps, qs, as_, y)``, through a reverse
  affine-adjoint scan and a reverse congruence scan. Up to m = 8 it is one
  launch (and one memset of its flags): tiles taken by a ticket, each
  staged once in shared memory, and a look-back that combines the earlier
  tiles' aggregates in one fixed order, so two launches agree bit for bit;
  :func:`plain_loglik_bwd_tiled` is its association in plain PyTorch,
  :func:`b2_schedule` its tiles.

Those sources are templated for m = 1..4. For 4 < m <= 32 the same three
entry points run ``csrc/quasisep_loglik_generic.cu``, which has the same C
interface: B1 and B1r, and B2 above m = 8, as a short sequence of the
generic-order scan engine and hand-written elementwise and reduction
kernels, with the same arithmetic; B2 at m = 5..8 as the one launch with a
warp for a team. Above 32 a CUDA operand raises (ROADMAP item N10).

Every scan runs in float64 for float32 operands too: composed in float32,
the Riccati maps of long spans lose the state (see the note in the
source). The residuals are stored in the operands' type.

:func:`fused_loglik_terms` is the entry. When grad is enabled and an
operand requires it, it goes through :class:`FusedLoglik`, a
``torch.autograd.Function`` whose forward is B1r and whose backward is B2;
otherwise it runs B1. Each of the three wrappers (:func:`fused_loglik_terms`
without grad, :func:`fused_loglik_res`, :func:`fused_loglik_bwd`) runs its
plain PyTorch version for CPU tensors and launches its kernel for CUDA
tensors, or raises; none falls back. Each launch adds one to its counter:
:data:`LAUNCHES` (B1), :data:`LAUNCHES_RES` (B1r), :data:`LAUNCHES_BWD` (B2);
a launch above m = 4 also to :data:`LAUNCHES_GENERIC`.
"""

from __future__ import annotations

__all__ = [
    "LAUNCHES",
    "LAUNCHES_RES",
    "LAUNCHES_BWD",
    "LAUNCHES_GENERIC",
    "FusedLoglik",
    "fused_loglik_terms",
    "fused_loglik_res",
    "fused_loglik_bwd",
    "plain_loglik_terms",
    "plain_loglik_terms_res",
    "plain_loglik_bwd",
    "plain_loglik_bwd_tiled",
    "b2_schedule",
]

import ctypes
import functools

import torch

from tinygp_tpu_torch import cuda_build
from tinygp_tpu_torch.solvers.quasisep import scan as _scan

LAUNCHES = 0
"""Calls that launched kernel B1 (one per call of its C entry, which
enqueues the kernel's six passes)."""
LAUNCHES_RES = 0
"""Calls that launched kernel B1r, the forward with residuals."""
LAUNCHES_BWD = 0
"""Calls that launched kernel B2, the backward (one kernel launch each up
to m = 8)."""
LAUNCHES_GENERIC = {"b1": 0, "b1r": 0, "b2": 0}
"""Of those, the calls above m = 4 (``quasisep_loglik_generic.cu``)."""

_MAX_M = 4  # the templated kernels' orders
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


# B2's association on the card, (tile, sub) by (m, bytes per value): the
# elements of a tile and of a team's run (csrc/quasisep_loglik_bwd.cu:
# b2_sub, one thread a team, 64 a tile; csrc/quasisep_loglik_generic.cu:
# b2g_sub, one warp a team, 4 a tile). Above m = 8 B2 runs the generic
# sequence, with no tiles.
_B2_SCHEDULE = {
    (m, nbytes): (64 * sub, sub) if m <= 4 else (4 * sub, sub)
    for m in range(1, 9) for nbytes in (4, 8)
    for sub in [(8 if m <= 2 else 2) if m <= 4
                else (8 if nbytes == 8 else 16) if m == 8
                else 16 if m == 7 or (nbytes == 8 and m == 6) else 32]
}


def b2_schedule(m: int, dtype: torch.dtype) -> tuple[int, int] | None:
    """``(tile, sub)`` of B2's one-launch kernel for order ``m`` and
    operands of ``dtype``, or None where B2 runs the sequence (m > 8)."""
    return _B2_SCHEDULE.get((m, torch.empty((), dtype=dtype).element_size()))


def _team_scan(x, combine):
    """Inclusive scan over axis 1 (a tile's teams) of the tuple of tensors
    ``x``, in B2's association: Kogge-Stone within each run of up to 32
    teams (a warp's shuffles, or the teams of a block), each run then
    composed after the inclusive value of the run before it."""
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


_LOOK_GROUP = 32  # tiles a group of B2's look-back (csrc: kLookGroup)


def _group_chain(aggs, combine, apply, state0):
    """Each tile's state at its start, from the tiles' aggregates ``aggs``
    (a pair of tensors, tile first) in B2's look-back association: within
    each group of :data:`_LOOK_GROUP` tiles the aggregates folded one tile
    at a time, ``start(b) = Q(b)(S(g - 1))``, and the state after each
    group ``S(g) = GA(g)(S(g - 1))`` from ``S(-1) = state0``."""
    nt = aggs[0].shape[0]
    starts = []
    S = state0
    for base in range(0, nt, _LOOK_GROUP):
        Q = None
        for b in range(base, min(base + _LOOK_GROUP, nt)):
            starts.append(S if Q is None else apply(*Q, S))
            agg = [x[b] for x in aggs]
            Q = agg if Q is None else combine(Q, agg)
        S = apply(*Q, S)
    return torch.stack(starts)


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

    def aff_combine(e_, l_):
        (eA, eB), (lA, lB) = e_, l_
        return [lA @ eA, (lA @ eB[..., None])[..., 0] + lB]

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
    incl = _team_scan([TA, TB], aff_combine)
    pre_A, pre_B = _exclusive(incl, [eye, torch.zeros(m, dtype=f64)])
    start = _group_chain([t[:, -1] for t in incl], aff_combine,
                         lambda A, B, s: A @ s + B, torch.zeros(m, dtype=f64))
    lam = (pre_A @ start[:, None, :, None])[..., 0] + pre_B

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
        CB = E @ CB @ E.transpose(-1, -2) + Fpbar[:, :, jj, :, None] * p[k][..., None, :]
        lam = (E @ lam[..., None])[..., 0] + ebar_t[:, :, jj]
    incl = _team_scan([CT, CB], cong_combine)
    pre_T, pre_B = _exclusive(incl, [eye, torch.zeros(m, m, dtype=f64)])
    start = _group_chain([t[:, -1] for t in incl], cong_combine,
                         lambda T, B, G: T @ G @ T.T + B, torch.zeros(m, m, dtype=f64))
    G = pre_T @ start[:, None] @ pre_T.transpose(-1, -2) + pre_B

    # Phase C: Gbar at each element, then the outputs elementwise.
    Gbar = torch.empty(nt, teams, sub, m, m, dtype=f64)
    for jj in range(sub):
        k = idx[:, :, jj]
        E = At_t[:, :, jj]
        Gbar[:, :, jj] = G
        G = E @ G @ E.transpose(-1, -2) + Fpbar[:, :, jj, :, None] * p[k][..., None, :]
    mu, Fpbar, Gbar = (x.reshape(nt * tile, *x.shape[3:]) for x in (mu, Fpbar, Gbar))
    _, ubar, c2bar = glue(slice(None), mu)
    Sm = Gbar + Gbar.transpose(-1, -2)
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


def _bind_schedule(lib: ctypes.CDLL) -> None:
    """``qsl_bwd_schedule(m, bytes, *tile, *sub)``: B2's association on the
    card, which :data:`_B2_SCHEDULE` repeats."""
    lib.qsl_bwd_schedule.argtypes = [ctypes.c_int, ctypes.c_int,
                                     ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.qsl_bwd_schedule.restype = ctypes.c_int


@functools.cache
def _library() -> ctypes.CDLL:
    """B1 and B1r's library, built at first use, with its C signatures."""
    lib = cuda_build.library("quasisep_loglik")
    lib.qsl_workspace_elems.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.qsl_workspace_elems.restype = ctypes.c_longlong
    _bind(lib, "qsl_loglik", 7)  # d ps qs as y | out | work
    _bind(lib, "qsl_loglik_res", 10)  # d ps qs as y | out Fs e ic | work
    return lib


@functools.cache
def _bwd_library() -> ctypes.CDLL:
    """B2's library, built at first use, with its C signatures."""
    lib = cuda_build.library("quasisep_loglik_bwd")
    lib.qsl_bwd_workspace_elems.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.qsl_bwd_workspace_elems.restype = ctypes.c_longlong
    # ps qs as y Fs e ic qbar lbar | dbar psbar qsbar asbar ybar | work
    _bind(lib, "qsl_loglik_bwd", 15)
    _bind_schedule(lib)
    return lib


@functools.cache
def _generic_library() -> ctypes.CDLL:
    """B1, B1r and B2 for 4 < m <= 32, built at first use: the same C
    signatures as the templated libraries."""
    lib = cuda_build.library("quasisep_loglik_generic")
    for name in ("qsl_workspace_elems", "qsl_bwd_workspace_elems"):
        getattr(lib, name).argtypes = [ctypes.c_int, ctypes.c_int]
        getattr(lib, name).restype = ctypes.c_longlong
    _bind(lib, "qsl_loglik", 7)
    _bind(lib, "qsl_loglik_res", 10)
    _bind(lib, "qsl_loglik_bwd", 15)
    _bind_schedule(lib)
    return lib


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


def _launch(lib, prefix, work_elems_fn, m, n, tensors) -> None:
    """Run ``<prefix>_<dtype>`` on the tensors' device and current stream,
    with a float64 workspace (the kernels' scans run in float64); raise on
    a refused argument or launch."""
    ref = tensors[0]
    with torch.cuda.device(ref.device):
        work_elems = work_elems_fn(m, n)
        work = torch.empty(work_elems, dtype=torch.float64, device=ref.device)
        stream = torch.cuda.current_stream(ref.device).cuda_stream
        err = getattr(lib, f"{prefix}_{_DTYPES[ref.dtype]}")(
            m, n, *(t.data_ptr() for t in tensors), work.data_ptr(),
            work_elems, stream,
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
    lib = _library() if m <= _MAX_M else _generic_library()
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
    lib = _library() if m <= _MAX_M else _generic_library()
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
    lib = _bwd_library() if m <= _MAX_M else _generic_library()
    outs = (y.new_empty(n), y.new_empty(m, n), y.new_empty(m, n),
            y.new_empty(m * m, n), y.new_empty(n))
    _launch(
        lib, "qsl_loglik_bwd", lib.qsl_bwd_workspace_elems, m, n,
        (ps, qs, as_, y, Fs, e, ic, qbar, lbar) + outs,
    )
    LAUNCHES_BWD += 1
    LAUNCHES_GENERIC["b2"] += m > _MAX_M
    return outs


class FusedLoglik(torch.autograd.Function):
    """``(quad, logdet)`` with a hand-written gradient: forward B1r, which
    saves ``(ps, qs, as_, y, Fs, e, ic)``, and backward B2 (on the CPU,
    their plain versions). Once differentiable: a second derivative
    raises."""

    @staticmethod
    def forward(ctx, d, ps, qs, as_, y):
        quad, logdet, Fs, e, ic = fused_loglik_res(d, ps, qs, as_, y)
        ctx.save_for_backward(ps, qs, as_, y, Fs, e, ic)
        return quad, logdet

    @staticmethod
    def backward(ctx, qbar, lbar):
        # Grad mode is on here exactly when the caller asked for a graph of
        # the gradient (create_graph=True), which B2 cannot give.
        if torch.is_grad_enabled():
            raise RuntimeError(
                "the fused log-likelihood is once differentiable: its "
                "backward kernel has no derivative (create_graph=True)"
            )
        ps, qs, as_, y, Fs, e, ic = ctx.saved_tensors
        qbar, lbar = (g.to(ps.dtype).reshape(()).contiguous() for g in (qbar, lbar))
        return fused_loglik_bwd(ps, qs, as_, y, Fs, e, ic, qbar, lbar)


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
    enabled and an operand requiring it, this is :class:`FusedLoglik`
    (B1r, then B2 in the backward); otherwise B1. CPU tensors take the
    plain versions on either route.
    """
    operands = (d, ps, qs, as_, y)
    if torch.is_grad_enabled() and any(x.requires_grad for x in operands):
        return FusedLoglik.apply(*operands)
    return _loglik_b1(*operands)
