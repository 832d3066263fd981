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
  affine-adjoint scan and a reverse congruence scan.

Those sources are templated for m = 1..4. For 4 < m <= 32 the same three
entry points run ``csrc/quasisep_loglik_generic.cu``, which has the same C
interface: each call is a short sequence of the generic-order scan engine
and hand-written elementwise and reduction kernels, with the same
arithmetic. Above 32 a CUDA operand raises (ROADMAP item N10).

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
"""Calls that launched kernel B2, the backward."""
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
