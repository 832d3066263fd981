"""The fused quasiseparable log-likelihood: CUDA kernel, wrapper and plain
version.

Counterpart of ``tinygp_tpu/solvers/quasisep/pallas_loglik.py``. The
kernel (``csrc/quasisep_loglik.cu``) replaces the TPU kernel
``pallas_loglik._loglik_kernel``: one call computes ``(quad, logdet) =
(sum alpha^2, sum log c)`` for ``K = diag(d) + tril(p, q, a) + tril^T``,
running the Riccati scan, the Cholesky emissions, the whitening scan and
both reductions on the card. Its scans run in float64 for float32 operands
too: composed in float32, the Riccati maps of long spans lose the state
(see the note in the source).

:func:`fused_loglik_terms` is the wrapper. For tensors on the CPU it runs
:func:`plain_loglik_terms`, the plain PyTorch version (the JAX package's
non-kernel route, ``ops.py:203-219``, over the blocked
:func:`~tinygp_tpu_torch.solvers.quasisep.scan.monoid_scan`). For CUDA
tensors it launches the kernel or raises; it never falls back. Each launch
adds one to :data:`LAUNCHES`.

Not ported yet: the residuals variant and the backward kernel (kernels
B1r and B2: ROADMAP item N1, the gradient slice). Until then a CUDA input that
requires grad raises rather than returning a value without a gradient.
"""

from __future__ import annotations

__all__ = ["LAUNCHES", "fused_loglik_terms", "plain_loglik_terms"]

import ctypes
import functools

import torch

from tinygp_tpu_torch import cuda_build
from tinygp_tpu_torch.solvers.quasisep import scan as _scan

LAUNCHES = 0
"""Calls that launched the CUDA kernel (one per call of its C entry, which
enqueues the kernel's six passes)."""

_MAX_M = 4
_ENTRY = {torch.float32: "qsl_loglik_f32", torch.float64: "qsl_loglik_f64"}


def plain_loglik_terms(
    d: torch.Tensor,
    ps: torch.Tensor,
    qs: torch.Tensor,
    as_: torch.Tensor,
    y: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(alpha . alpha, sum(log c))`` in plain PyTorch: the Riccati scan,
    the Cholesky emissions and the whitening affine scan, all stacked."""
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
    return torch.sum(torch.square(alpha)), torch.sum(torch.log(c))


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel's library, built at first use, with its C signatures."""
    lib = cuda_build.library("quasisep_loglik")
    ptr = ctypes.c_void_p
    lib.qsl_workspace_elems.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.qsl_workspace_elems.restype = ctypes.c_longlong
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ptr] * 7 + [ctypes.c_longlong, ptr]
        fn.restype = ctypes.c_int
    lib.qsl_error_string.argtypes = [ctypes.c_int]
    lib.qsl_error_string.restype = ctypes.c_char_p
    return lib


def _check(d, ps, qs, as_, y) -> int:
    """Validate what the kernel takes; return m."""
    if ps.ndim != 2:
        raise ValueError(f"ps must be (m, N); got shape {tuple(ps.shape)}")
    m, n = ps.shape
    want = {"d": (n,), "ps": (m, n), "qs": (m, n), "as_": (m * m, n), "y": (n,)}
    args = {"d": d, "ps": ps, "qs": qs, "as_": as_, "y": y}
    for name, x in args.items():
        if tuple(x.shape) != want[name]:
            raise ValueError(
                f"{name} must have shape {want[name]} (unbatched); got "
                f"{tuple(x.shape)}"
            )
        if x.device != d.device:
            raise ValueError("all operands must be on one device")
        if x.dtype != d.dtype:
            raise ValueError("all operands must have one dtype")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.requires_grad:
            raise NotImplementedError(
                "the CUDA log-likelihood has no backward kernel yet (ROADMAP "
                "item N1, the gradient slice); detach the inputs "
                "or run under torch.no_grad()"
            )
    if d.dtype not in _ENTRY:
        raise ValueError(f"the kernel takes float32 or float64, not {d.dtype}")
    if m > _MAX_M:
        raise NotImplementedError(
            f"the CUDA log-likelihood takes m <= {_MAX_M}; m = {m} is ROADMAP "
            "item N6 (m > 4 on CUDA)"
        )
    if not 1 <= n < 2**31:
        raise ValueError(f"N must be in [1, 2**31); got {n}")
    return m


def fused_loglik_terms(
    d: torch.Tensor,
    ps: torch.Tensor,
    qs: torch.Tensor,
    as_: torch.Tensor,
    y: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(quad, logdet)``: the kernel for CUDA tensors, the plain version
    for CPU tensors.

    Operands are stacked and unbatched: ``d``/``y`` ``(N,)``, ``ps``/``qs``
    ``(m, N)``, ``as_`` ``(m*m, N)``, one dtype, contiguous.
    """
    global LAUNCHES
    if all(x.device.type == "cpu" for x in (d, ps, qs, as_, y)):
        return plain_loglik_terms(d, ps, qs, as_, y)
    m = _check(d, ps, qs, as_, y)
    if d.device.type != "cuda":
        raise ValueError(f"no kernel for device {d.device}")
    n = d.shape[0]
    lib = _library()
    with torch.cuda.device(d.device):
        out = torch.empty(2, dtype=d.dtype, device=d.device)
        work_elems = lib.qsl_workspace_elems(m, n)
        # The kernel's scans run in float64 for either operand type.
        work = torch.empty(work_elems, dtype=torch.float64, device=d.device)
        stream = torch.cuda.current_stream(d.device).cuda_stream
        err = getattr(lib, _ENTRY[d.dtype])(
            m, n,
            d.data_ptr(), ps.data_ptr(), qs.data_ptr(), as_.data_ptr(),
            y.data_ptr(), out.data_ptr(), work.data_ptr(),
            work_elems, stream,
        )
    if err:
        raise RuntimeError(
            f"quasisep log-likelihood kernel failed: "
            f"{lib.qsl_error_string(err).decode()} (cudaError {err})"
        )
    LAUNCHES += 1
    return out[0], out[1]
