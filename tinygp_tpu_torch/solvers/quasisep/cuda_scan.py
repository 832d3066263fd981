"""The generic monoid scan of the quasiseparable algebra: kernel B3, its
wrappers and their plain versions.

Counterpart of ``tinygp_tpu/solvers/quasisep/pallas_scan.py``. Kernel B3
replaces ``pallas_scan._scan_kernel``, the TPU's exclusive monoid scan,
forward or reverse, with pruned outputs, at any order. It has two CUDA
sources: ``csrc/quasisep_scan.cu``, templated for m = 1..4 (the coupling
for two equal orders up to 4), and the generic-order engine
``csrc/quasisep_generic.cu``, which takes the order at run time, for every
other order up to 32 and any pair of coupling orders. One
wrapper per monoid, each on stacked operands (components first, the data
axis last, as :mod:`~tinygp_tpu_torch.solvers.quasisep.scan` lays them
out):

- :func:`affine`: ``g' = A g + B`` with ``r`` right-hand-side columns;
- :func:`congruence`: ``g' = A g A^T + B``;
- :func:`riccati`: the Riccati covariance flow from ``(d, p, q, a)``;
- :func:`coupling`: ``g' = A g B^T + C``, the QSM product's coupling.

Each runs its plain version, the stacked scans of ``scan.py`` through the
blocked ``monoid_scan``, for CPU tensors, and launches B3 for CUDA
tensors, or raises; none falls back. An order above 32 on the card raises
with ROADMAP item N10. B3 has no backward: a CUDA operand that requires a
gradient raises instead of returning a result that autograd would cut.

Every launch adds one to :data:`LAUNCHES` under its monoid's name, and a
launch of the generic engine also to :data:`LAUNCHES_GENERIC`.
"""

from __future__ import annotations

__all__ = ["LAUNCHES", "LAUNCHES_GENERIC", "affine", "congruence", "riccati", "coupling"]

import ctypes
import functools

import torch

from tinygp_tpu_torch import cuda_build
from tinygp_tpu_torch.solvers.quasisep import scan as _scan

LAUNCHES = {"aff": 0, "cong": 0, "ric": 0, "cpl": 0}
"""Calls that launched kernel B3, by monoid (one per call of its C entry,
which enqueues the kernel's passes)."""
LAUNCHES_GENERIC = {"aff": 0, "cong": 0, "ric": 0, "cpl": 0}
"""Of those, the calls that went to the generic-order engine."""

_KIND = {"aff": 0, "cong": 1, "ric": 2, "cpl": 3}
_MAX_M = 4  # the templated kernel's orders
_MAX_GENERIC_M = 32
_MAX_COLUMNS = 65535
_DTYPES = {torch.float32: "f32", torch.float64: "f64"}


@functools.cache
def _library() -> ctypes.CDLL:
    """B3's library, built at first use, with its C signatures."""
    lib = cuda_build.library("quasisep_scan")
    lib.qss_workspace_elems.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int
    ]
    lib.qss_workspace_elems.restype = ctypes.c_longlong
    for suffix in _DTYPES.values():
        fn = getattr(lib, f"qss_scan_{suffix}")
        # kind m n r reverse inclusive | x0 x1 x2 x3 out work | work_elems stream
        fn.argtypes = (
            [ctypes.c_int, ctypes.c_int, ctypes.c_longlong]
            + [ctypes.c_int] * 3
            + [ctypes.c_void_p] * 6
            + [ctypes.c_longlong, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    lib.qss_error_string.argtypes = [ctypes.c_int]
    lib.qss_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _generic_library() -> ctypes.CDLL:
    """The generic-order engine's library, built at first use."""
    lib = cuda_build.library("quasisep_generic")
    lib.qsg_workspace_elems.argtypes = [ctypes.c_int] * 3 + [ctypes.c_longlong, ctypes.c_int]
    lib.qsg_workspace_elems.restype = ctypes.c_longlong
    for suffix in _DTYPES.values():
        fn = getattr(lib, f"qsg_scan_{suffix}")
        # kind m m2 n r reverse inclusive | x0 x1 x2 x3 out work | work_elems stream
        fn.argtypes = (
            [ctypes.c_int] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 3
            + [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    lib.qsg_error_string.argtypes = [ctypes.c_int]
    lib.qsg_error_string.restype = ctypes.c_char_p
    return lib


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(x.device.type == "cpu" for x in tensors)


def _launch(monoid, m, r, reverse, inclusive, operands, out_rows, m2=None):
    """Check the operands, run B3 for ``monoid`` on their device and current
    stream with a float64 workspace, and return the ``(out_rows, N)``
    output; raise on anything the kernel does not take. ``m2`` is the
    coupling's second order. Orders up to 4 (the coupling's equal) go to
    the templated kernel, the rest to the generic-order engine."""
    m2 = m if m2 is None else m2
    ref = operands[0]
    n = ref.shape[-1]
    for x in operands:
        if x.device != ref.device:
            raise ValueError("all operands must be on one device")
        if x.dtype != ref.dtype:
            raise ValueError("all operands must have one dtype")
        if not x.is_contiguous():
            raise ValueError("B3 takes contiguous operands")
        if x.shape[-1] != n:
            raise ValueError("all operands must have one length along the data axis")
    if ref.device.type != "cuda":
        raise ValueError(f"no kernel for device {ref.device}")
    if ref.dtype not in _DTYPES:
        raise ValueError(f"B3 takes float32 or float64, not {ref.dtype}")
    if max(m, m2) > _MAX_GENERIC_M:
        raise NotImplementedError(
            f"kernel B3 takes orders up to {_MAX_GENERIC_M}; this {monoid} scan has "
            f"({m}, {m2}), which is ROADMAP item N10 (orders above 32 on CUDA)"
        )
    if torch.is_grad_enabled() and any(x.requires_grad for x in operands):
        raise NotImplementedError(
            "kernel B3 has no backward; gradients through the O(N) algebra "
            "on the card are ROADMAP item N8"
        )
    if not 1 <= r <= _MAX_COLUMNS:
        raise ValueError(f"B3 takes 1 to {_MAX_COLUMNS} columns; got {r}")
    if not 1 <= n < 2**40:
        raise ValueError(f"N must be in [1, 2**40); got {n}")
    generic = m != m2 or m > _MAX_M
    kind = _KIND[monoid]
    out = ref.new_empty(out_rows, n)
    ptrs = [x.data_ptr() for x in operands] + [None] * (4 - len(operands))
    with torch.cuda.device(ref.device):
        if generic:
            lib, prefix = _generic_library(), "qsg"
            head = (kind, m, m2)
            work_elems = lib.qsg_workspace_elems(kind, m, m2, n, r)
        else:
            lib, prefix = _library(), "qss"
            head = (kind, m)
            work_elems = lib.qss_workspace_elems(kind, m, n, r)
        if work_elems < 0:
            raise ValueError(f"B3 refuses the {monoid} scan of order ({m}, {m2}), r = {r}")
        work = torch.empty(work_elems, dtype=torch.float64, device=ref.device)
        stream = torch.cuda.current_stream(ref.device).cuda_stream
        err = getattr(lib, f"{prefix}_scan_{_DTYPES[ref.dtype]}")(
            *head, n, r, int(reverse), int(inclusive), *ptrs, out.data_ptr(),
            work.data_ptr(), work_elems, stream,
        )
    if err:
        raise RuntimeError(
            f"quasisep scan kernel ({monoid}) failed: "
            f"{getattr(lib, prefix + '_error_string')(err).decode()} (cudaError {err})"
        )
    LAUNCHES[monoid] += 1
    if generic:
        LAUNCHES_GENERIC[monoid] += 1
    return out


def _check_rows(name: str, x: torch.Tensor, rows: int) -> None:
    if x.ndim != 2 or x.shape[0] != rows:
        raise ValueError(f"{name} must be ({rows}, N); got {tuple(x.shape)}")


def affine(
    As: torch.Tensor,
    Bs: torch.Tensor,
    m: int,
    r: int,
    *,
    reverse: bool,
    exclusive: bool,
) -> torch.Tensor:
    """States ``(m*r, N)`` of ``g_k = A_k g + B_k`` from ``g = 0``: As
    ``(m*m, N)``, Bs ``(m*r, N)`` (row ``i*r + j`` is component i of
    column j). B3 scans each column as its own ``Aff<m>``."""
    if _on_cpu(As, Bs):
        return _scan._affine_scan_s(As, Bs, m, r, reverse=reverse, exclusive=exclusive)
    _check_rows("As", As, m * m)
    _check_rows("Bs", Bs, m * r)
    return _launch("aff", m, r, reverse, not exclusive, (As, Bs), m * r)


def congruence(
    As: torch.Tensor, Bs: torch.Tensor, m: int, *, reverse: bool
) -> torch.Tensor:
    """The exclusive prefix ``(m*m, N)`` of ``g_k = A_k g A_k^T + B_k``."""
    if _on_cpu(As, Bs):
        return _scan._congruence_scan_s(As, Bs, m, reverse=reverse)
    _check_rows("As", As, m * m)
    _check_rows("Bs", Bs, m * m)
    return _launch("cong", m, 1, reverse, False, (As, Bs), m * m)


def riccati(
    d: torch.Tensor, ps: torch.Tensor, qs: torch.Tensor, as_: torch.Tensor
) -> torch.Tensor:
    """The exclusive Riccati flow ``F`` ``(m*m, N)`` of ``d`` ``(N,)``,
    ``ps``/``qs`` ``(m, N)`` and ``as_`` ``(m*m, N)``."""
    m = ps.shape[0]
    if _on_cpu(d, ps, qs, as_):
        return _scan._riccati_scan_s(d, ps, qs, as_, m)
    if d.ndim != 1:
        raise ValueError(f"d must be (N,); got {tuple(d.shape)}")
    _check_rows("qs", qs, m)
    _check_rows("as_", as_, m * m)
    return _launch("ric", m, 1, False, False, (d, ps, qs, as_), m * m)


def coupling(
    As: torch.Tensor,
    Bs: torch.Tensor,
    Cs: torch.Tensor,
    m1: int,
    m2: int,
    *,
    reverse: bool,
    exclusive: bool = True,
) -> torch.Tensor:
    """States ``(m1*m2, N)`` of ``g_k = A_k g B_k^T + C_k`` from ``g = 0``:
    As ``(m1*m1, N)``, Bs ``(m2*m2, N)``, Cs ``(m1*m2, N)``."""
    if _on_cpu(As, Bs, Cs):
        return _scan._coupling_scan_s(
            As, Bs, Cs, m1, m2, reverse=reverse, exclusive=exclusive
        )
    _check_rows("As", As, m1 * m1)
    _check_rows("Bs", Bs, m2 * m2)
    _check_rows("Cs", Cs, m1 * m2)
    return _launch("cpl", m1, 1, reverse, not exclusive, (As, Bs, Cs), m1 * m2, m2=m2)
