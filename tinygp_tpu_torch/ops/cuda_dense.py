"""The blocked Cholesky's matrix products: kernels B4, B5 and B6, their
wrappers and their plain versions.

Counterpart of ``tinygp_tpu/ops/pallas_dense.py``. The kernels are in
``csrc/dense_syrk.cu`` (float32):

- :func:`split_panel_matmul` (B5): ``A[r0:r0+rows, c0:c0+b] @ W``, the
  panel read in place through ``A``'s row stride;
- :func:`syrk_sub_inplace` (B4): in place, ``T[off:, off:] -= L L^T`` on
  the lower part of the trailing submatrix, and with ``ak`` the row side
  products ``rowsq = sum(L**2, 1)`` and ``rsu = L @ ak``;
- :func:`syrk_sub` (B6): out of place, ``T - L L^T``, with ``lower_only``
  zeros above the diagonal at ``tile`` granularity.

The TPU kernels reach float32 accuracy through bf16 splits (``terms`` 3
about 2^-24, 2 about 2^-16); these kernels accumulate in float32 FMA,
which meets the 3-term contract, except that B5 accumulates in float64
for ``terms=3`` (the order the factorization picks for ill-conditioned
matrices, where the panel's product with an explicit inverse cancels; see
the source). The wrappers take and check
``terms`` and ``tile`` with the JAX package's rules, so the factorization reads
like the JAX one.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel or
raises, with no fallback. Every launch adds one to :data:`LAUNCHES` under
its kernel's name (B4 with ``ak`` counts under ``syrk_inplace_extras``).
After B4 only the lower triangle of the trailing submatrix is defined: the
plain version subtracts ``tril(L L^T)`` and leaves the upper triangle as it
was; the kernel may update more (see the source).
"""

from __future__ import annotations

__all__ = [
    "LAUNCHES",
    "split_panel_matmul",
    "syrk_sub_inplace",
    "syrk_sub",
    "plain_panel_matmul",
    "plain_syrk_sub_inplace",
    "plain_syrk_sub",
]

import ctypes
import functools

import torch

from tinygp_tpu_torch import cuda_build

LAUNCHES = {"panel": 0, "syrk_inplace": 0, "syrk_inplace_extras": 0, "syrk": 0}
"""Launches of B5 (``panel``), B4 without and with the row side products,
and B6 (``syrk``)."""

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernels' library, built at first use, with its C signatures."""
    lib = cuda_build.library("dense_syrk")
    lib.dsk_panel_matmul.argtypes = [_P, _LL, _P, _LL, _P, _LL, _I, _I, _I, _P]
    lib.dsk_syrk_inplace.argtypes = [_P, _LL, _P, _LL, _I, _I, _P, _P, _P, _P]
    lib.dsk_syrk.argtypes = [_P, _LL, _P, _LL, _I, _I, _P, _LL, _I, _I, _P]
    for fn in (lib.dsk_panel_matmul, lib.dsk_syrk_inplace, lib.dsk_syrk):
        fn.restype = ctypes.c_int
    lib.dsk_error_string.argtypes = [ctypes.c_int]
    lib.dsk_error_string.restype = ctypes.c_char_p
    return lib


def _runs_plain(terms: int, tile: int, *tensors: torch.Tensor) -> bool:
    """Check what every kernel takes; return whether the tensors lie on the
    CPU (run the plain version) rather than on one CUDA device."""
    if terms not in (2, 3):
        raise ValueError(f"terms must be 2 or 3; got {terms}")
    if tile < 1:
        raise ValueError(f"tile must be positive; got {tile}")
    ref = tensors[0]
    for x in tensors:
        if x.device != ref.device:
            raise ValueError("all operands must be on one device")
        if x.dtype != torch.float32:
            raise ValueError(f"the dense kernels take float32, not {x.dtype}")
        if x.ndim >= 1 and x.stride(-1) != 1:
            raise ValueError("the dense kernels take operands with contiguous rows")
    if ref.device.type == "cpu":
        return True
    if ref.device.type != "cuda":
        raise ValueError(f"no kernel for device {ref.device}")
    if torch.is_grad_enabled() and any(x.requires_grad for x in tensors):
        raise NotImplementedError(
            "the dense kernels have no backward of their own; differentiate "
            "through ops.dense, whose autograd Functions run them without grad"
        )
    return False


def _run(name: str, fn, *args) -> None:
    """Launch on the operands' device and current stream; raise on a
    refused argument or a failed launch."""
    lib = _library()
    err = getattr(lib, fn)(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(
            f"dense kernel {name} failed: {lib.dsk_error_string(err).decode()} "
            f"(cudaError {err})"
        )
    LAUNCHES[name] += 1


def plain_panel_matmul(
    A: torch.Tensor, W: torch.Tensor, r0: int, c0: int, rows: int
) -> torch.Tensor:
    """B5's plain version: ``A[r0:r0+rows, c0:c0+b] @ W``."""
    b = W.shape[0]
    return A[r0 : r0 + rows, c0 : c0 + b] @ W


def split_panel_matmul(
    A: torch.Tensor,
    W: torch.Tensor,
    *,
    tile: int = 256,
    terms: int = 3,
    at: tuple[int, int] | None = None,
    rows: int | None = None,
) -> torch.Tensor:
    """``A[at[0]:at[0]+rows, at[1]:at[1]+b] @ W`` (B5), ``(rows, b)``.

    ``W`` is ``(b, b)``. With ``at=None`` the whole of ``A``, ``(rows, b)``,
    is the panel; with ``at=(r0, c0)`` the panel is read out of the larger
    ``A`` in place. ``rows`` and ``r0`` are multiples of ``tile``, ``c0``
    of ``b``, as the JAX launcher asks.
    """
    b = W.shape[0]
    if at is None:
        at, rows = (0, 0), A.shape[0]
    r0, c0 = at
    if W.shape != (b, b) or A.ndim != 2:
        raise ValueError(f"W must be square and A 2-d; got {tuple(W.shape)}, {tuple(A.shape)}")
    if rows is None or rows % tile or r0 % tile or c0 % b:
        raise ValueError(
            f"rows ({rows}) and r0 ({r0}) must be multiples of tile ({tile}), c0 ({c0}) of b ({b})"
        )
    if r0 + rows > A.shape[0] or c0 + b > A.shape[1]:
        raise ValueError(f"the panel at {at} with {rows} rows lies outside A {tuple(A.shape)}")
    if _runs_plain(terms, tile, A, W):
        return plain_panel_matmul(A, W, r0, c0, rows)
    W = W.contiguous()
    out = A.new_empty(rows, b)
    panel = A[r0:, c0:]
    with torch.cuda.device(A.device):
        _run("panel", "dsk_panel_matmul", panel.data_ptr(), A.stride(0), W.data_ptr(),
             W.stride(0), out.data_ptr(), out.stride(0), rows, b, int(terms == 3))
    return out


def plain_syrk_sub_inplace(
    T: torch.Tensor, L: torch.Tensor, offset: int, ak: torch.Tensor | None = None
):
    """B4's plain version: ``T[offset:, offset:] -= tril(L @ L.T)`` in
    place; with ``ak`` also ``(sum(L**2, 1), L @ ak)``."""
    T[offset:, offset:] -= torch.tril(L @ L.T)
    if ak is None:
        return T
    return T, torch.sum(L * L, dim=1), L @ ak


def syrk_sub_inplace(
    T: torch.Tensor,
    L: torch.Tensor,
    *,
    offset: int,
    tile: int = 256,
    terms: int = 3,
    ak: torch.Tensor | None = None,
):
    """In place ``T[offset:, offset:] -= L @ L.T`` on the lower part (B4).

    ``T`` is ``(m, m)``, ``L`` ``(m - offset, b)``; ``offset`` and ``m`` are
    multiples of ``tile``. Returns ``T`` (the same tensor), or with ``ak``
    ``(b,)`` the triple ``(T, rowsq, rsu)`` with ``rowsq[r] = sum(L[r]**2)``
    and ``rsu = L @ ak``. Only the lower triangle of the trailing submatrix
    is defined afterwards.
    """
    m = T.shape[0]
    mt, b = L.shape
    if T.shape != (m, m) or offset % tile or m % tile or mt != m - offset:
        raise ValueError(
            f"T {tuple(T.shape)} and L {tuple(L.shape)} do not fit offset {offset} "
            f"at tile {tile}"
        )
    if ak is not None and ak.shape != (b,):
        raise ValueError(f"ak must be ({b},); got {tuple(ak.shape)}")
    operands = (T, L) if ak is None else (T, L, ak)
    if _runs_plain(terms, tile, *operands):
        return plain_syrk_sub_inplace(T, L, offset, ak)
    if L.stride(0) < b:
        L = L.contiguous()
    trail = T[offset:, offset:]
    with torch.cuda.device(T.device):
        if ak is None:
            _run("syrk_inplace", "dsk_syrk_inplace", trail.data_ptr(), T.stride(0),
                 L.data_ptr(), L.stride(0), mt, b, None, None, None)
            return T
        ak = ak.contiguous()
        rowsq, rsu = L.new_empty(mt), L.new_empty(mt)
        _run("syrk_inplace_extras", "dsk_syrk_inplace", trail.data_ptr(), T.stride(0),
             L.data_ptr(), L.stride(0), mt, b, ak.data_ptr(), rowsq.data_ptr(),
             rsu.data_ptr())
    return T, rowsq, rsu


def plain_syrk_sub(
    T: torch.Tensor, L: torch.Tensor, tile: int, lower_only: bool = False
) -> torch.Tensor:
    """B6's plain version: ``T - L @ L.T``, with ``lower_only`` zeros where
    ``col // tile > row // tile``."""
    out = T - L @ L.T
    if lower_only:
        blocks = torch.arange(T.shape[0], device=T.device) // tile
        out = torch.where(blocks[None, :] > blocks[:, None], out.new_zeros(()), out)
    return out


def syrk_sub(
    T: torch.Tensor,
    L: torch.Tensor,
    *,
    tile: int = 256,
    terms: int = 3,
    lower_only: bool = False,
) -> torch.Tensor:
    """``T - L @ L.T`` out of place (B6): ``T`` ``(m, m)``, ``L`` ``(m, b)``,
    ``m`` a multiple of ``tile``. With ``lower_only`` the tiles above the
    diagonal are zeros."""
    m, b = L.shape
    if T.shape != (m, m) or m % tile:
        raise ValueError(f"T {tuple(T.shape)} and L {tuple(L.shape)} do not fit tile {tile}")
    if _runs_plain(terms, tile, T, L):
        return plain_syrk_sub(T, L, tile, lower_only)
    out = T.new_empty(m, m)
    with torch.cuda.device(T.device):
        _run("syrk", "dsk_syrk", T.data_ptr(), T.stride(0), L.data_ptr(), L.stride(0), m, b,
             out.data_ptr(), out.stride(0), int(lower_only), tile)
    return out
