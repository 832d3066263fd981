"""The blocked Cholesky's matrix products: kernels B4, B5 and B6, their
wrappers and their plain versions.

Counterpart of ``tinygp_tpu/ops/pallas_dense.py`` (float32):

- :func:`split_panel_matmul` (B5, ``csrc/dense_tc.cu``; at ``terms=3``
  ``csrc/dense_syrk.cu``): ``A[r0:r0+rows, c0:c0+b] @ W``, the panel read
  in place through ``A``'s row stride;
- :func:`syrk_sub_inplace` (B4, ``csrc/dense_tc.cu``): in place,
  ``T[off:, off:] -= L L^T`` on the lower part of the trailing submatrix,
  and with ``ak`` the row side products ``rowsq = sum(L**2, 1)`` and
  ``rsu = L @ ak``;
- :func:`syrk_sub` (B6, ``csrc/dense_tc.cu``): out of place, ``T - L L^T``,
  with ``lower_only`` zeros above the diagonal at ``tile`` granularity.

The TPU kernels reach float32 accuracy through bf16 splits (``terms`` 3
about 2^-24, 2 about 2^-16). B4, B5 and B6 do the same on Hopper's tensor
cores: a split pass writes the three bf16 pieces (:func:`split_pieces` is
its plain version, equal bit for bit), and a ``wgmma`` GEMM sums the six
piece products of :func:`plain_split_dots` at 3 terms in float32, whatever
``terms`` asks for: the 2-term products missed the dense gradient's limit
on the main path (see the source). B5's 3-term order, which the
factorization picks for ill-conditioned matrices (where the panel's
product with an explicit inverse cancels), needs float64 sums and runs on
the float64 tensor cores in ``csrc/dense_syrk.cu`` instead: exact
products of the float32 values and float64 sums, in the order
:func:`plain_panel_matmul_f64` repeats. B6 computes the lower
tile pairs only and mirrors them (:func:`plain_syrk_by_tiles` is its
schedule in plain PyTorch); B4 computes the lower tile pairs of the
trailing submatrix in place, with its row side products in the split pass
(:func:`plain_syrk_inplace_by_tiles`). The wrappers take and check
``terms`` and ``tile`` with the JAX package's rules, so the factorization
reads like the JAX one.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel or
raises, with no fallback. Every launch adds one to :data:`LAUNCHES` under
its kernel's name (B4 with ``ak`` counts under ``syrk_inplace_extras``),
every launch of the split pass to :data:`LAUNCHES_SPLIT` and every one of
B5's float64-sum body to :data:`LAUNCHES_F64`.
After B4 only the lower triangle of the trailing submatrix is defined: the
plain version subtracts ``tril(L L^T)`` and leaves the upper triangle as it
was; the kernel updates the diagonal 128 x 128 tiles whole (see the
source).
"""

from __future__ import annotations

__all__ = [
    "LAUNCHES",
    "LAUNCHES_SPLIT",
    "LAUNCHES_F64",
    "KERNEL_TILE",
    "K_CHUNK",
    "split_panel_matmul",
    "syrk_sub_inplace",
    "syrk_sub",
    "split_pass",
    "split_pieces",
    "plain_split_dots",
    "plain_panel_matmul",
    "plain_panel_matmul_f64",
    "panel_splits",
    "plain_syrk_sub_inplace",
    "plain_syrk_sub",
    "plain_syrk_by_tiles",
    "plain_syrk_inplace_by_tiles",
    "plain_row_sums",
    "lower_pair",
    "gemm_config",
]

import contextlib
import ctypes
import functools
import math

import torch

from tinygp_tpu_torch import cuda_build

LAUNCHES = {"panel": 0, "syrk_inplace": 0, "syrk_inplace_extras": 0, "syrk": 0}
"""Launches of B5 (``panel``), B4 without and with the row side products,
and B6 (``syrk``)."""

LAUNCHES_SPLIT = 0
"""Launches of the split pass: alone (:func:`split_pass`) and as the first
pass of B4, of B5 at 2 terms and of B6."""

LAUNCHES_F64 = 0
"""Launches of B5's 3-term order (its float64-sum body), which also count
under ``panel``."""

KERNEL_TILE = 128
"""The tensor-core kernels' output tile rows (``kBM`` in
``csrc/dense_tc.cu``), to which the split pass pads the pieces' rows."""

K_CHUNK = 64
"""The tensor-core GEMM's k-chunk (``kBK``), to which the pieces' columns
are padded."""

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int

# C entries: (library stem, argument types before the stream).
_SIGNATURES = {
    "dsk_syrk_inplace_tc": ("dense_tc", [_P, _LL, _P, _LL, _I, _I, _P, _P, _P, _P, _LL]),
    "dsk_panel_matmul": ("dense_tc", [_P, _LL, _P, _LL, _LL, _P, _LL, _I, _I, _P, _LL]),
    "dsk_panel_matmul_f64": ("dense_syrk", [_P, _LL, _P, _LL, _LL, _P, _LL, _I, _I]),
    "dsk_syrk": ("dense_tc", [_P, _LL, _P, _LL, _I, _I, _P, _LL, _I, _I, _P, _LL]),
    "dsk_split": ("dense_tc", [_P, _LL, _LL, _I, _I, _P, _LL]),
}
# The C entries whose launch starts with the split pass.
_SPLITS = ("dsk_split", "dsk_panel_matmul", "dsk_syrk", "dsk_syrk_inplace_tc")


def gemm_config() -> dict[str, int]:
    """The tensor-core GEMM's configuration (B5 at 2 terms, B6): output
    tile rows and columns, ring stages and dynamic shared memory in
    bytes."""
    fn = cuda_build.library("dense_tc").dsk_gemm_config
    out = [_I() for _ in range(4)]
    fn.argtypes = [ctypes.POINTER(_I)] * 4
    fn.restype = None
    fn(*(ctypes.byref(x) for x in out))
    return dict(zip(("bm", "bn", "stages", "smem"), (x.value for x in out)))


@functools.cache
def _function(fn: str):
    """The C entry ``fn`` and its library's error-string function, built
    at first use, with their C signatures."""
    stem, argtypes = _SIGNATURES[fn]
    lib = cuda_build.library(stem)
    entry = getattr(lib, fn)
    entry.argtypes = [*argtypes, _P]
    entry.restype = ctypes.c_int
    lib.dsk_error_string.argtypes = [ctypes.c_int]
    lib.dsk_error_string.restype = ctypes.c_char_p
    return entry, lib.dsk_error_string


def _runs_plain(
    terms: int, tile: int, *tensors: torch.Tensor, any_strides: tuple[torch.Tensor, ...] = ()
) -> bool:
    """Check what every kernel takes; return whether the tensors lie on the
    CPU (run the plain version) rather than on one CUDA device. The
    operands in ``any_strides`` are read through both their strides and
    need no contiguous rows."""
    if terms not in (2, 3):
        raise ValueError(f"terms must be 2 or 3; got {terms}")
    if tile < 1:
        raise ValueError(f"tile must be positive; got {tile}")
    operands = (*tensors, *any_strides)
    device = operands[0].device
    for x in operands:
        if x.device != device:
            raise ValueError("all operands must be on one device")
        if x.dtype != torch.float32:
            raise ValueError(f"the dense kernels take float32, not {x.dtype}")
    for x in tensors:
        if x.ndim >= 1 and x.stride(-1) != 1:
            raise ValueError("the dense kernels take operands with contiguous rows")
    if device.type == "cpu":
        return True
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    if torch.is_grad_enabled() and any(x.requires_grad for x in operands):
        raise NotImplementedError(
            "the dense kernels have no backward of their own; differentiate "
            "through ops.dense, whose autograd Functions run them without grad"
        )
    return False


def _on_device(x: torch.Tensor):
    """A guard that makes ``x``'s card current, entered only where another
    one is (a few microseconds a launch, which the small panels feel)."""
    index = x.get_device()
    if index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(index)


def _run(name: str, fn, *args) -> None:
    """Launch on the operands' device and current stream; raise on a
    refused argument or a failed launch."""
    global LAUNCHES_SPLIT, LAUNCHES_F64
    entry, error_string = _function(fn)
    # The current stream's handle without building a Stream object (a few
    # microseconds a launch, which the small panels feel).
    err = entry(*args, torch._C._cuda_getCurrentRawStream(torch.cuda.current_device()))
    if err:
        raise RuntimeError(
            f"dense kernel {name} failed: {error_string(err).decode()} (code {err})"
        )
    if name in LAUNCHES:
        LAUNCHES[name] += 1
    if fn in _SPLITS:
        LAUNCHES_SPLIT += 1
    if fn == "dsk_panel_matmul_f64":
        LAUNCHES_F64 += 1


def _padded(rows: int, k: int) -> tuple[int, int]:
    """The pieces' plane of ``(rows, k)``: rows padded to the kernel's tile,
    columns to its k-chunk."""
    return -(-rows // KERNEL_TILE) * KERNEL_TILE, -(-k // K_CHUNK) * K_CHUNK


_TINY = torch.finfo(torch.float32).tiny


def _sub_ftz(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a - b`` in float32 with subnormal inputs and result flushed to
    signed zero, as XLA and the TPU compute it (and ``sub.ftz`` on the
    card)."""

    def flush(v):
        return torch.where(v.abs() < _TINY, torch.zeros_like(v).copysign(v), v)

    return flush(flush(a) - flush(b))


def split_pieces(x: torch.Tensor, terms: int) -> tuple[torch.Tensor, ...]:
    """The bf16 pieces of float32 ``x``: ``(h, l)`` with ``x ~ h + l`` for
    2 terms (``_split2``), ``(h, m, l)`` with ``x ~ h + m + l`` for 3
    (``_split3``), rounded in their order and equal to them bit for bit
    (subnormal differences flush to zero, as in XLA). The split pass's
    plain version, on any device."""
    if terms not in (2, 3):
        raise ValueError(f"terms must be 2 or 3; got {terms}")
    if x.dtype != torch.float32:
        raise ValueError(f"the split takes float32, not {x.dtype}")
    h = x.to(torch.bfloat16)
    r = _sub_ftz(x, h.float())
    if terms == 2:
        return h, r.to(torch.bfloat16)
    m = r.to(torch.bfloat16)
    return h, m, _sub_ftz(r, m.float()).to(torch.bfloat16)


def split_pass(x: torch.Tensor) -> torch.Tensor:
    """The split pass of B5 and B6 alone, on ``x`` ``(rows, k)`` float32
    (any strides): its three bf16 pieces ``(h, m, l)``, ``(3, rows_pad,
    k_pad)`` with ``rows`` padded to :data:`KERNEL_TILE` and ``k`` to
    :data:`K_CHUNK`, zeros outside ``x``; ``(h, m)`` is the 2-term split.
    A CPU tensor gets :func:`split_pieces` padded the same way."""
    if x.ndim != 2:
        raise ValueError(f"x must be 2-d; got {tuple(x.shape)}")
    rows, k = x.shape
    out = torch.empty((3, *_padded(rows, k)), dtype=torch.bfloat16, device=x.device)
    if _runs_plain(3, 1, any_strides=(x,)):
        out.zero_()
        for p, piece in enumerate(split_pieces(x, 3)):
            out[p, :rows, :k] = piece
        return out
    with _on_device(x):
        _run("split", "dsk_split", x.data_ptr(), x.stride(0), x.stride(1), rows, k,
             out.data_ptr(), out.numel())
    return out


def plain_split_dots(
    x: torch.Tensor, y: torch.Tensor, terms: int, *, nt: bool = False
) -> torch.Tensor:
    """``_split_dots``: the sum of the piece products approximating
    ``x @ y`` (``x @ y.T`` with ``nt``), in float64. Each product of two
    bf16 pieces is exact, so at ``terms=3`` this is what B5 (NN) and B6
    (NT) compute up to the rounding of their accumulation."""
    px, py = split_pieces(x, terms), split_pieces(y, terms)

    def dot(a, b):
        b = b.double()
        return a.double() @ (b.mT if nt else b)

    if terms == 2:
        (hi, li), (hj, lj) = px, py
        return dot(hi, hj) + (dot(hi, lj) + dot(li, hj))
    (hi, mi, li), (hj, mj, lj) = px, py
    acc = dot(hi, hj)
    acc = acc + (dot(hi, mj) + dot(mi, hj))
    return acc + (dot(hi, lj) + (dot(li, hj) + dot(mi, mj)))


def plain_panel_matmul(
    A: torch.Tensor, W: torch.Tensor, r0: int, c0: int, rows: int
) -> torch.Tensor:
    """B5's plain version: ``A[r0:r0+rows, c0:c0+b] @ W``."""
    b = W.shape[0]
    return A[r0 : r0 + rows, c0 : c0 + b] @ W


# B5's 3-term body (csrc/dense_syrk.cu): output tile, contraction step,
# mma depth, largest split and the blocks a split aims for.
_F64_TILE = 128
_F64_K_STEP = 32
_F64_MMA_K = 8
_F64_MAX_SPLIT = 8
_F64_SPLIT_TARGET = 132


def panel_splits(rows: int, b: int) -> int:
    """How many blocks of one cluster B5's 3-term body splits the
    contraction of a ``(rows, b)`` panel over (``panel_splits`` in
    ``csrc/dense_syrk.cu``): the largest power of two up to 8 that keeps
    the blocks within 132 and each split at least two steps of 32."""
    blocks = -(-rows // _F64_TILE) * -(-b // _F64_TILE)
    steps = -(-b // _F64_K_STEP)
    s = 1
    while 2 * s <= _F64_MAX_SPLIT and blocks * 2 * s <= _F64_SPLIT_TARGET and steps >= 4 * s:
        s *= 2
    return s


def plain_panel_matmul_f64(
    A: torch.Tensor, W: torch.Tensor, r0: int, c0: int, rows: int
) -> torch.Tensor:
    """B5's 3-term product in the order of its kernel: the float32 panel
    ``A[r0:r0+rows, c0:c0+b]`` times ``W`` with float64 sums (each product
    of two float32 values is exact in float64), the contraction split as
    :func:`panel_splits` says, each split summed in steps of the mma depth
    (8) in order, the splits' partial sums added in order; rounded once to
    float32."""
    b = W.shape[0]
    panel = A[r0 : r0 + rows, c0 : c0 + b].double()
    W64 = W.double()
    s = panel_splits(rows, b)
    steps = -(-b // _F64_K_STEP)
    per = -(-steps // s) * _F64_K_STEP  # k values a split takes
    out = None
    for lo in range(0, s * per, per):
        part = panel.new_zeros(rows, b)
        for k in range(lo, min(lo + per, b), _F64_MMA_K):
            part += panel[:, k : k + _F64_MMA_K] @ W64[k : k + _F64_MMA_K]
        out = part if out is None else out + part
    return out.float()


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

    ``W`` is ``(b, b)``, any strides (the kernel reads it through both, so
    ``inv(L11).mT`` needs no copy). With ``at=None`` the whole of ``A``, ``(rows, b)``,
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
    if _runs_plain(terms, tile, A, any_strides=(W,)):
        return plain_panel_matmul(A, W, r0, c0, rows)
    out = A.new_empty(rows, b)
    # The panel's first element (A's rows are contiguous, float32). W goes
    # through its strides: inv(L11)^T as a transposed view costs no copy.
    lda = A.stride(0)
    args = (A.data_ptr() + 4 * (r0 * lda + c0), lda, W.data_ptr(), *W.stride(), out.data_ptr(),
            b, rows, b)
    with _on_device(A):
        if terms == 3:  # float64 sums on the float64 tensor cores (csrc/dense_syrk.cu)
            _run("panel", "dsk_panel_matmul_f64", *args)
            return out
        # The tensor cores, with scratch for the three pieces of the panel,
        # then those of W^T.
        rows_pad, b_pad = _padded(rows, b)
        elems = 3 * b_pad * (rows_pad + -(-b // KERNEL_TILE) * KERNEL_TILE)
        scratch = torch.empty(elems, dtype=torch.bfloat16, device=A.device)
        _run("panel", "dsk_panel_matmul", *args, scratch.data_ptr(), elems)
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
    # The tensor cores at either order, with scratch for L's three pieces;
    # the row side products come from the split pass.
    elems = 3 * math.prod(_padded(mt, b))
    scratch = torch.empty(elems, dtype=torch.bfloat16, device=T.device)
    trail = T[offset:, offset:]
    rowsq = rsu = None
    if ak is not None:
        ak, rowsq, rsu = ak.contiguous(), L.new_empty(mt), L.new_empty(mt)

    def ptr(x):
        return None if x is None else x.data_ptr()

    with _on_device(T):
        _run("syrk_inplace" if ak is None else "syrk_inplace_extras", "dsk_syrk_inplace_tc",
             trail.data_ptr(), T.stride(0), L.data_ptr(), L.stride(0), mt, b, ptr(ak),
             ptr(rowsq), ptr(rsu), scratch.data_ptr(), elems)
    return T if ak is None else (T, rowsq, rsu)


def plain_row_sums(L: torch.Tensor, ak: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """B4's row side products ``(sum(L**2, 1), L @ ak)`` in the split
    pass's order: lane ``i`` of a warp sums columns ``i, i + 32, ...`` in
    turn, each product rounded before its sum, then a butterfly over the
    32 lanes. Equal to the kernel's bit for bit in float32."""
    t, b = L.shape
    lanes = -(-b // 32) * 32
    Lp = torch.nn.functional.pad(L, (0, lanes - b)).view(t, -1, 32)
    akp = torch.nn.functional.pad(ak, (0, lanes - b)).view(-1, 32)
    sq, su = L.new_zeros(t, 32), L.new_zeros(t, 32)
    for c in range(Lp.shape[1]):
        x = Lp[:, c]
        sq = sq + x * x
        su = su + x * akp[c]
    lane = torch.arange(32, device=L.device)
    for o in (16, 8, 4, 2, 1):
        sq = sq + sq[:, lane ^ o]
        su = su + su[:, lane ^ o]
    return sq[:, 0], su[:, 0]


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
    elems = 3 * math.prod(_padded(m, b))
    scratch = torch.empty(elems, dtype=torch.bfloat16, device=T.device)
    with _on_device(T):
        _run("syrk", "dsk_syrk", T.data_ptr(), T.stride(0), L.data_ptr(), L.stride(0), m, b,
             out.data_ptr(), out.stride(0), int(lower_only), tile, scratch.data_ptr(), elems)
    return out


def lower_pair(g: int) -> tuple[int, int]:
    """The (i, j), j <= i, of lower tile pair ``g`` in row-major order, as
    B6's blocks decode it from ``blockIdx.x``."""
    r = int((math.sqrt(8.0 * g + 1.0) - 1.0) * 0.5)
    while r * (r + 1) // 2 > g:
        r -= 1
    while (r + 1) * (r + 2) // 2 <= g:
        r += 1
    return r, g - r * (r + 1) // 2


def plain_syrk_inplace_by_tiles(
    T: torch.Tensor,
    L: torch.Tensor,
    offset: int,
    ak: torch.Tensor | None = None,
    kernel_tile: int = KERNEL_TILE,
):
    """B4's schedule in plain PyTorch, in place: on the lower pairs (i, j)
    of ``kernel_tile`` tiles of the trailing submatrix ``T[offset:,
    offset:]`` only, ``T - L_i L_j^T``, the diagonal tiles whole, no
    mirror, the strictly upper tiles untouched; with ``ak`` also
    :func:`plain_row_sums`. Equal to :func:`plain_syrk_sub_inplace` on the
    lower triangle wherever the products are exact."""
    trail = T[offset:, offset:]
    t = trail.shape[0]
    nt = -(-t // kernel_tile)
    for g in range(nt * (nt + 1) // 2):
        i, j = lower_pair(g)
        ri = slice(i * kernel_tile, min((i + 1) * kernel_tile, t))
        rj = slice(j * kernel_tile, min((j + 1) * kernel_tile, t))
        trail[ri, rj] = trail[ri, rj] - L[ri] @ L[rj].T
    if ak is None:
        return T
    return T, *plain_row_sums(L, ak)


def plain_syrk_by_tiles(
    T: torch.Tensor,
    L: torch.Tensor,
    tile: int,
    lower_only: bool = False,
    kernel_tile: int = KERNEL_TILE,
) -> torch.Tensor:
    """B6's schedule in plain PyTorch: ``T - L L^T`` computed on the lower
    pairs of ``kernel_tile`` tiles only, each (i, j) written as
    ``T - acc`` and, for i != j, mirrored onto (j, i) as ``T - acc^T``;
    with ``lower_only`` zeros where ``col // tile > row // tile`` at the
    caller's ``tile``. Equal to :func:`plain_syrk_sub` wherever the
    products are exact."""
    m = T.shape[0]
    nt = -(-m // kernel_tile)
    out = torch.empty_like(T)
    blocks = torch.arange(m, device=T.device) // tile
    for g in range(nt * (nt + 1) // 2):
        i, j = lower_pair(g)
        ri = slice(i * kernel_tile, min((i + 1) * kernel_tile, m))
        rj = slice(j * kernel_tile, min((j + 1) * kernel_tile, m))
        acc = L[ri] @ L[rj].T
        out[ri, rj] = T[ri, rj] - acc
        if i != j:
            out[rj, ri] = T[rj, ri] - acc.T
    if lower_only:
        out = torch.where(blocks[None, :] > blocks[:, None], out.new_zeros(()), out)
    return out
