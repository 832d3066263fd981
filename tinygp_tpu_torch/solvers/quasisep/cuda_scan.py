"""The generic monoid scan of the quasiseparable algebra: kernel B3, its
wrappers and their plain versions.

Counterpart of ``tinygp_tpu/solvers/quasisep/pallas_scan.py``. Kernel B3
replaces ``pallas_scan._scan_kernel``, the TPU's exclusive monoid scan,
forward or reverse, with pruned outputs, at any order. It has two CUDA
sources: ``csrc/quasisep_scan.cu``, templated for m = 1..4 (the coupling
for two equal orders up to 4), and the generic-order sources, which take
the order at run time: ``csrc/quasisep_generic.cu`` for every other order
up to 16 and ``csrc/quasisep_wide.cu`` for the orders 17..32 (the
coupling's larger order). One
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
with ROADMAP item N10.

Each wrapper is an ``autograd.Function`` (``_Affine``, ``_Congruence``,
``_Riccati``, ``_Coupling``) on either device: the forward is the plain
scan, run without grad, or B3's launch; the backward is the hand-written
adjoint of ``scan.py`` (``_affine_bwd_s``, ``_congruence_bwd_s``,
``_riccati_bwd_s``, ``_coupling_bwd_s``), the same code on either device,
whose opposite-direction scan goes through these wrappers again: on the
card a reverse B3 launch, counted like any other. The backwards are built
from the ``Function`` s themselves, so they have second derivatives, and
they run their float32 products in full float32
(:func:`~tinygp_tpu_torch.helpers.full_float32`). Under
``torch.func.vmap`` each ``Function`` runs once for each element of the
batch (one launch each on the card).

Every scan up to order 32 is one kernel and one memset of its flags: tiles
taken by a ticket, a deterministic look-back. Up to m = 4 (the coupling's
two equal orders) the templated kernel; the coupling of any two orders up
to 8 a warp a team; the Riccati flow, the affine and the congruence scans
at m = 5..16 and the couplings whose larger order is 9..16 a warp a team on
the float64 tensor cores; every monoid at m = 17..32 (the coupling's
larger order) a block a team on them. :func:`b3_schedule` gives the tiles,
and :func:`plain_scan_tiled` repeats the association in plain PyTorch.

Every launch adds one to :data:`LAUNCHES` under its monoid's name, and a
launch of the generic-order source also to :data:`LAUNCHES_GENERIC`.
"""

from __future__ import annotations

__all__ = [
    "LAUNCHES",
    "LAUNCHES_GENERIC",
    "affine",
    "congruence",
    "riccati",
    "coupling",
    "b3_schedule",
    "plain_scan_tiled",
]

import ctypes
import functools

import torch

from tinygp_tpu_torch import cuda_build
from tinygp_tpu_torch.helpers import full_float32
from tinygp_tpu_torch.solvers.quasisep import cuda_loglik as _loglik
from tinygp_tpu_torch.solvers.quasisep import scan as _scan

LAUNCHES = {"aff": 0, "cong": 0, "ric": 0, "cpl": 0}
"""Calls that launched kernel B3, by monoid (one per call of its C entry,
which enqueues one kernel and a memset)."""
LAUNCHES_GENERIC = {"aff": 0, "cong": 0, "ric": 0, "cpl": 0}
"""Of those, the calls that went to the generic-order source."""

_KIND = {"aff": 0, "cong": 1, "ric": 2, "cpl": 3}
_MAX_M = 4  # the templated kernel's orders
_MAX_CPL_M = 8  # the coupling a warp a team (cpl_tile_kernel) takes
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
    lib.qss_schedule.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)] * 3
    lib.qss_schedule.restype = ctypes.c_int
    lib.qss_error_string.argtypes = [ctypes.c_int]
    lib.qss_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _generic_library() -> ctypes.CDLL:
    """The generic-order source's library, built at first use."""
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
    lib.qsg_cpl_schedule.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 2
    lib.qsg_cpl_schedule.restype = ctypes.c_int
    lib.qsg_scan_schedule.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)] * 3
    lib.qsg_scan_schedule.restype = ctypes.c_int
    lib.qsg_error_string.argtypes = [ctypes.c_int]
    lib.qsg_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _wide_library() -> ctypes.CDLL:
    """The generic-order source above order 16, built at first use."""
    lib = cuda_build.library("quasisep_wide")
    lib.qsw_workspace_elems.argtypes = [ctypes.c_int] * 3 + [ctypes.c_longlong, ctypes.c_int]
    lib.qsw_workspace_elems.restype = ctypes.c_longlong
    for suffix in _DTYPES.values():
        fn = getattr(lib, f"qsw_scan_{suffix}")
        fn.argtypes = (
            [ctypes.c_int] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 3
            + [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    lib.qsw_schedule.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)] * 3
    lib.qsw_schedule.restype = ctypes.c_int
    lib.qsw_error_string.argtypes = [ctypes.c_int]
    lib.qsw_error_string.restype = ctypes.c_char_p
    return lib


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(x.device.type == "cpu" for x in tensors)


def _launch(monoid, m, r, reverse, inclusive, operands, out_rows, m2=None):
    """Check the operands, run B3 for ``monoid`` on their device and current
    stream with a float64 workspace, and return the ``(out_rows, N)``
    output; raise on anything the kernel does not take. ``m2`` is the
    coupling's second order. Orders up to 4 (the coupling's equal) go to
    the templated kernel, the rest up to 16 to ``quasisep_generic.cu`` and
    above to ``quasisep_wide.cu``; each is one launch."""
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
    if not 1 <= r <= _MAX_COLUMNS:
        raise ValueError(f"B3 takes 1 to {_MAX_COLUMNS} columns; got {r}")
    if not 1 <= n < 2**40:
        raise ValueError(f"N must be in [1, 2**40); got {n}")
    generic = m != m2 or m > _MAX_M
    kind = _KIND[monoid]
    out = ref.new_empty(out_rows, n)
    ptrs = [x.data_ptr() for x in operands] + [None] * (4 - len(operands))
    with torch.cuda.device(ref.device):
        if max(m, m2) > _MONO_M[1]:
            lib, prefix = _wide_library(), "qsw"
            head = (kind, m, m2)
            work_elems = lib.qsw_workspace_elems(kind, m, m2, n, r)
        elif generic:
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


def _per_element(apply, info, in_dims, args) -> tuple[torch.Tensor, int]:
    """A ``vmap`` rule: ``apply`` once for each element of the batch (one
    B3 launch each on the card; a chain-axis B3 is ROADMAP item N9c), the
    outputs stacked on a leading axis. Through ``apply`` (the
    ``Function``'s own) an autograd level outside the ``vmap`` records
    each element."""
    args = [a if d is None else a.movedim(d, 0) for a, d in zip(args, in_dims)]
    outs = [
        apply(*(a if d is None else a[b].contiguous() for a, d in zip(args, in_dims)))
        for b in range(info.batch_size)
    ]
    return torch.stack(outs), 0


class _Affine(torch.autograd.Function):
    """The affine scan with its hand-written adjoint (JAX
    ``scan._make_affine_parallel_s``): forward the plain scan (run without
    grad) or B3; backward :func:`scan._affine_bwd_s`, whose reverse scan is
    this ``Function`` again (a B3 launch on the card), so it has a second
    derivative."""

    @staticmethod
    def forward(As, Bs, m, r, reverse, exclusive):
        if _on_cpu(As, Bs):
            return _scan._affine_scan_s(As, Bs, m, r, reverse=reverse, exclusive=exclusive)
        _check_rows("As", As, m * m)
        _check_rows("Bs", Bs, m * r)
        return _launch("aff", m, r, reverse, not exclusive, (As, Bs), m * r)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0], output)
        ctx.args = inputs[2:]

    @staticmethod
    def backward(ctx, ebar):
        As, es = ctx.saved_tensors
        m, r, reverse, exclusive = ctx.args
        with full_float32():
            grads = _scan._affine_bwd_s(
                As, es, ebar.contiguous(), m, r,
                reverse=reverse, exclusive=exclusive, scan=_affine_c,
            )
        return (*grads, None, None, None, None)

    @staticmethod
    def vmap(info, in_dims, *args):
        return _per_element(_Affine.apply, info, in_dims, args)


class _Congruence(torch.autograd.Function):
    """The congruence scan with its hand-written adjoint (JAX
    ``scan._make_congruence_parallel``), built as :class:`_Affine` is."""

    @staticmethod
    def forward(As, Bs, m, reverse):
        if _on_cpu(As, Bs):
            return _scan._congruence_scan_s(As, Bs, m, reverse=reverse)
        _check_rows("As", As, m * m)
        _check_rows("Bs", Bs, m * m)
        return _launch("cong", m, 1, reverse, False, (As, Bs), m * m)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0], output)
        ctx.args = inputs[2:]

    @staticmethod
    def backward(ctx, ebar):
        As, es = ctx.saved_tensors
        m, reverse = ctx.args
        with full_float32():
            grads = _scan._congruence_bwd_s(
                As, es, ebar.contiguous(), m, reverse=reverse, scan=_congruence_c
            )
        return (*grads, None, None)

    @staticmethod
    def vmap(info, in_dims, *args):
        return _per_element(_Congruence.apply, info, in_dims, args)


class _Riccati(torch.autograd.Function):
    """The Riccati flow with its hand-written adjoint (JAX
    ``scan._riccati_parallel``, ``riccati_scan_stacked``): backward
    :func:`scan._riccati_bwd_s`, one reverse congruence scan through
    :class:`_Congruence`."""

    @staticmethod
    def forward(d, ps, qs, as_):
        m = ps.shape[0]
        if _on_cpu(d, ps, qs, as_):
            return _scan._riccati_scan_s(d, ps, qs, as_, m)
        if d.ndim != 1:
            raise ValueError(f"d must be (N,); got {tuple(d.shape)}")
        _check_rows("qs", qs, m)
        _check_rows("as_", as_, m * m)
        return _launch("ric", m, 1, False, False, (d, ps, qs, as_), m * m)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs, output)

    @staticmethod
    def backward(ctx, Ybar):
        with full_float32():
            return _scan._riccati_bwd_s(
                ctx.saved_tensors, Ybar.contiguous(), scan=_congruence_c
            )

    @staticmethod
    def vmap(info, in_dims, *args):
        return _per_element(_Riccati.apply, info, in_dims, args)


class _Coupling(torch.autograd.Function):
    """The coupling scan with its hand-written adjoint, which the JAX
    package takes by autodiff of ``lax.scan`` (``ops._coupling_scan``):
    backward :func:`scan._coupling_bwd_s`, one opposite-direction coupling
    scan through this ``Function``."""

    @staticmethod
    def forward(As, Bs, Cs, m1, m2, reverse, exclusive):
        if _on_cpu(As, Bs, Cs):
            return _scan._coupling_scan_s(
                As, Bs, Cs, m1, m2, reverse=reverse, exclusive=exclusive
            )
        _check_rows("As", As, m1 * m1)
        _check_rows("Bs", Bs, m2 * m2)
        _check_rows("Cs", Cs, m1 * m2)
        return _launch("cpl", m1, 1, reverse, not exclusive, (As, Bs, Cs), m1 * m2, m2=m2)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0], inputs[1], output)
        ctx.args = inputs[3:]

    @staticmethod
    def backward(ctx, ebar):
        As, Bs, es = ctx.saved_tensors
        m1, m2, reverse, exclusive = ctx.args
        with full_float32():
            grads = _scan._coupling_bwd_s(
                As, Bs, es, ebar.contiguous(), m1, m2,
                reverse=reverse, exclusive=exclusive, scan=_coupling_c,
            )
        return (*grads, None, None, None, None)

    @staticmethod
    def vmap(info, in_dims, *args):
        return _per_element(_Coupling.apply, info, in_dims, args)


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
    return _Affine.apply(As, Bs, m, r, reverse, exclusive)


def congruence(
    As: torch.Tensor, Bs: torch.Tensor, m: int, *, reverse: bool
) -> torch.Tensor:
    """The exclusive prefix ``(m*m, N)`` of ``g_k = A_k g A_k^T + B_k``."""
    return _Congruence.apply(As, Bs, m, reverse)


def riccati(
    d: torch.Tensor, ps: torch.Tensor, qs: torch.Tensor, as_: torch.Tensor
) -> torch.Tensor:
    """The exclusive Riccati flow ``F`` ``(m*m, N)`` of ``d`` ``(N,)``,
    ``ps``/``qs`` ``(m, N)`` and ``as_`` ``(m*m, N)``."""
    return _Riccati.apply(d, ps, qs, as_)


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
    return _Coupling.apply(As, Bs, Cs, m1, m2, reverse, exclusive)


# The adjoints' scans: the wrappers on contiguous operands (the adjoint's
# transposed transitions are views above the row-loop orders).
def _affine_c(As, Bs, m, r, *, reverse, exclusive):
    return affine(As.contiguous(), Bs.contiguous(), m, r, reverse=reverse, exclusive=exclusive)


def _congruence_c(As, Bs, m, *, reverse):
    return congruence(As.contiguous(), Bs.contiguous(), m, reverse=reverse)


def _coupling_c(As, Bs, Cs, m1, m2, *, reverse, exclusive):
    return coupling(As.contiguous(), Bs.contiguous(), Cs.contiguous(), m1, m2,
                    reverse=reverse, exclusive=exclusive)


# ---------------------------------------------------------------------------
# The one-launch kernels' association, in plain PyTorch.
# ---------------------------------------------------------------------------

_AFF_COLS = 8  # affine columns a block of the templated kernel takes (r > 1)
_CPL_TEAMS = 4  # warp teams a tile of the one-launch coupling
_CPL_STAGE_BYTES = 32 * 1024
_CPL_RUN = 8  # look-back aggregates a warp of the coupling folds
# The generic source's one-launch Riccati flow, affine and congruence scans
# (m = 5..16) and couplings (larger order 9..16): 4 warp teams a tile, maps
# padded to 8 x 8 or 16 x 16 (the coupling's always 16), the affine columns
# in groups of 8 (r <= 8) or 16; a staged tile (each component's row its
# values and 16 bytes) of at most _MONO_STAGE_CAP bytes and what a block's
# 227 KB of shared memory leaves beside its maps. Above order 16 (m = 17..32,
# the coupling's larger order): a tile of _WIDE_TILE elements (the Riccati
# flow's twice that), one team.
_MONO_M = (5, 16)
_MONO_FOLD = (4, 16)  # look-back runs of 4 tiles, 4 warps a group of 16
_MONO_STAGE_CAP = 104 * 1024
_SMEM_BLOCK = 232448
_WIDE_TILE = 32


def _mono_fixed_bytes(monoid: str, pad: int, cols: int) -> int:
    """Shared memory of a one-launch Riccati, affine, congruence or coupling
    block beside its staged tile (``csrc/quasisep_generic.cu``:
    ``mono_fixed_bytes``): per team three maps, the merge's scratch and a
    state; three maps and three states for the tile."""
    if monoid == "ric":
        mp, st, scr = pad * (3 * pad + 4), pad * (pad + 4), pad * (2 * pad + 4)
    elif monoid == "cpl":
        mp, st, scr = pad * (3 * pad + 4), pad * (pad + 4), pad * (pad + 4)
    elif monoid == "cong":
        mp, st, scr = pad * (2 * pad + 4), pad * (pad + 4), pad * (pad + 4)
    else:
        mp, st, scr = pad * (pad + cols + 4), pad * (cols + 4), 0
    return 8 * (_CPL_TEAMS * (3 * mp + scr + st) + 3 * mp + 3 * st)


def _staged(monoid: str, m: int, cols: int) -> int:
    """Components the templated kernel stages an element."""
    return {"aff": m * m + m * cols, "cong": 2 * m * m, "ric": 1 + 2 * m + m * m,
            "cpl": 3 * m * m}[monoid]


def b3_schedule(
    monoid: str, m: int, r: int, dtype: torch.dtype, m2: int | None = None
) -> tuple[int, int, str | int | tuple[int, int]] | None:
    """``(tile, sub, fold)`` of B3's one-launch kernel for this scan on
    operands of ``dtype``: the elements of a tile and of a team's run, and
    how the look-back folds a group's aggregates: ``"warp"``, by a scan
    over a warp's lanes (the templated kernel, ``csrc/quasisep_scan.cu``: a
    thread a team, 64 a tile, the largest of 8, 4, 2 elements a thread
    whose staged tile fits 64 KB), or in runs of that many tiles (the
    coupling of ``csrc/quasisep_generic.cu``: a warp a team, 4 a tile, the
    largest of 32, 16, 8 whose tile fits 32 KB, a warp a run of 8, four
    runs a look-back group of 32 tiles), or as ``(runs, group)`` (its
    Riccati flow, affine and congruence scans at m = 5..16 and couplings
    whose larger order is 9..16: the same, the largest of 32 down to 1
    whose tile fits beside the block's maps, four warps folding runs of 4
    tiles, a group of 16; above order 16 a team of the whole tile, 32
    elements or the Riccati flow's 64, the same fold). None above order 32.
    The C entries ``qss_schedule``, ``qsg_cpl_schedule``,
    ``qsg_scan_schedule`` and ``qsw_schedule`` report the tiles."""
    m2 = m if m2 is None else m2
    nbytes = torch.empty((), dtype=dtype).element_size()
    if m == m2 and m <= _MAX_M:
        comps = _staged(monoid, m, _AFF_COLS if monoid == "aff" and r > 1 else 1) * nbytes
        sub = 8 if comps <= 128 else 4 if comps <= 256 else 2
        return 64 * sub, sub, "warp"
    if monoid == "cpl" and max(m, m2) <= _MAX_CPL_M:
        comps = m * m + m2 * m2 + m * m2
        sub = 32
        while sub > 8 and comps * (_CPL_TEAMS * sub + 1) * nbytes > _CPL_STAGE_BYTES:
            sub //= 2
        return _CPL_TEAMS * sub, sub, _CPL_RUN
    big = max(m, m2)
    if _MONO_M[0] <= big <= _MONO_M[1]:
        pad = 16 if monoid == "cpl" or m > 8 else 8
        cols = 8 if r <= 8 else 16
        comps = {"ric": 1 + 2 * m + m * m, "cong": 2 * m * m,
                 "aff": m * m + m * min(r, cols), "cpl": m * m + m2 * m2 + m * m2}[monoid]
        room = min(_MONO_STAGE_CAP, _SMEM_BLOCK - _mono_fixed_bytes(monoid, pad, cols) - 1024)
        sub = 32
        while sub > 1 and comps * (_CPL_TEAMS * sub * nbytes + 16) > room:
            sub //= 2
        return _CPL_TEAMS * sub, sub, _MONO_FOLD
    if _MONO_M[1] < big <= _MAX_GENERIC_M:
        tile = 2 * _WIDE_TILE if monoid == "ric" else _WIDE_TILE
        return tile, tile, _MONO_FOLD
    return None


def _monoid(monoid: str, m: int, m2: int, r: int, f64: dict):
    """``(combine, apply, identity)`` of a monoid on batched matrices:
    ``combine(earlier, later)`` composes two maps (lists of tensors),
    ``apply(*map, state)`` is the state after a map."""
    eye, zeros = torch.eye(m, **f64), torch.zeros(m, m, **f64)
    if monoid == "aff":
        def combine(e_, l_):
            (eA, eB), (lA, lB) = e_, l_
            return [lA @ eA, lA @ eB + lB]

        def apply(A, B, s):
            return A @ s + B

        return combine, apply, [eye, torch.zeros(m, r, **f64)]
    if monoid == "cong":
        def combine(e_, l_):
            (eA, eB), (lA, lB) = e_, l_
            return [lA @ eA, lA @ eB @ lA.mT + lB]

        def apply(A, B, s):
            return A @ s @ A.mT + B

        return combine, apply, [eye, zeros]
    if monoid == "cpl":
        def combine(e_, l_):
            (eA, eB, eC), (lA, lB, lC) = e_, l_
            return [lA @ eA, lB @ eB, lA @ eC @ lB.mT + lC]

        def apply(A, B, C, g):
            return A @ g @ B.mT + C

        return combine, apply, [eye, torch.eye(m2, **f64), torch.zeros(m, m2, **f64)]
    return _loglik._ric_combine, _loglik._ric_apply, [eye, zeros, zeros]


def plain_scan_tiled(
    monoid: str,
    operands,
    m: int,
    *,
    r: int = 1,
    m2: int | None = None,
    reverse: bool = False,
    exclusive: bool = True,
    schedule: tuple[int, int, str | int | tuple[int, int]],
) -> torch.Tensor:
    """B3's scan in the association of its one-launch kernels, in float64
    (the kernels' congruence look-back sums its merges of runs compensated,
    in about twice that precision), stored in the operands' dtype: the same operands and output as the
    wrapper of ``monoid`` (:func:`affine` with ``r`` columns,
    :func:`congruence`, :func:`riccati`, :func:`coupling` with orders
    ``(m, m2)``), ``schedule`` from :func:`b3_schedule`.

    A reverse scan mirrors the data axis. The positions are cut into tiles
    of ``tile``, each into teams of ``sub`` consecutive positions. Each team
    folds its elements into one map (the Riccati flow with the rank-one
    step, :func:`scan.riccati_fold_rank_one`; the others with their
    combine); the teams of a tile are scanned (``cuda_loglik._team_scan``),
    and the tiles' aggregates reach the state from 0 in the look-back
    association (``cuda_loglik._group_chain``, its group fold over a warp's
    lanes, or in runs of tiles, as ``schedule`` says). Each team applies its prefix to its tile's
    start and walks its elements with the sequential step, keeping the
    state before (``exclusive``) or after each. The ragged end is padded
    with identity elements, which the kernels mask and which change
    nothing.
    """
    tile, sub, fold = schedule
    m2 = m if m2 is None else m2
    ref = operands[0]
    dtype, n = ref.dtype, ref.shape[-1]
    teams, nt = tile // sub, -(-n // tile)
    pad = nt * tile - n
    f64 = {"dtype": torch.float64, "device": ref.device}
    combine, apply, identity = _monoid(monoid, m, m2, r, f64)

    def tiled(x, shape, fill):  # (rows, n) -> (nt, teams, sub, *shape)
        x = x.to(**f64).reshape(-1, n)
        x = (x.flip(-1) if reverse else x).T.reshape(n, *shape)
        fill = torch.as_tensor(fill, **f64).expand(pad, *shape)
        return torch.cat([x, fill]).reshape(nt, teams, sub, *shape)

    if monoid == "ric":
        ps, qs, as_ = operands[1:]
        d = tiled(operands[0], (), 1.0)
        p, q = tiled(ps, (m,), 0.0), tiled(qs, (m,), 0.0)
        a = tiled(as_, (m, m), torch.eye(m, **f64))
        state_shape = (m, m)
    else:
        # Each component padded with the identity's.
        elems = [tiled(x, i.shape, i) for x, i in zip(operands, identity)]
        state_shape = identity[-1].shape

    def outer(u, v):
        return u[..., :, None] * v[..., None, :]

    def mv(A, v):
        return (A @ v[..., None])[..., 0]

    # The teams' folds.
    if monoid == "ric":
        A = torch.eye(m, **f64).expand(nt, teams, m, m).clone()
        F = torch.zeros(nt, teams, m, m, **f64)
        G = torch.zeros(nt, teams, m, m, **f64)
        for jj in range(sub):
            pj, aj = p[:, :, jj], a[:, :, jj]
            f = mv(F, pj)
            c = (d[:, :, jj] - torch.sum(pj * f, dim=-1))[..., None, None]
            u = q[:, :, jj] - mv(aj, f)
            w = mv(A.mT, pj)
            A = aj @ A - outer(u, w) / c
            F = aj @ F @ aj.mT + outer(u, u) / c
            G = G - outer(w, w) / c
        folded = [A, F, G]

        def step(F, jj):
            pj, aj = p[:, :, jj], a[:, :, jj]
            Fp = mv(F, pj)
            c2 = d[:, :, jj] - torch.sum(pj * Fp, dim=-1)
            u = q[:, :, jj] - mv(aj, Fp)
            return aj @ F @ aj.mT + outer(u, u) / c2[..., None, None]
    else:
        folded = [i.expand(nt, teams, *i.shape).clone() for i in identity]
        for jj in range(sub):
            folded = combine(folded, [x[:, :, jj] for x in elems])

        def step(s, jj):
            return apply(*[x[:, :, jj] for x in elems], s)

    # The in-tile scan, the look-back and each team's start.
    incl = _loglik._team_scan(folded, combine)
    pre = _loglik._exclusive(incl, identity)
    state0 = torch.zeros(state_shape, **f64)
    if fold == "warp":
        runs, group = None, _loglik._LOOK_GROUP
    else:
        runs, group = (fold, _CPL_TEAMS * fold) if isinstance(fold, int) else fold
    start = _loglik._group_chain([t[:, -1] for t in incl], combine, apply, state0,
                                 warp_fold=fold == "warp", runs=runs, group=group)
    s = apply(*pre, start[:, None])

    # The walk.
    out = torch.empty(nt, teams, sub, *state_shape, **f64)
    for jj in range(sub):
        after = step(s, jj)
        out[:, :, jj] = s if exclusive else after
        s = after
    out = out.reshape(nt * tile, -1)[:n]
    out = (out.flip(0) if reverse else out).T
    return out.contiguous().to(dtype)
