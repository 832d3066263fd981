"""Sequence-parallel quasiseparable scans across the ranks of a mesh axis.

Counterpart of ``tinygp_tpu/parallel/scan.py``, in three phases:

1. every rank runs the plain blocked scan
   (:func:`~tinygp_tpu_torch.solvers.quasisep.scan.monoid_scan`) on its
   contiguous shard and forms its shard's total;
2. the totals are all-gathered over the axis (one m x m map per rank) and
   every rank computes their exclusive prefix and takes its own entry;
3. one vectorized combine folds that prefix into the local states.

The JAX package runs these as plain XLA scans, outside any Pallas kernel
(its Pallas scan needs ``combine_lists``, which ``parallel/scan.py`` does
not pass), so here they are plain PyTorch on the card too. Gradients flow
through the collectives' adjoints (:mod:`~tinygp_tpu_torch.parallel.mesh`).

Where the JAX functions take a mesh axis name inside ``shard_map``, the
scans here take ``axis_name``, the process group of that axis
(``parallel.mesh.axis_group(mesh, axis)``), and run on each rank's local
shard. :func:`sharded_loglik` and :func:`sharded_loglik_chains` take the
global ``X`` and ``y`` on every rank, as the JAX functions take global
arrays, and each rank works on its block.
"""

from __future__ import annotations

__all__ = [
    "sharded_monoid_scan",
    "sharded_affine_scan",
    "sharded_riccati_scan",
    "sharded_loglik",
    "sharded_loglik_chains",
]

import math
from typing import Any

import torch
from torch.distributed.device_mesh import DeviceMesh

from tinygp_tpu_torch.helpers import mapped_module, pinned
from tinygp_tpu_torch.parallel.mesh import (
    axis_group,
    axis_size,
    gather,
    group_rank,
    group_size,
    group_sum,
    replicate,
    replicate_module,
)
from tinygp_tpu_torch.solvers.quasisep import scan as chip_scan


def _select_prefix(combine, identity, totals, my_idx: int):
    """The exclusive prefix of the gathered totals (the rank axis last) at
    this rank: a sequential scan of a few entries, the same on every rank."""
    prefixes = chip_scan.monoid_scan(combine, identity, totals)
    return tuple(x[..., my_idx : my_idx + 1] for x in prefixes)


def sharded_monoid_scan(combine, identity, elems, *, axis_name):
    """Exclusive scan along the last axis, sharded over the ranks of the
    group ``axis_name``: ``elems`` are this rank's shard (lane axis last),
    and the result is its slice of the global exclusive scan."""
    local_excl = chip_scan.monoid_scan(combine, identity, elems)
    # The shard's total: the exclusive prefix at its last lane composed with
    # its last element.
    last = tuple(x[..., -1:] for x in elems)
    excl_last = tuple(x[..., -1:] for x in local_excl)
    total = combine(excl_last, last)
    totals = tuple(gather(t, axis_name, dim=-1) for t in total)
    prefix = _select_prefix(combine, identity, totals, group_rank(axis_name))
    return combine(prefix, local_excl)


def _sharded_affine_stacked(As, Bs, m: int, r: int, *, axis_name):
    """Sharded forward-exclusive affine scan on stacked local operands."""

    def combine(earlier, later):
        A_e, B_e = earlier
        A_l, B_l = later
        return chip_scan._smm(A_l, A_e, m, m, m), chip_scan._smm(A_l, B_e, m, m, r) + B_l

    identity = (chip_scan._seye(m, As), Bs.new_zeros((m * r, 1)))
    _, e = sharded_monoid_scan(combine, identity, (As, Bs), axis_name=axis_name)
    return e


def sharded_affine_scan(A: torch.Tensor, B: torch.Tensor, *, axis_name) -> torch.Tensor:
    """Sharded forward-exclusive affine scan: ``A`` local ``(n, m, m)``
    transitions, ``B`` local ``(n, m, r)`` loads; returns this rank's slice
    of the global exclusive prefix states."""
    m, r = B.shape[-2], B.shape[-1]
    e = _sharded_affine_stacked(
        chip_scan._pack3(A), chip_scan._pack3(B), m, r, axis_name=axis_name
    )
    return chip_scan._unpack3(e, m, r)


def _sharded_riccati_stacked(d, ps, qs, as_, m: int, *, axis_name):
    """Sharded exclusive Riccati flow on stacked local operands: the
    on-chip strategy's matrix-fraction monoid, its maps merged across
    ranks."""
    zeros = ps.new_zeros((m * m, 1))
    identity = (chip_scan._seye(m, ps), zeros, zeros)
    _, F, _ = sharded_monoid_scan(
        chip_scan._riccati_combine(m),
        identity,
        chip_scan._riccati_elements(d, ps, qs, as_),
        axis_name=axis_name,
    )
    return F


def sharded_riccati_scan(d, p, q, a, *, axis_name) -> torch.Tensor:
    """Sharded exclusive Riccati flow ``(n, m, m)`` of local ``d`` ``(n,)``,
    ``p``/``q`` ``(n, m)`` and ``a`` ``(n, m, m)``."""
    m = p.shape[1]
    F = _sharded_riccati_stacked(
        d, p.T, q.T, chip_scan._pack3(a), m, axis_name=axis_name
    )
    return chip_scan._unpack3(F, m, m)


def _stacked_loglik_pieces(d, ps, qs, as_, y, *, axis_name) -> torch.Tensor:
    """The log-likelihood from this rank's stacked operands: the sharded
    Riccati flow feeds the Cholesky emissions, those the sharded affine
    solve, and the two scalar terms sum over the group into a value every
    rank returns."""
    m = ps.shape[0]
    Fs = _sharded_riccati_stacked(d, ps, qs, as_, m, axis_name=axis_name)

    Fp = chip_scan._smv(Fs, ps, m, m)
    c = torch.sqrt(d - torch.sum(ps * Fp, dim=0))
    inv_c = 1.0 / c
    w = (qs - chip_scan._smv(as_, Fp, m, m)) * inv_c

    # Solve L alpha = y, L = diag(c) + strict_lower(p, w, a), the diagonal
    # folded into the transition.
    wd = w * inv_c
    A = as_ - chip_scan._souter(wd, ps)
    e = _sharded_affine_stacked(A, wd * y, m, 1, axis_name=axis_name)
    alpha = (y - torch.sum(ps * e, dim=0)) * inv_c

    terms = group_sum(
        torch.stack([torch.sum(alpha**2), torch.sum(torch.log(c))]), axis_name, replicated=True
    )
    n = y.shape[0] * group_size(axis_name)
    return -0.5 * terms[0] - terms[1] - 0.5 * n * math.log(2 * math.pi)


def _block_and_previous(X: torch.Tensor, rank: int, size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """This rank's block of the global coordinates ``X`` and the previous
    point of each: the left neighbour's last point for the first, which
    on rank 0 pairs with itself (the single-device convention)."""
    n_loc = X.shape[0] // size
    lo = rank * n_loc
    X_loc = X[lo : lo + n_loc]
    first = X[lo - 1 : lo] if rank else X[:1]
    return X_loc, torch.cat([first, X_loc[:-1]])


def _one_chain_local(kernel, X_loc, X_prev, y_loc, diag_loc, *, axis_name):
    """One kernel's log-likelihood from this rank's shard. The port's
    ``Sum`` builds dense stacked transitions, so every quasiseparable
    kernel takes the stacked route (the JAX package's ``Block`` fallback
    has no counterpart)."""
    d, ps, qs, as_ = kernel.to_stacked_ssm(X_loc, X_prev=X_prev)
    return _stacked_loglik_pieces(d + diag_loc, ps, qs, as_, y_loc, axis_name=axis_name)


@pinned
def sharded_loglik(
    kernel,
    X: torch.Tensor,
    y: torch.Tensor,
    *,
    diag: Any,
    mesh: DeviceMesh,
    axis: str = "data",
) -> torch.Tensor:
    """GP marginal log-likelihood with the time axis sharded over ``mesh``.

    Every rank of the axis passes the same global, sorted ``X`` and ``y``
    and a :class:`~tinygp_tpu_torch.kernels.quasisep.Quasisep` kernel; each
    builds the generators of its block of ``X`` (its first transition from
    the left neighbour's last point) and runs the factorization and solve
    as sharded scans. Returns the log-likelihood, whole on every rank, as
    ``GaussianProcess(kernel, X, diag=diag).log_probability(y)`` gives it
    on one device (same math, another association of the scans). Its
    gradient reaches the kernel, ``X``, ``y`` and ``diag`` whole on every
    rank.
    """
    group = axis_group(mesh, axis)
    size, rank = axis_size(mesh, axis), group_rank(group)
    n = X.shape[0]
    if n % size:
        raise ValueError(
            f"data length {n} must divide evenly over mesh axis {axis!r} ({size} devices)"
        )
    kernel = replicate_module(kernel, group)
    X, y = replicate(X, group), replicate(y, group)
    diag = replicate(torch.broadcast_to(torch.as_tensor(diag, dtype=y.dtype, device=y.device),
                                        y.shape), group)
    X_loc, X_prev = _block_and_previous(X, rank, size)
    n_loc = n // size
    lo = rank * n_loc
    return _one_chain_local(kernel, X_loc, X_prev, y[lo : lo + n_loc], diag[lo : lo + n_loc],
                            axis_name=group)


@pinned
def sharded_loglik_chains(
    kernel,
    X: torch.Tensor,
    y: torch.Tensor,
    *,
    diag: Any,
    mesh: DeviceMesh,
    data_axis: str = "data",
    chain_axis: str = "chains",
) -> torch.Tensor:
    """Chain-parallel x sequence-parallel log-likelihoods on a 2-D mesh.

    ``kernel`` is a quasiseparable kernel each of whose tensors carries a
    leading chain axis, or is a scalar that the chains share
    (``Matern32(scale=torch.tensor([1.3, 2.1]))``);
    ``X`` ``(N,)`` is shared by the chains and ``y`` is ``(C, N)``, both
    global on every rank. Chains shard over ``chain_axis`` and each chain's
    time axis over ``data_axis``; each rank returns its chain block's
    ``(C / chain devices,)`` log-likelihoods, whole on the ranks of its
    data axis. The gradient on every rank is that of the sum over all
    chains.
    """
    if y.ndim != 2:
        raise ValueError(f"y must be (num_chains, N); got shape {tuple(y.shape)}")
    num_chains, n = y.shape
    data_devices, chain_devices = axis_size(mesh, data_axis), axis_size(mesh, chain_axis)
    if n % data_devices or X.shape[0] != n:
        raise ValueError(
            f"data length {n} must match X and divide evenly over mesh axis {data_axis!r} "
            f"({data_devices} devices)"
        )
    if num_chains % chain_devices:
        raise ValueError(
            f"{num_chains} chains must divide evenly over mesh axis {chain_axis!r} "
            f"({chain_devices} devices)"
        )
    data, chains = axis_group(mesh, data_axis), axis_group(mesh, chain_axis)
    kernel = replicate_module(kernel, data, chains)
    X = replicate(replicate(X, data), chains)
    diag = torch.broadcast_to(torch.as_tensor(diag, dtype=y.dtype, device=y.device), y.shape)
    y, diag = (replicate(replicate(t, data), chains) for t in (y, diag))

    rank = group_rank(data)
    X_loc, X_prev = _block_and_previous(X, rank, data_devices)
    n_loc = n // data_devices
    cols = slice(rank * n_loc, (rank + 1) * n_loc)
    c_loc = num_chains // chain_devices
    first = group_rank(chains) * c_loc
    out = []
    for c in range(first, first + c_loc):
        one = mapped_module(kernel, lambda t, c=c: t[c] if t.ndim else t)
        out.append(_one_chain_local(one, X_loc, X_prev, y[c, cols], diag[c, cols],
                                    axis_name=data))
    return torch.stack(out)
