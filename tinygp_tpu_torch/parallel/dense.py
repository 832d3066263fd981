"""Tensor-parallel dense Cholesky over the ranks of a mesh axis.

Counterpart of ``tinygp_tpu/parallel/dense.py``: the right-looking
distributed algorithm (ScaLAPACK's, without block-cyclic wrapping). Rank
``d`` owns the contiguous column slab ``[d n_loc, (d+1) n_loc)`` of all
``n`` rows. For each panel of ``block`` columns, its owner factors the
diagonal block and solves the rows below it, the panel is broadcast from
the owner, and every rank applies the rank-``block`` trailing update to
its own slab with one matrix product.

The JAX package computes these products outside any Pallas kernel, so
they are ``torch.matmul`` here, with float32 products pinned to full
float32 (the JAX package's ``precision="highest"``).
"""

from __future__ import annotations

__all__ = ["cholesky_tp"]

import torch
from torch.distributed.device_mesh import DeviceMesh

from tinygp_tpu_torch.helpers import pinned
from tinygp_tpu_torch.parallel.mesh import (
    axis_group,
    axis_size,
    broadcast,
    group_rank,
    replicate,
    tie,
)


@pinned
def cholesky_tp(
    K: torch.Tensor,
    *,
    mesh: DeviceMesh,
    axis: str = "tp",
    block: int = 256,
) -> torch.Tensor:
    """Lower Cholesky factor of an SPD matrix, sharded over ``mesh[axis]``.

    Every rank of the axis passes the same ``(n, n)`` matrix ``K``, with
    ``n`` divisible by ``num_devices * block``; each returns its column
    block ``L[:, d n_loc:(d+1) n_loc]`` of the lower factor (the JAX
    package's column-sharded ``L``). Gradients reach ``K`` whole on every
    rank, for the sum of what the ranks' blocks feed.
    """
    group = axis_group(mesh, axis)
    d, me = axis_size(mesh, axis), group_rank(group)
    n = K.shape[0]
    if n % (d * block) != 0:
        raise ValueError(f"n={n} must divide evenly into {d} devices x {block} panel")
    n_loc = n // d
    per_rank = n_loc // block
    eye = torch.eye(block, dtype=K.dtype, device=K.device)
    cols = me * n_loc + torch.arange(n_loc, device=K.device)
    # The running (trailing-updated) slab: all rows of this rank's columns.
    T = replicate(K, group)[:, me * n_loc : (me + 1) * n_loc]
    factor, others = [], []
    for j in range(n // block):
        owner, lo = j // per_rank, j * block
        if me == owner:
            # The owner factors its panel: the diagonal block's Cholesky,
            # then the rows below it against inv(L11)^T.
            panel = T[:, (j % per_rank) * block : (j % per_rank + 1) * block]
            L11 = torch.linalg.cholesky(panel[lo : lo + block])
            L11_inv_t = torch.linalg.solve_triangular(L11, eye, upper=False).mT
            mine = torch.cat(
                [panel.new_zeros(lo, block), L11, panel[lo + block :] @ L11_inv_t]
            )
        else:
            # Only the owner's panel is broadcast. The JAX package factors
            # the identity here so that no NaN reaches its transpose; a
            # non-owner's input is zeros, which hang off K only so that
            # every rank's backward pass toward K runs the broadcast's
            # adjoint, a collective (their own cotangent is zero).
            mine = K[:, :block] * 0.0
        panel = broadcast(mine, owner, group)
        (factor if me == owner else others).append(panel)
        # The trailing update of this rank's columns right of the panel:
        # T[r, c] -= panel[r] . panel[c] for c >= lo + block.
        update = panel @ panel[me * n_loc : (me + 1) * n_loc].mT
        T = T - update * (cols >= lo + block).to(K.dtype)
    # The panels this rank's block does not hold are tied in, so that its
    # backward pass runs every broadcast's adjoint.
    return tie(torch.tril(torch.cat(factor, dim=1), diagonal=-me * n_loc), *others)
