"""Rectangular quasiseparable matrices.

Counterpart of ``tinygp_tpu/solvers/quasisep/general.py``: the
cross-covariance ``K(X1, X2)`` between two coordinate sets, which gives
predictive means in O(N + M). Each row carries the index ``idx`` of the
last column at or before it, which splits the row into a past (lower) and
a future (upper) part.
"""

from __future__ import annotations

__all__ = ["GeneralQSM"]

import dataclasses

import torch

from tinygp_tpu_torch.solvers.quasisep.scan import affine_scan


@dataclasses.dataclass(frozen=True, eq=False)
class GeneralQSM:
    """An ``(n1, n2)`` rectangular quasiseparable matrix of order m.

    Args:
        pl: Row generators of the past part, ``(n1, m)``, already carried
            from the row's anchor column to the row.
        ql: Column generators of the past part, ``(n2, m)``.
        pu: Column generators of the future part, ``(n2, m)``.
        qu: Row generators of the future part, ``(n1, m)``, already carried
            from the row to the next column.
        a: Transitions along the columns, ``(n2, m, m)``.
        idx: Per row, the index of the last column at or before it (-1 for
            a row before every column), ``(n1,)``.
    """

    pl: torch.Tensor
    ql: torch.Tensor
    pu: torch.Tensor
    qu: torch.Tensor
    a: torch.Tensor
    idx: torch.Tensor

    @property
    def shape(self) -> tuple[int, int]:
        return (self.pl.shape[0], self.ql.shape[0])

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        """``self @ x`` by one forward and one reverse inclusive affine scan
        over the columns (kernel B3 on the card)."""
        n2 = self.ql.shape[0]
        out_shape = (-1,) + tuple(x.shape[1:])
        x = x.reshape(x.shape[0], -1)

        # Past: the inclusive prefix f_k = a_k f_{k-1} + ql_k x_k; row i
        # reads f at its anchor column idx_i.
        f = affine_scan(self.a, self.ql[:, :, None] * x[:, None, :], exclusive=False)
        anchor = torch.clamp(self.idx, 0, n2 - 1)
        valid = (self.idx >= 0) & (self.idx < n2)
        lower = torch.einsum(
            "nj,njk->nk", torch.where(valid[:, None], self.pl, 0.0), f[anchor]
        )

        # Future: the inclusive suffix g_k = a_{k+1}^T g_{k+1} + pu_k x_k;
        # row i reads g at idx_i + 1. The transitions lag by one step, so
        # they are rolled (the rolled-in last one reaches no output).
        a_next = torch.roll(self.a, -1, dims=0)
        g = affine_scan(
            a_next.mT, self.pu[:, :, None] * x[:, None, :], reverse=True, exclusive=False
        )
        anchor = torch.clamp(self.idx + 1, 0, n2 - 1)
        valid = (self.idx >= -1) & (self.idx + 1 < n2)
        upper = torch.einsum(
            "nj,njk->nk", torch.where(valid[:, None], self.qu, 0.0), g[anchor]
        )
        return (lower + upper).reshape(out_shape)

    def __matmul__(self, other: torch.Tensor) -> torch.Tensor:
        return self.matmul(other)
