"""Observation-noise models.

Counterpart of ``tinygp_tpu/noise.py``: the ``Noise`` protocol, the
``Diagonal`` model and the ``Banded`` model, each with its diagonal, its
product ``noise @ x`` and its quasiseparable form ``to_qsm``, which is
what the O(N) solver adds to the kernel's matrix. ``Banded`` is an order-J
quasiseparable matrix whose transition is a shift register. The dense
algebra (``noise + matrix``) and the ``Dense`` model belong to the dense
solver, ROADMAP item N3.
"""

from __future__ import annotations

__all__ = ["Noise", "Diagonal", "Banded"]

from typing import Any

import torch
from torch import nn

_DENSE = "adding noise to a dense matrix is ROADMAP item N3 (the dense slice)"


class Noise(nn.Module):
    """The noise-model protocol."""

    def diagonal(self) -> torch.Tensor:
        """The diagonal of the noise matrix."""
        raise NotImplementedError("concrete noise models define diagonal()")

    def __add__(self, other: Any) -> Any:
        raise NotImplementedError(_DENSE)

    def __radd__(self, other: Any) -> Any:
        return self.__add__(other)

    def __matmul__(self, other: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError("concrete noise models define @")

    def to_qsm(self) -> Any:
        """This noise model as a quasiseparable matrix."""
        raise NotImplementedError("this noise model has no quasiseparable form")


class Diagonal(Noise):
    """Per-observation measurement variance.

    Args:
        diag: The ``(N,)`` diagonal entries (broadcast scalars first).
    """

    def __init__(self, diag: torch.Tensor):
        super().__init__()
        if diag.ndim != 1:
            raise ValueError(
                "Diagonal noise stores one variance per observation: pass "
                "an (N,) tensor (broadcast scalars before constructing)"
            )
        self.register_buffer("diag", diag)

    def diagonal(self) -> torch.Tensor:
        return self.diag

    def __matmul__(self, other: torch.Tensor) -> torch.Tensor:
        return self.diag * other if other.ndim == 1 else self.diag[:, None] * other

    def to_qsm(self) -> Any:
        from tinygp_tpu_torch.solvers.quasisep.core import DiagQSM

        return DiagQSM(d=self.diag)


class Banded(Noise):
    """A symmetric banded observation-noise matrix.

    Args:
        diag: The ``(N,)`` diagonal.
        off_diags: ``(N, J)``; row i holds ``M[i, i+1+j]`` for ``j < J``
            (entries past the matrix's edge are ignored).

    As a quasiseparable matrix it has order J with the shift register
    ``a = eye(J, k=1)``: the generator ``q_i = off_diags[i]`` carries row
    i's band, and each step shifts it one diagonal outward.
    """

    def __init__(self, diag: torch.Tensor, off_diags: torch.Tensor):
        super().__init__()
        if diag.ndim != 1 or off_diags.ndim != 2 or off_diags.shape[0] != diag.shape[0]:
            raise ValueError("Banded noise takes diag (N,) and off_diags (N, J)")
        self.register_buffer("diag", diag)
        self.register_buffer("off_diags", off_diags)

    def diagonal(self) -> torch.Tensor:
        return self.diag

    def __matmul__(self, other: torch.Tensor) -> torch.Tensor:
        return self.to_qsm().matmul(other)

    def to_qsm(self) -> Any:
        from tinygp_tpu_torch.solvers.quasisep.core import (
            DiagQSM,
            StrictLowerTriQSM,
            SymmQSM,
        )

        n, J = self.off_diags.shape
        like = dict(dtype=self.diag.dtype, device=self.diag.device)
        # p selects the register's first slot; a shifts the register.
        p = torch.zeros(n, J, **like)
        p[:, 0] = 1.0
        a = torch.diag(torch.ones(J - 1, **like), 1).expand(n, J, J)
        return SymmQSM(
            diag=DiagQSM(d=self.diag),
            lower=StrictLowerTriQSM(p=p, q=self.off_diags, a=a),
        )
