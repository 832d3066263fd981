"""Observation-noise models.

Counterpart of ``tinygp_tpu/noise.py``: the ``Noise`` protocol and the
``Diagonal``, ``Dense`` and ``Banded`` models, each with its diagonal, its
sum with a dense matrix (``noise + K``, what the dense solver factors), its
product ``noise @ x`` and, where it has one, its quasiseparable form
``to_qsm``, which is what the O(N) solver adds to the kernel's matrix.
``Banded`` is an order-J quasiseparable matrix whose transition is a
shift register.
"""

from __future__ import annotations

__all__ = ["Noise", "Diagonal", "Dense", "Banded"]

from typing import Any

import torch
from torch import nn


class Noise(nn.Module):
    """The noise-model protocol."""

    def diagonal(self) -> torch.Tensor:
        """The diagonal of the noise matrix."""
        raise NotImplementedError("concrete noise models define diagonal()")

    def __add__(self, other: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError("concrete noise models define +")

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

    def __add__(self, other: torch.Tensor) -> torch.Tensor:
        # A masked add, one elementwise pass over the matrix.
        n, m = other.shape[-2:]
        eq = torch.eye(n, m, dtype=torch.bool, device=other.device)
        return other + torch.where(eq, self.diag[:, None], other.new_zeros(()))

    def __matmul__(self, other: torch.Tensor) -> torch.Tensor:
        return self.diag * other if other.ndim == 1 else self.diag[:, None] * other

    def to_qsm(self) -> Any:
        from tinygp_tpu_torch.solvers.quasisep.core import DiagQSM

        return DiagQSM(d=self.diag)


class Dense(Noise):
    """A full-rank observation-noise matrix ``value`` ``(N, N)``; it has no
    quasiseparable form, so only the dense solver takes it."""

    def __init__(self, value: torch.Tensor):
        super().__init__()
        self.register_buffer("value", value)

    def diagonal(self) -> torch.Tensor:
        return torch.diagonal(self.value)

    def __add__(self, other: torch.Tensor) -> torch.Tensor:
        return self.value + other

    def __matmul__(self, other: torch.Tensor) -> torch.Tensor:
        return self.value @ other

    def to_qsm(self) -> Any:
        raise NotImplementedError("a dense noise model has no compact quasiseparable form")


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

    def __add__(self, other: torch.Tensor) -> torch.Tensor:
        band = torch.diag_embed(self.diag)
        for j in range(self.off_diags.shape[1]):
            upper = torch.diag_embed(self.off_diags[: self.diag.shape[0] - j - 1, j], offset=j + 1)
            band = band + upper + upper.T
        return other + band

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
