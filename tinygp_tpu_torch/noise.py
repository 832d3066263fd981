"""Observation-noise models.

Counterpart of ``tinygp_tpu/noise.py``: the ``Noise`` protocol and the
``Diagonal`` model, as far as the quasiseparable log-likelihood reads them
(the diagonal). The dense algebra (``+`` and ``@``, used by the dense
solver and by conditioning), ``Dense`` and ``Banded`` noise and the
quasiseparable form ``to_qsm`` are ROADMAP items N2 and N3.
"""

from __future__ import annotations

__all__ = ["Noise", "Diagonal"]

from typing import Any

import torch
from torch import nn


class Noise(nn.Module):
    """The noise-model protocol."""

    def diagonal(self) -> torch.Tensor:
        """The diagonal of the noise matrix."""
        raise NotImplementedError("concrete noise models define diagonal()")

    def to_qsm(self) -> Any:
        """This noise model as a quasiseparable matrix."""
        raise NotImplementedError(
            "quasiseparable noise matrices are ROADMAP item N2 (core.py), "
            "not ported yet"
        )


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
