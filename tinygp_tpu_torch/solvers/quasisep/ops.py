"""Named quasiseparable operations.

Counterpart of ``tinygp_tpu/solvers/quasisep/ops.py``, as far as the
log-likelihood needs: :func:`stacked_loglik_terms`. The triangular
matmuls and solves, the Cholesky and the symmetric inverse come with
conditioning (ROADMAP item N2: kernel B3 and ``core.py``).
"""

from __future__ import annotations

__all__ = ["stacked_loglik_terms"]

import torch

from tinygp_tpu_torch.solvers.quasisep import cuda_loglik


def stacked_loglik_terms(
    d: torch.Tensor,
    ps: torch.Tensor,
    qs: torch.Tensor,
    as_: torch.Tensor,
    y: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(alpha . alpha, sum(log c))`` for ``K = diag(d) + tril + tril^T``.

    Operands are stacked: ``d``/``y`` of shape ``(N,)``, generators
    ``ps``/``qs`` of ``(m, N)``, dense transitions ``as_`` of ``(m*m, N)``.
    Mixed dtypes promote here; on the card the CUDA kernel does the whole
    job, on the CPU its plain version
    (:func:`~tinygp_tpu_torch.solvers.quasisep.cuda_loglik.fused_loglik_terms`).
    """
    dtype = d.dtype
    for x in (ps, qs, as_, y):
        dtype = torch.promote_types(dtype, x.dtype)
    d, ps, qs, as_, y = (x.to(dtype).contiguous() for x in (d, ps, qs, as_, y))
    return cuda_loglik.fused_loglik_terms(d, ps, qs, as_, y)
