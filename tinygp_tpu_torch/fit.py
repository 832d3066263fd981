"""Maximum-a-posteriori / maximum-likelihood fitting.

Counterpart of ``tinygp_tpu/fit.py``. The JAX package compiles the whole
optimisation into one program (optax driven by ``lax.scan``); here the loop
is Python, one forward and one backward per step, and the optimizer is a
``torch.optim.Optimizer``. The semantics are the JAX package's: the best
step is tracked rather than the last one, a non-finite loss counts as
``+inf``, and ``converged`` needs a flat final window that sits at the best
loss. The parameters live on one device, the card unless the caller asks
for the CPU, as every entry point of the port. The loop reads nothing back
to the host until it ends, so on the card the steps queue without waiting
on each other.
"""

from __future__ import annotations

__all__ = ["fit_map", "FitResult"]

import math
from collections.abc import Callable
from typing import Any, NamedTuple

import torch

from tinygp_tpu_torch.helpers import as_hyper, resolve_device

Params = dict[str, torch.Tensor]


class FitResult(NamedTuple):
    params: Params
    """Parameters at the best (lowest-loss) step seen, not the last one."""

    loss: torch.Tensor
    """Loss at :attr:`params`."""

    losses: torch.Tensor
    """Per-step loss trace, shape ``(num_steps,)``."""

    converged: bool
    """Whether the trajectory settled: the final-window mean |loss change|
    fell below ``tol`` AND the final window sits at the best loss seen (a
    flat-but-diverged tail does not count)."""


def fit_map(
    loss_fn: Callable[[Params], torch.Tensor],
    init_params: Params,
    *,
    optimizer: Callable[[list[torch.Tensor]], torch.optim.Optimizer] | None = None,
    num_steps: int = 500,
    learning_rate: float = 0.05,
    tol: float = 1e-6,
    device: Any = None,
    dtype: torch.dtype | None = None,
) -> FitResult:
    """Minimise a scalar loss over a dict of parameter tensors.

    Args:
        loss_fn: Scalar objective, e.g.
            ``lambda p: -build_gp(p).log_probability(y)``.
        init_params: Starting values, a dict of tensors, numbers or numpy
            arrays. They are copied onto ``device`` in ``dtype``, not
            updated.
        optimizer: Takes the list of parameter tensors and returns a
            ``torch.optim.Optimizer``; defaults to
            ``torch.optim.Adam(lr=learning_rate)``, which is optax's
            ``adam(learning_rate)`` (same betas, eps and bias correction).
        num_steps: Number of steps, each one loss and one gradient.
        learning_rate: Used only for the default optimizer.
        tol: Convergence threshold on the mean per-step improvement over the
            last tenth of the trajectory (reported, not an early exit).
        device: Where the parameters and the optimizer's state live;
            ``None`` is ``"cuda"``, and raises where there is none. Pass
            ``"cpu"`` for the plain PyTorch path.
        dtype: The parameters' dtype; ``None`` keeps each start's own
            (float64 for Python numbers).

    Returns:
        A :class:`FitResult`; ``result.params`` tracks the best step seen,
        so a late divergence (too hot a learning rate) cannot corrupt the
        fit. Non-finite losses count as ``+inf`` for that tracking, so an
        excursion through an invalid region is recoverable.
    """
    if num_steps < 1:
        raise ValueError(f"num_steps must be at least 1; got {num_steps}")
    device = resolve_device(device)
    params = {}
    for name, value in init_params.items():
        value = as_hyper(value).detach()
        value = value.to(device=device, dtype=dtype or value.dtype)
        params[name] = value.clone().requires_grad_(True)
    if optimizer is None:
        opt = torch.optim.Adam(list(params.values()), lr=learning_rate)
    else:
        opt = optimizer(list(params.values()))

    best_params = {name: p.detach().clone() for name, p in params.items()}
    best_loss = None
    losses = []
    for _ in range(num_steps):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params)
        loss.backward()
        value = loss.detach()
        guarded = torch.where(torch.isfinite(value), value, math.inf)
        if best_loss is None:
            best_loss = torch.full_like(guarded, math.inf)
        better = guarded < best_loss
        best_params = {
            name: torch.where(better, p.detach(), best_params[name])
            for name, p in params.items()
        }
        best_loss = torch.where(better, guarded, best_loss)
        losses.append(value)
        opt.step()

    losses = torch.stack(losses)
    window = max(1, num_steps // 10)
    drops = -torch.diff(losses[-window - 1 :])
    # |mean drop| < tol: a rising final window (late divergence gives
    # negative drops) must not read as converged, and the final window must
    # sit at the best loss seen, or the trajectory left its optimum behind.
    flat = bool(torch.abs(torch.nanmean(drops)) < tol)
    tail = losses[-window:]
    tail = tail[~torch.isnan(tail)]
    final_best = float(tail.min()) if tail.numel() else math.nan
    scale = max(1.0, abs(float(best_loss)))
    near_best = final_best <= float(best_loss) + 1e-3 * scale
    return FitResult(best_params, best_loss, losses, flat and near_best)
