"""Automatic differentiation variational inference (ADVI).

Counterpart of ``tinygp_tpu/samplers/vi.py``: fits a Gaussian
approximation, diagonal (mean-field) or full-covariance (``full_rank=True``,
Cholesky-parameterized), to an unconstrained posterior by stochastic
maximization of the ELBO with the reparameterization trick.

Each step evaluates the log density at all ``num_elbo_samples`` draws at
once, ``torch.func.vmap(flat_log_prob)``, and differentiates the ELBO
outside that ``vmap``, as the JAX package does. A quasiseparable GP's
log-likelihood then reaches kernels B1r and B2 once each for all draws,
through the chain-axis ``Function`` that ``FusedLoglik``'s ``vmap`` rule
returns (``solvers/quasisep/cuda_loglik.py``). The JAX package runs the
optimization as one ``lax.scan``; here it is a Python loop of
``torch.optim.Adam`` steps (optax's update: the same moments, bias
corrections and ``eps`` outside the square root) that keeps the ELBO trace
on the device and reads nothing back until it ends.

Random numbers come from ``torch.Generator``\\ s seeded from ``(seed,
phase, step)``, as in :func:`~tinygp_tpu_torch.samplers.hmc.run_mcmc`; the
JAX package's keys draw other numbers, and the two agree in distribution.
"""

from __future__ import annotations

__all__ = ["ADVIResult", "ADVIFullRankResult", "fit_advi", "sample_advi"]

import math
from collections.abc import Callable
from typing import Any, NamedTuple

import torch

from tinygp_tpu_torch.helpers import pinned, resolve_device
from tinygp_tpu_torch.samplers.hmc import _generator, _ravel_spec

# The phases of the random streams: the ELBO's noise at each step, and the
# draws of sample_advi.
_STEP, _DRAW = range(2)


class ADVIResult(NamedTuple):
    """The fitted mean-field approximation (flat coordinates)."""

    mean: torch.Tensor
    log_std: torch.Tensor
    elbo_trace: torch.Tensor
    unravel: Any


class ADVIFullRankResult(NamedTuple):
    """The fitted full-covariance approximation (flat coordinates)."""

    mean: torch.Tensor
    scale_tril: torch.Tensor
    elbo_trace: torch.Tensor
    unravel: Any


def _scale(phi, full_rank: bool):
    """``(mean, log_scale, L)`` of the variational parameters ``phi``;
    ``L`` is None for mean-field."""
    if full_rank:
        mean, log_diag, off = phi
        return mean, log_diag, torch.tril(off, -1) + torch.diag(torch.exp(log_diag))
    mean, log_std = phi
    return mean, log_std, None


def _elbo(flat_log_prob: Callable[[torch.Tensor], torch.Tensor], full_rank: bool):
    """``elbo(phi, eps)``: the Monte-Carlo ELBO at the standard-normal noise
    ``eps (num_elbo_samples, dim)``, its log densities evaluated for all
    draws at once under ``torch.func.vmap``."""
    batched = torch.func.vmap(flat_log_prob)

    def elbo(phi, eps):
        mean, log_scale, L = _scale(phi, full_rank)
        if full_rank:
            zs = mean[None, :] + eps @ L.T
        else:
            zs = mean[None, :] + torch.exp(log_scale)[None, :] * eps
        logp = batched(zs)
        # Gaussian entropy: 0.5*log(2*pi*e) per dim + log|scale|.
        dim = eps.shape[-1]
        entropy = torch.sum(log_scale) + 0.5 * dim * (1.0 + math.log(2 * math.pi))
        return torch.mean(logp) + entropy

    return elbo


@pinned
def fit_advi(
    seed: int,
    log_prob_fn: Callable[[Any], torch.Tensor],
    init_params: Any,
    *,
    num_steps: int = 1000,
    num_elbo_samples: int = 8,
    learning_rate: float = 1e-2,
    init_log_std: float = -2.0,
    full_rank: bool = False,
    device: Any = None,
) -> ADVIResult | ADVIFullRankResult:
    """Fit a Gaussian posterior approximation.

    Args:
        seed: The run's seed (the JAX package takes a PRNG key); step ``k``
            draws its ELBO noise from a generator seeded with ``(seed, 0,
            k)``.
        log_prob_fn: Log density of a single pytree position
            (unconstrained space).
        init_params: Initialization pytree (the variational mean starts
            here).
        num_steps: Optimizer steps.
        num_elbo_samples: MC samples per ELBO estimate.
        learning_rate: Adam learning rate.
        init_log_std: The initial log scale of every dimension.
        full_rank: Fit a full covariance (Cholesky-parameterized) instead
            of the mean-field diagonal.
        device: Where the fit runs; ``None`` is the card (and raises where
            there is none), ``"cpu"`` the plain path. The log density must
            compute on the same device.

    Returns:
        An :class:`ADVIResult` (or :class:`ADVIFullRankResult`); draw
        posterior samples with :func:`sample_advi`.
    """
    device = resolve_device(device)
    ravel, unravel, dim = _ravel_spec(init_params)
    mean0 = ravel(init_params).to(device)
    if not mean0.is_floating_point():
        mean0 = mean0.to(torch.get_default_dtype())
    phi = [mean0.clone(), torch.full_like(mean0, init_log_std)]
    if full_rank:
        phi.append(mean0.new_zeros(dim, dim))
    for p in phi:
        p.requires_grad_(True)
    optimizer = torch.optim.Adam(phi, lr=learning_rate)
    elbo = _elbo(lambda z: log_prob_fn(unravel(z)), full_rank)
    trace = mean0.new_empty(num_steps)

    for k in range(num_steps):
        generator = _generator(seed, _STEP, k, device)
        eps = torch.randn((num_elbo_samples, dim), generator=generator, dtype=mean0.dtype,
                          device=device)
        optimizer.zero_grad(set_to_none=True)
        value = elbo(phi, eps)
        (-value).backward()
        optimizer.step()
        trace[k] = value.detach()

    mean, log_scale, L = (None if x is None else x.detach() for x in _scale(phi, full_rank))
    if full_rank:
        return ADVIFullRankResult(mean=mean, scale_tril=L, elbo_trace=trace, unravel=unravel)
    return ADVIResult(mean=mean, log_std=log_scale, elbo_trace=trace, unravel=unravel)


@pinned
def sample_advi(
    seed: int,
    result: ADVIResult | ADVIFullRankResult,
    num_samples: int,
) -> Any:
    """Draw pytree samples from a fitted ADVI approximation, each leaf with
    a leading axis of ``num_samples``."""
    mean = result.mean
    generator = _generator(seed, _DRAW, 0, mean.device)
    eps = torch.randn((num_samples, mean.shape[0]), generator=generator, dtype=mean.dtype,
                      device=mean.device)
    if isinstance(result, ADVIFullRankResult):
        zs = mean[None, :] + eps @ result.scale_tril.T
    else:
        zs = mean[None, :] + torch.exp(result.log_std)[None, :] * eps
    return result.unravel(zs)
