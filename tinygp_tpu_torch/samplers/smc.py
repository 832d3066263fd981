"""Adaptive tempered Sequential Monte Carlo.

Counterpart of ``tinygp_tpu/samplers/smc.py``. Anneals from the prior to
the posterior through tempered targets ``pi_beta ∝ prior *
likelihood^beta``: the temperature ladder is chosen adaptively from the
effective sample size, the particles are resampled systematically and
moved by random-walk Metropolis.

The particles carry a leading axis. Every density evaluation is value-only
(under ``torch.no_grad()``) and runs for all particles at once under
``torch.func.vmap``, so a quasiseparable GP's log-likelihood reaches kernel
B1 once for every particle through its ``vmap`` rule
(``solvers/quasisep/cuda_loglik.py``); :data:`EVALUATIONS` counts those
batched evaluations. The JAX package runs the stages in a ``while_loop``;
here they run on the host, which reads the temperature back once a stage.

Random numbers come from a ``torch.Generator`` seeded from ``(seed,
stage)``; the JAX package's keys draw other numbers, and the two agree in
distribution. Resampling is split into drawing its uniform and a
deterministic map from that uniform and the log-weights to indices
(:func:`_systematic_indices`), which takes the JAX package's own uniform in
the tests.
"""

from __future__ import annotations

__all__ = ["SMCResult", "run_smc"]

import math
from collections.abc import Callable
from typing import Any, NamedTuple

import torch

from tinygp_tpu_torch.helpers import pinned, resolve_device
from tinygp_tpu_torch.samplers.hmc import _generator, _rand, _randn, _ravel_spec, _Rows
from tinygp_tpu_torch.utils.tree import tree_flatten, tree_unflatten

EVALUATIONS = 0
"""Batched evaluations of a log density (one for all particles) made by
:func:`run_smc`."""

# The phase of run_smc's random streams (one generator a stage).
_STAGE = 0


class SMCResult(NamedTuple):
    particles: Any
    """Posterior particles; equally weighted (the final stage resamples)."""
    log_weights: torch.Tensor
    """Normalized log-weights of ``particles``: uniform ``-log(n)``."""
    log_evidence: torch.Tensor
    """Log marginal likelihood estimate from the tempering identity."""
    betas: torch.Tensor
    """The adaptive temperature ladder, shape ``(max_stages,)``; entries
    beyond ``num_stages`` are NaN. ``betas[num_stages-1] == 1.0``."""
    acceptance: torch.Tensor
    """Mutation-move acceptance rate per stage (NaN beyond the ladder)."""
    num_stages: torch.Tensor


def _systematic_indices(u: torch.Tensor, log_weights: torch.Tensor) -> torch.Tensor:
    """Systematic resampling's indices for the uniform ``u``: one uniform,
    N strata."""
    n = log_weights.shape[0]
    cdf = torch.cumsum(torch.softmax(log_weights, 0), 0)
    strata = (u + torch.arange(n, dtype=log_weights.dtype, device=log_weights.device)) / n
    return torch.searchsorted(cdf, strata, right=True).clamp(0, n - 1)


def _ess(log_weights: torch.Tensor) -> torch.Tensor:
    logw = log_weights - torch.logsumexp(log_weights, 0)
    return torch.exp(-torch.logsumexp(2.0 * logw, 0))


def _next_beta(log_like: torch.Tensor, beta: torch.Tensor, target_ess: float) -> torch.Tensor:
    """Largest temperature increment keeping the ESS above the target,
    found with a fixed-depth bisection on the device."""
    n = log_like.shape[0]

    def ess_at(new_beta):
        return _ess((new_beta - beta) * log_like)

    lo, hi = beta, torch.ones_like(beta)
    for _ in range(32):
        mid = 0.5 * (lo + hi)
        ok = ess_at(mid) >= target_ess * n
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    full = ess_at(torch.ones_like(beta)) >= target_ess * n
    return torch.where(full, 1.0, lo)


def _nan_to_neg_inf(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isnan(x), -torch.inf, x)


@pinned
def run_smc(
    seed: int,
    log_prior_fn: Callable[[Any], torch.Tensor],
    log_like_fn: Callable[[Any], torch.Tensor],
    init_particles: Any,
    *,
    num_mutations: int = 5,
    target_ess: float = 0.5,
    max_stages: int = 50,
    rw_scale: float = 0.5,
    device: Any = None,
) -> SMCResult:
    """Run adaptive tempered SMC from the prior to the posterior.

    Args:
        seed: The run's seed (the JAX package takes a PRNG key); stage
            ``k`` draws from a generator seeded with ``(seed, 0, k)``.
        log_prior_fn / log_like_fn: Log densities of a single pytree
            position (unconstrained space).
        init_particles: Particles drawn from the prior, stacked along a
            leading axis on every leaf.
        num_mutations: Random-walk Metropolis moves per stage.
        target_ess: ESS fraction triggering the temperature choice.
        max_stages: Bound on the number of tempering stages.
        rw_scale: Proposal scale relative to the particle-cloud std.
        device: Where the particles live; ``None`` is the card (and raises
            where there is none), ``"cpu"`` the plain path. The log
            densities must compute on the same device.

    Returns:
        An :class:`SMCResult` with equally-weighted posterior particles and
        the log-evidence estimate.
    """
    return _run_smc(seed, log_prior_fn, log_like_fn, init_particles,
                    num_mutations=num_mutations, target_ess=target_ess, max_stages=max_stages,
                    rw_scale=rw_scale, device=resolve_device(device))


def _run_smc(
    seed, log_prior_fn, log_like_fn, init_particles, *, num_mutations, target_ess, max_stages,
    rw_scale, device, group=None,
) -> SMCResult:
    """:func:`run_smc` after its arguments are resolved. With ``group``, a
    process group whose ranks hold the particles in equal blocks in rank
    order, this rank moves its block: each reduction gathers the blocks
    and reduces them in global particle order, and each draw is made for
    all particles and sliced (``hmc._Rows``), so the rank's particles are
    its rows of the single run's."""
    leaves, spec = tree_flatten(init_particles)
    leaves = [torch.as_tensor(x).to(device) for x in leaves]
    n = leaves[0].shape[0]
    _, unravel, _ = _ravel_spec(tree_unflatten(spec, [x[0] for x in leaves]))
    zs = torch.cat([x.reshape(n, -1) for x in leaves], dim=1)
    if not zs.is_floating_point():
        zs = zs.to(torch.get_default_dtype())
    start, stop = 0, n
    if group is not None:
        from tinygp_tpu_torch.parallel.mesh import gather, group_rank, group_size

        start = group_rank(group) * (n // group_size(group))
        stop = start + n // group_size(group)
        zs = zs[start:stop]

    def everyone(x):
        """The particles' ``x`` over all ranks, in global order."""
        return x if group is None else gather(x, group)

    batched_prior = torch.func.vmap(lambda z: log_prior_fn(unravel(z)))
    batched_like = torch.func.vmap(lambda z: log_like_fn(unravel(z)))

    def evaluate(fn, z):
        global EVALUATIONS
        EVALUATIONS += 1
        return fn(z)

    def log_pi(z, beta):
        return evaluate(lambda x: batched_prior(x) + beta * batched_like(x), z)

    def mutate(stream, zs, beta):
        """num_mutations random-walk MH steps targeting pi_beta."""
        # Preconditioned proposal: scale by the per-dimension particle std.
        std = torch.std(everyone(zs), dim=0, correction=0) + 1e-12
        logp = log_pi(zs, beta)
        n_acc = zs.new_zeros(())
        for _ in range(num_mutations):
            noise = _randn(zs.shape, stream, zs)
            prop = zs + rw_scale * std[None, :] * noise
            logp_prop = _nan_to_neg_inf(log_pi(prop, beta))
            u = _rand(zs.shape[0], stream, zs)
            accept = torch.log(u) < logp_prop - logp
            zs = torch.where(accept[:, None], prop, zs)
            logp = torch.where(accept, logp_prop, logp)
            n_acc = n_acc + torch.mean(everyone(accept).to(zs.dtype))
        return zs, n_acc / num_mutations

    with torch.no_grad():
        beta = zs.new_zeros(())
        log_z = zs.new_zeros(())
        betas = torch.full((max_stages,), torch.nan, dtype=zs.dtype, device=device)
        accs = torch.full((max_stages,), torch.nan, dtype=zs.dtype, device=device)
        k = 0
        while k < max_stages and float(beta) < 1.0:
            generator = _generator(seed, _STAGE, k, device)
            stream = generator if group is None else _Rows(generator, n, start)
            log_like = everyone(_nan_to_neg_inf(evaluate(batched_like, zs)))
            new_beta = _next_beta(log_like, beta, target_ess)
            incr = (new_beta - beta) * log_like
            log_z = log_z + torch.logsumexp(incr, 0) - math.log(n)

            u = torch.rand((), generator=generator, dtype=zs.dtype, device=device)
            zs = everyone(zs)[_systematic_indices(u, incr)[start:stop]]
            zs, acc_rate = mutate(stream, zs, new_beta)
            betas[k] = new_beta
            accs[k] = acc_rate
            beta = new_beta
            k += 1

    return SMCResult(
        particles=unravel(zs),
        log_weights=torch.full((stop - start,), -math.log(n), dtype=zs.dtype, device=device),
        log_evidence=log_z,
        betas=betas,
        acceptance=accs,
        num_stages=torch.tensor(k, dtype=torch.int32),
    )
