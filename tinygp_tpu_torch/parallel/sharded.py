"""Mesh-sharded samplers: chains and particles across the ranks of a mesh
axis.

Counterpart of ``tinygp_tpu/parallel/sharded.py``. Each rank runs its
block of the chains (or particles), in rank order, through the port's
chain-axis samplers, so each of its density evaluations is one batched
evaluation for its block: on the card, one chain-axis launch of kernels
B1r and B2 per NUTS or HMC evaluation, of B1 per SMC evaluation, for a
quasiseparable GP. Ranks communicate only where the JAX package does:
in the warmup's adaptation statistics, and in SMC's temperature, weights,
resampling, mutation moments and acceptance.

**The same numbers as one process.** Each rank draws every step's random
numbers for all chains, from the streams of ``run_mcmc`` and ``run_smc``
(``(seed, phase, step)``), and keeps its rows; every reduction gathers the
blocks and reduces them in global chain order. So a sharded run's blocks
are, bit for bit, the rows of ``run_mcmc`` (with ``warmup_depth_cap=None``:
the JAX package's sharded warmup does not anneal the tree depth) and of
``run_smc`` with the same seed on the same device type, at any number of
ranks, as long as the log density gives each chain the same bits in a
batch of any size (the chain-axis kernels do). No collective sits inside
the NUTS loops, which run on the host while any of the rank's own chains
is active.

Where the JAX functions take a PRNG key these take a seed, as the port's
samplers do; ``device`` defaults to the card. Each rank returns its block
of a chain- or particle-sharded output (the JAX global array's shard on
that device); replicated outputs (``log_evidence``, ``betas``,
``num_stages``, ``acceptance``) are whole on every rank.
"""

from __future__ import annotations

__all__ = ["run_mcmc_sharded", "run_smc_sharded"]

from collections.abc import Callable
from typing import Any

import torch
from torch.distributed.device_mesh import DeviceMesh

from tinygp_tpu_torch.helpers import pinned, resolve_device
from tinygp_tpu_torch.parallel.mesh import axis_group, chain_axis, group_rank, local_chunk
from tinygp_tpu_torch.samplers.hmc import _mcmc_programs, _run_chains
from tinygp_tpu_torch.samplers.smc import _run_smc
from tinygp_tpu_torch.utils.tree import tree_leaves


@pinned
def run_mcmc_sharded(
    seed: int,
    log_prob_fn: Callable[[Any], torch.Tensor],
    init_params: Any,
    *,
    mesh: DeviceMesh,
    num_chains: int,
    num_warmup: int = 500,
    num_samples: int = 1000,
    sampler: str = "nuts",
    max_tree_depth: int = 8,
    num_leapfrog: int = 32,
    target_accept: float = 0.8,
    initial_step_size: float = 0.1,
    jitter_init: float = 1.0,
    axis: str = chain_axis,
    device: Any = None,
) -> tuple[Any, dict[str, torch.Tensor]]:
    """Run vectorized MCMC with chains sharded over a mesh axis.

    Semantics match :func:`tinygp_tpu_torch.samplers.run_mcmc`, but each
    rank integrates its ``num_chains / axis size`` chains, and the warmup's
    adaptation statistics reduce over the axis, so all ranks share one
    step size and mass matrix.

    Returns ``(samples, info)`` for this rank's chains: ``samples`` shaped
    ``(num_samples, num_chains / axis size, ...)`` on every leaf, ``info``
    a dict of ``accept_prob`` and ``num_steps`` of that shape.
    """
    c_loc = local_chunk(num_chains, mesh, axis)
    group = axis_group(mesh, axis)
    start = group_rank(group) * c_loc
    programs = _mcmc_programs(log_prob_fn, init_params, num_warmup, sampler, max_tree_depth,
                              num_leapfrog, target_accept, None, axis=group)
    samples, info = _run_chains(
        seed, programs, init_params, num_chains=num_chains, num_warmup=num_warmup,
        num_samples=num_samples, initial_step_size=initial_step_size, jitter_init=jitter_init,
        steps_per_dispatch=None, checkpoint_path=None, checkpoint_every=1,
        device=resolve_device(device), rows=(start, start + c_loc),
    )
    return samples, {"accept_prob": info.accept_prob, "num_steps": info.num_steps}


@pinned
def run_smc_sharded(
    seed: int,
    log_prior_fn: Callable[[Any], torch.Tensor],
    log_like_fn: Callable[[Any], torch.Tensor],
    init_particles: Any,
    *,
    mesh: DeviceMesh,
    num_mutations: int = 5,
    target_ess: float = 0.5,
    max_stages: int = 50,
    rw_scale: float = 0.5,
    axis: str = chain_axis,
    device: Any = None,
) -> dict[str, Any]:
    """Adaptive tempered SMC with particles sharded over a mesh axis.

    Every rank passes the same ``init_particles`` (all of them) and moves
    its block. Each stage all-gathers the log-likelihoods and the
    particles, runs the shared systematic-resampling rule on the weight
    increments with the same uniform, and keeps this rank's stratum.

    Returns a dict with this rank's equally-weighted ``particles``, and
    the ``log_evidence`` estimate, the ``betas``, ``num_stages`` and the
    per-stage ``acceptance``, whole on every rank.
    """
    local_chunk(tree_leaves(init_particles)[0].shape[0], mesh, axis)
    result = _run_smc(seed, log_prior_fn, log_like_fn, init_particles,
                      num_mutations=num_mutations, target_ess=target_ess, max_stages=max_stages,
                      rw_scale=rw_scale, device=resolve_device(device),
                      group=axis_group(mesh, axis))
    return {
        "particles": result.particles,
        "log_evidence": result.log_evidence,
        "betas": result.betas,
        "num_stages": result.num_stages,
        "acceptance": result.acceptance,
    }
