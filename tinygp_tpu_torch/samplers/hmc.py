"""Many-chain Hamiltonian Monte Carlo and iterative NUTS.

Counterpart of ``tinygp_tpu/samplers/hmc.py``: fixed-length HMC, the
iterative multinomial NUTS with its O(``max_tree_depth``) checkpoints for
the U-turn checks, dual-averaged step sizes with staged diagonal mass
adaptation, and the driver :func:`run_mcmc` with chunked steps and
checkpoint resume.

**A chain axis, written out.** The JAX package writes each transition for
one chain and lifts it with ``vmap``; ``vmap`` of a ``while_loop`` there
means "loop while any chain is active, and update only the active ones".
``torch.func.vmap`` cannot lift a loop whose trip count depends on values,
so the port writes that form directly: every state carries a leading chain
axis ``(C, dim)``, the loops run on the host while any chain is active
(one read of a flag from the device per iteration), and every update is
masked by the chains still active. All active chains of a NUTS doubling
are at the same depth and leaf, so those indices are host integers.

**The log density.** ``log_prob_fn`` is, as in the JAX package, the log
density of *one* flat position. Each leapfrog step evaluates it and its
gradient for all chains at once, ``torch.func.vmap(torch.func.grad_and_value
(log_prob_fn))``; a quasiseparable GP's log-likelihood then reaches kernels
B1r and B2 once each for all chains, through their ``vmap`` rules
(``solvers/quasisep/cuda_loglik.py``). :data:`EVALUATIONS` counts those
batched evaluations.

**Random numbers** come from ``torch.Generator``\\ s on the chains' device.
:func:`run_mcmc` seeds one for each step from ``(seed, phase, step)``, so a
run cut into chunks, or resumed from a checkpoint, draws the same numbers
and gives the same samples bit for bit. A transition draws the same
numbers whatever its loops' trip counts: each NUTS doubling draws the
uniforms of all its ``2^depth`` leaves at once. So a rank that runs some of
the chains (``parallel.run_mcmc_sharded``), and stops doubling when its own
chains are done, draws every chain's numbers and keeps its rows: its
samples are those rows of the single run's. The JAX package's keys draw
other numbers: the two agree in distribution.
"""

from __future__ import annotations

__all__ = [
    "hmc",
    "nuts",
    "window_adaptation",
    "run_mcmc",
    "WarmupInfo",
    "find_initial_step_size",
    "HMCState",
    "HMCInfo",
]

import os
from collections.abc import Callable
from typing import Any, NamedTuple

import numpy as np
import torch

from tinygp_tpu_torch.helpers import pinned, resolve_device
from tinygp_tpu_torch.utils import checkpoint
from tinygp_tpu_torch.utils.tree import tree_flatten, tree_unflatten

EVALUATIONS = 0
"""Batched evaluations of a log density and its gradient (one for all
chains) made by the samplers."""

# The phases of run_mcmc's random streams.
_INIT, _WARMUP, _SAMPLE, _SEARCH = range(4)


def _generator(seed: int, phase: int, step: int, device: torch.device) -> torch.Generator:
    """The stream of step ``step`` of ``phase``, seeded from the three."""
    state = np.random.SeedSequence([int(seed), phase, step]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def _ravel_spec(example: Any):
    """``(ravel, unravel, dim)`` for a pytree position (dicts, lists and
    tuples of tensors). ``unravel`` takes any leading axes."""
    leaves, spec = tree_flatten(example)
    leaves = [torch.as_tensor(x) for x in leaves]
    shapes = [x.shape for x in leaves]
    sizes = [x.numel() for x in leaves]

    def ravel(tree):
        return torch.cat([torch.as_tensor(p).reshape(-1) for p in tree_flatten(tree)[0]])

    def unravel(flat):
        lead = flat.shape[:-1]
        out, idx = [], 0
        for shape, size in zip(shapes, sizes):
            out.append(flat[..., idx : idx + size].reshape(lead + shape))
            idx += size
        return tree_unflatten(spec, out)

    return ravel, unravel, sum(sizes)


def _value_and_grad(log_prob_fn: Callable[[torch.Tensor], torch.Tensor]):
    """``z (C, dim) -> (log_prob (C,), grad (C, dim))`` for a log density of
    one flat position: one evaluation for all chains."""
    batched = torch.func.vmap(torch.func.grad_and_value(log_prob_fn))

    @pinned
    def value_and_grad(z):
        global EVALUATIONS
        grad, lp = batched(z)
        EVALUATIONS += 1
        return lp, grad

    return value_and_grad


class HMCState(NamedTuple):
    """The chains' sampler state (flat position space), each with a leading
    chain axis."""

    z: torch.Tensor
    log_prob: torch.Tensor
    grad: torch.Tensor


class HMCInfo(NamedTuple):
    """Diagnostics emitted by each transition, one per chain."""

    accept_prob: torch.Tensor
    accepted: torch.Tensor
    energy: torch.Tensor
    num_steps: torch.Tensor
    diverging: torch.Tensor


def _leapfrog(value_and_grad, z, r, grad, step_size, inv_mass):
    r = r + 0.5 * step_size * grad
    z = z + step_size * inv_mass * r
    lp, grad = value_and_grad(z)
    r = r + 0.5 * step_size * grad
    return z, r, lp, grad


def _kinetic(r, inv_mass):
    """Each chain's kinetic energy, summed over the last axis."""
    return 0.5 * torch.sum(torch.square(r) * inv_mass, dim=-1)


def _where(mask, new, old):
    """``new`` where the chain's ``mask`` is set, else ``old`` (the chain
    axis first)."""
    return torch.where(mask.reshape(-1, *(1,) * (new.ndim - 1)), new, old)


class _Rows(NamedTuple):
    """A step's stream for rows ``start:start + n`` of ``total`` chains:
    each draw is made for all chains and these rows are kept, so a rank's
    numbers are its rows of the single run's."""

    generator: torch.Generator
    total: int
    start: int


def _draw(sample, shape, generator, like, chain_dim=0):
    """``sample`` (``torch.rand`` or ``torch.randn``) of ``shape``, whose
    ``chain_dim`` is the chain axis, from a generator or a :class:`_Rows`."""
    if isinstance(generator, _Rows):
        full = list(shape)
        full[chain_dim] = generator.total
        out = sample(full, generator=generator.generator, dtype=like.dtype, device=like.device)
        return out.narrow(chain_dim, generator.start, shape[chain_dim])
    return sample(shape, generator=generator, dtype=like.dtype, device=like.device)


def _randn(shape, generator, like):
    return _draw(torch.randn, shape, generator, like)


def _rand(n, generator, like):
    return _draw(torch.rand, (n,), generator, like)


def hmc(
    log_prob_fn: Callable[[torch.Tensor], torch.Tensor],
    *,
    num_leapfrog: int = 32,
):
    """Build a fixed-length HMC transition on *flat* positions.

    ``log_prob_fn`` is the log density of one position ``(dim,)``. Returns
    ``(init_fn, step_fn)``: ``init_fn(z0)`` takes positions ``(C, dim)``,
    ``step_fn(generator, state, step_size, inv_mass)`` runs one
    accept/reject trajectory for every chain.
    """
    value_and_grad = _value_and_grad(log_prob_fn)

    def init_fn(z0: torch.Tensor) -> HMCState:
        lp, grad = value_and_grad(z0)
        return HMCState(z=z0, log_prob=lp, grad=grad)

    def step_fn(generator, state: HMCState, step_size, inv_mass):
        r0 = _randn(state.z.shape, generator, state.z) / torch.sqrt(inv_mass)
        u = _rand(state.z.shape[0], generator, state.z)
        energy0 = -state.log_prob + _kinetic(r0, inv_mass)
        z, r, lp, grad = state.z, r0, state.log_prob, state.grad
        for _ in range(num_leapfrog):
            z, r, lp, grad = _leapfrog(value_and_grad, z, r, grad, step_size, inv_mass)
        energy1 = -lp + _kinetic(r, inv_mass)
        delta = energy0 - energy1
        delta = torch.where(torch.isnan(delta), -torch.inf, delta)
        accept_prob = torch.clamp_max(torch.exp(delta), 1.0)
        accept = u < accept_prob
        new_state = HMCState(
            z=_where(accept, z, state.z),
            log_prob=_where(accept, lp, state.log_prob),
            grad=_where(accept, grad, state.grad),
        )
        info = HMCInfo(
            accept_prob=accept_prob,
            accepted=accept,
            energy=energy1,
            num_steps=torch.full_like(accept, num_leapfrog, dtype=torch.int32),
            diverging=delta < -1000.0,
        )
        return new_state, info

    return init_fn, step_fn


# ---------------------------------------------------------------------------
# Iterative NUTS
# ---------------------------------------------------------------------------


class _TreeState(NamedTuple):
    """The running trajectory state during iterative doubling, per chain."""

    z_left: torch.Tensor
    r_left: torch.Tensor
    grad_left: torch.Tensor
    z_right: torch.Tensor
    r_right: torch.Tensor
    grad_right: torch.Tensor
    z_proposal: torch.Tensor
    lp_proposal: torch.Tensor
    grad_proposal: torch.Tensor
    log_sum_weight: torch.Tensor
    sum_r: torch.Tensor
    depth: torch.Tensor
    turning: torch.Tensor
    diverging: torch.Tensor
    sum_accept: torch.Tensor
    num_steps: torch.Tensor


def _is_turning(r_left, r_right, sum_r, inv_mass):
    """Generalized U-turn condition on the momentum sum, per chain."""
    v = sum_r * inv_mass
    left = torch.sum(v * r_left, dim=-1)
    right = torch.sum(v * r_right, dim=-1)
    return (left <= 0.0) | (right <= 0.0)


def nuts(
    log_prob_fn: Callable[[torch.Tensor], torch.Tensor],
    *,
    max_tree_depth: int = 8,
    max_delta_energy: float = 1000.0,
):
    """Build an iterative multinomial NUTS transition on flat positions.

    Returns ``(init_fn, step_fn)`` with the signatures of :func:`hmc`;
    ``step_fn`` also takes ``depth_cap``, a bound on the tree depth below
    ``max_tree_depth``. Each chain doubles its tree until it turns,
    diverges or reaches the cap; a doubling runs ``2^depth`` leapfrog steps
    with the U-turn checks of its subtree against checkpoints at the
    levels whose blocks the step starts or ends. Both loops run while any
    chain is active and update only the active chains.
    """
    value_and_grad = _value_and_grad(log_prob_fn)

    def init_fn(z0: torch.Tensor) -> HMCState:
        lp, grad = value_and_grad(z0)
        return HMCState(z=z0, log_prob=lp, grad=grad)

    def _build_subtree(generator, tree, direction, depth, step_size, inv_mass, energy0, active):
        """Integrate up to 2^depth steps in each active chain's direction,
        with the subtree's U-turn checks; return its summary: endpoints, a
        multinomial proposal, its total weight, momentum sum, flags, summed
        accept statistic and steps taken."""
        right = direction > 0
        z = _where(right, tree.z_right, tree.z_left)
        r = _where(right, tree.r_right, tree.r_left)
        grad = _where(right, tree.grad_right, tree.grad_left)
        eps = (direction * step_size)[:, None]
        chains, dim = z.shape

        # Checkpoints of the momentum and of the momentum sum before it, for
        # the levels 0..depth: leaf idx starts a block of 2^l at level l when
        # 2^l divides idx and ends one when 2^l divides idx + 1.
        ckpt_r = z.new_zeros(chains, depth + 1, dim)
        ckpt_sum_r = z.new_zeros(chains, depth + 1, dim)
        z_prop, grad_prop = z, grad
        lp_prop = torch.full_like(energy0, -torch.inf)
        log_sum_w = torch.full_like(energy0, -torch.inf)
        sum_r = torch.zeros_like(z)
        sum_acc = torch.zeros_like(energy0)
        turning = torch.zeros_like(active)
        diverging = torch.zeros_like(active)
        steps = torch.zeros(chains, dtype=torch.int32, device=z.device)
        live = active
        # Every leaf's uniform at once, so the stream does not depend on
        # where the loop stops.
        u_leaves = _draw(torch.rand, (1 << depth, chains), generator, z, chain_dim=1)
        for idx in range(1 << depth):
            if idx and not bool(live.any()):
                break
            u = u_leaves[idx]
            z1, r1, lp1, grad1 = _leapfrog(value_and_grad, z, r, grad, eps, inv_mass)
            delta = energy0 - (-lp1 + _kinetic(r1, inv_mass))
            delta = torch.where(torch.isnan(delta), -torch.inf, delta)
            new_log_sum = torch.logaddexp(log_sum_w, delta)
            # Multinomial (progressive) sampling within the subtree.
            take = live & (u < torch.exp(delta - new_log_sum))
            sum_r1 = sum_r + r1
            turn1 = turning
            for level in range(depth + 1):
                block = 1 << level
                if idx % block == 0:
                    ckpt_r[:, level] = r1
                    ckpt_sum_r[:, level] = sum_r1 - r1
                if block > 1 and (idx + 1) % block == 0:
                    seg = sum_r1 - ckpt_sum_r[:, level]
                    turn1 = turn1 | _is_turning(ckpt_r[:, level], r1, seg, inv_mass)

            z, r, grad = _where(live, z1, z), _where(live, r1, r), _where(live, grad1, grad)
            z_prop = _where(take, z1, z_prop)
            lp_prop = torch.where(take, lp1, lp_prop)
            grad_prop = _where(take, grad1, grad_prop)
            log_sum_w = torch.where(live, new_log_sum, log_sum_w)
            sum_r = _where(live, sum_r1, sum_r)
            sum_acc = torch.where(live, sum_acc + torch.clamp_max(torch.exp(delta), 1.0), sum_acc)
            turning = torch.where(live, turn1, turning)
            diverging = torch.where(live, delta < -max_delta_energy, diverging)
            steps = steps + live.to(torch.int32)
            live = live & ~turning & ~diverging
        return (z, r, grad, z_prop, lp_prop, grad_prop, log_sum_w, sum_r, turning, diverging,
                sum_acc, steps)

    def step_fn(generator, state: HMCState, step_size, inv_mass, depth_cap=None):
        # ``depth_cap``: an optional bound <= max_tree_depth; the warmup can
        # anneal it (shallow trees while the chains are far from the typical
        # set and the step size is untuned).
        cap = max_tree_depth if depth_cap is None else min(int(depth_cap), max_tree_depth)
        z0 = state.z
        chains = z0.shape[0]
        r0 = _randn(z0.shape, generator, z0) / torch.sqrt(inv_mass)
        energy0 = -state.log_prob + _kinetic(r0, inv_mass)
        no = torch.zeros(chains, dtype=torch.bool, device=z0.device)
        tree = _TreeState(
            z_left=z0, r_left=r0, grad_left=state.grad,
            z_right=z0, r_right=r0, grad_right=state.grad,
            z_proposal=z0, lp_proposal=state.log_prob, grad_proposal=state.grad,
            log_sum_weight=torch.zeros_like(energy0), sum_r=r0,
            depth=torch.zeros(chains, dtype=torch.int32, device=z0.device),
            turning=no, diverging=no, sum_accept=torch.zeros_like(energy0),
            num_steps=torch.zeros(chains, dtype=torch.int32, device=z0.device),
        )
        active = ~no
        for depth in range(cap):
            if depth and not bool(active.any()):
                break
            direction = torch.where(_rand(chains, generator, z0) < 0.5, 1.0, -1.0).to(z0.dtype)
            u_accept = _rand(chains, generator, z0)
            (z_end, r_end, grad_end, z_prop, lp_prop, grad_prop, log_sum_w, sum_r,
             sub_turning, sub_diverging, sum_acc, steps_done) = _build_subtree(
                generator, tree, direction, depth, step_size, inv_mass, energy0, active)

            # Update the extended endpoint.
            right = direction > 0
            z_left = _where(right, tree.z_left, z_end)
            r_left = _where(right, tree.r_left, r_end)
            grad_left = _where(right, tree.grad_left, grad_end)
            z_right = _where(right, z_end, tree.z_right)
            r_right = _where(right, r_end, tree.r_right)
            grad_right = _where(right, grad_end, tree.grad_right)

            # Biased progressive sampling between the old tree and the new
            # subtree.
            valid = ~(sub_turning | sub_diverging)
            accept_new = valid & (
                u_accept < torch.exp(torch.clamp_max(log_sum_w - tree.log_sum_weight, 0.0)))
            total_sum_r = tree.sum_r + sum_r
            new = _TreeState(
                z_left=z_left, r_left=r_left, grad_left=grad_left,
                z_right=z_right, r_right=r_right, grad_right=grad_right,
                z_proposal=_where(accept_new, z_prop, tree.z_proposal),
                lp_proposal=torch.where(accept_new, lp_prop, tree.lp_proposal),
                grad_proposal=_where(accept_new, grad_prop, tree.grad_proposal),
                log_sum_weight=torch.logaddexp(
                    tree.log_sum_weight, torch.where(valid, log_sum_w, -torch.inf)),
                sum_r=total_sum_r,
                depth=tree.depth + 1,
                turning=sub_turning | _is_turning(r_left, r_right, total_sum_r, inv_mass),
                diverging=sub_diverging,
                sum_accept=tree.sum_accept + sum_acc,
                num_steps=tree.num_steps + steps_done,
            )
            tree = _TreeState(*(_where(active, a, b) for a, b in zip(new, tree)))
            active = active & ~tree.turning & ~tree.diverging

        new_state = HMCState(z=tree.z_proposal, log_prob=tree.lp_proposal,
                             grad=tree.grad_proposal)
        accept_prob = tree.sum_accept / torch.clamp_min(tree.num_steps.to(energy0.dtype), 1.0)
        info = HMCInfo(
            accept_prob=accept_prob,
            # Multinomial NUTS has no single Metropolis accept; "accepted"
            # reports whether the transition moved off the initial point.
            accepted=torch.any(tree.z_proposal != z0, dim=-1),
            energy=-tree.lp_proposal,
            num_steps=tree.num_steps,
            diverging=tree.diverging,
        )
        return new_state, info

    return init_fn, step_fn


# ---------------------------------------------------------------------------
# Warmup: dual averaging + diagonal mass adaptation (windowed)
# ---------------------------------------------------------------------------


class DualAveragingState(NamedTuple):
    log_step: torch.Tensor
    log_step_avg: torch.Tensor
    grad_avg: torch.Tensor
    t: torch.Tensor
    mu: torch.Tensor


def _da_init(step_size: torch.Tensor) -> DualAveragingState:
    log_step = torch.log(step_size)
    return DualAveragingState(
        log_step=log_step,
        log_step_avg=log_step,
        grad_avg=torch.zeros_like(step_size),
        t=torch.zeros_like(step_size),
        mu=torch.log(10.0 * step_size),
    )


def _da_update(state: DualAveragingState, accept_prob, target=0.8) -> DualAveragingState:
    t = state.t + 1.0
    eta = 1.0 / (t + 10.0)
    grad_avg = (1.0 - eta) * state.grad_avg + eta * (target - accept_prob)
    log_step = state.mu - grad_avg * torch.sqrt(t) / 0.05
    weight = t**-0.75
    log_step_avg = weight * log_step + (1.0 - weight) * state.log_step_avg
    return DualAveragingState(log_step=log_step, log_step_avg=log_step_avg, grad_avg=grad_avg,
                              t=t, mu=state.mu)


class WarmupInfo(NamedTuple):
    """Warmup diagnostics returned by :func:`window_adaptation`."""

    divergences_per_window: torch.Tensor
    """Divergent-transition counts, one entry per adaptation window
    (initial fast buffer, each expanding slow window, final fast buffer)."""

    final_accept: torch.Tensor
    """Cross-chain mean accept-stat over the final fast buffer — should
    land near ``target_accept`` when adaptation succeeded."""


def _warmup_schedule(num_warmup: int) -> tuple[int, list[int], int]:
    """Expanding ("slow") mass-window schedule over the warmup.

    An initial fast buffer that adapts only the step size while chains find
    the typical set, a series of doubling covariance-estimation windows
    (25, 50, 100, ... steps), and a terminal fast buffer that
    re-equilibrates the step size against the final mass matrix. Returns
    ``(init_buffer, switch_steps, term_buffer)`` where ``switch_steps`` are
    the step indices *after which* the mass matrix updates.
    """
    init_buffer, term_buffer, base = 75, 50, 25
    if init_buffer + base + term_buffer > num_warmup:
        # Short warmup: shrink the buffers proportionally, keep >= 1 window.
        init_buffer = max(1, int(0.15 * num_warmup))
        term_buffer = max(1, int(0.1 * num_warmup))
        base = num_warmup - init_buffer - term_buffer
        if base < 1:
            return num_warmup, [], 0
    switch_steps = []
    start, size = init_buffer, base
    while True:
        # Absorb the remainder into the last window when doubling again
        # would overrun the terminal buffer.
        if start + 3 * size > num_warmup - term_buffer:
            size = num_warmup - term_buffer - start
        switch_steps.append(start + size - 1)
        start += size
        if start >= num_warmup - term_buffer:
            break
        size *= 2
    return init_buffer, switch_steps, term_buffer


@pinned
def find_initial_step_size(
    log_prob_fn: Callable[[torch.Tensor], torch.Tensor],
    states: HMCState,
    generator: torch.Generator,
    *,
    initial: float = 1.0,
    max_doublings: int = 20,
) -> torch.Tensor:
    """A reasonable starting step size (Hoffman & Gelman, Algorithm 4).

    Doubles or halves the step until the cross-chain mean accept
    probability of a single leapfrog step (unit mass, one momentum draw
    per chain from ``generator``) crosses 1/2. ``log_prob_fn`` is the log
    density of one flat position; ``states`` carry a leading chain axis.
    """
    value_and_grad = _value_and_grad(log_prob_fn)
    z, lp, grad = states
    r0 = _randn(z.shape, generator, z)
    kinetic0 = 0.5 * torch.sum(r0 * r0, dim=-1)

    def mean_accept(eps):
        _, r1, lp1, _ = _leapfrog(value_and_grad, z, r0, grad, eps, 1.0)
        delta = (lp1 - 0.5 * torch.sum(r1 * r1, dim=-1)) - (lp - kinetic0)
        delta = torch.where(torch.isnan(delta), -torch.inf, delta)
        return float(torch.mean(torch.exp(torch.clamp_max(delta, 0.0))))

    eps = torch.tensor(initial, dtype=z.dtype, device=z.device)
    direction = 1.0 if mean_accept(eps) > 0.5 else -1.0
    for _ in range(max_doublings):
        eps = eps * 2.0**direction
        p = mean_accept(eps)
        if (p <= 0.5) if direction > 0 else (p >= 0.5):
            break
    return eps


def window_adaptation(
    step_fn,
    *,
    num_warmup: int,
    target_accept: float = 0.8,
    initial_step_size: float = 0.1,
    axis=None,
    step_kwargs_fn=None,
):
    """Warmup: dual-averaged step size + staged diagonal mass adaptation.

    Mass estimation runs over expanding (doubling) windows; at each window
    boundary the regularized Welford variance becomes the new inverse mass,
    the estimator resets, and step-size adaptation re-anchors at the
    current step size, so early, badly conditioned exploration never
    contaminates the final metric. All chains adapt one step size and one
    mass matrix: the accept statistic and the position moments are averaged
    over the chain axis. ``axis``, the JAX package's mesh axis, is here a
    process group whose ranks hold the chains in blocks, in rank order
    (``parallel.run_mcmc_sharded``): each reduction then gathers every
    rank's chains and reduces them in global chain order, as one process
    holding all the chains would.

    Returns ``run(seed, states, step_size=None) -> (states, step_size,
    inv_mass, info)``, where ``states`` carry a leading chain axis, step
    ``k`` draws from the stream ``(seed, warmup, k)`` and ``info`` is a
    :class:`WarmupInfo`; ``run.init``, ``run.body(carry, step, generator)``
    and ``run.finish`` are its parts, for a driver that runs the steps
    itself. ``step_kwargs_fn``, when given, maps the step index to extra
    keyword arguments for ``step_fn`` (e.g. an annealed NUTS
    ``depth_cap``).
    """
    init_buffer, switch_steps, term_buffer = _warmup_schedule(num_warmup)
    num_windows = len(switch_steps) + 2
    # Window id of a step: 0 = init buffer, 1..k = slow windows, k+1 = term.
    starts = [init_buffer] + [s + 1 for s in switch_steps]

    def all_chains(x):
        if axis is None:
            return x
        from tinygp_tpu_torch.parallel.mesh import gather

        return gather(x, axis)

    def init(states: HMCState, step_size=None):
        z = states.z
        dim = z.shape[-1]
        if step_size is None:
            step_size = initial_step_size
        step_size = torch.as_tensor(step_size, dtype=z.dtype, device=z.device)
        zeros = z.new_zeros(dim)
        return (
            states,
            _da_init(step_size),
            z.new_ones(dim),
            zeros,
            zeros,
            z.new_zeros(()),
            z.new_zeros(num_windows),  # divergence count per window
            z.new_zeros(2),  # (sum accept, count) over the terminal buffer
        )

    def finish(carry):
        states, da, inv_mass, _m, _m2, _n, div, acc = carry
        info = WarmupInfo(divergences_per_window=div,
                          final_accept=acc[0] / torch.clamp_min(acc[1], 1.0))
        return states, torch.exp(da.log_step_avg), inv_mass, info

    def body(carry, step: int, generator: torch.Generator):
        states, da, inv_mass, wmean, wm2, wn, div, acc = carry
        step_size = torch.exp(da.log_step)
        extra = {} if step_kwargs_fn is None else step_kwargs_fn(step)
        states, infos = step_fn(generator, states, step_size, inv_mass, **extra)
        accept = torch.mean(all_chains(infos.accept_prob))
        da = _da_update(da, accept, target=target_accept)

        widx = sum(step >= s for s in starts)
        div = div + torch.nn.functional.one_hot(
            torch.tensor(widx, device=div.device), num_windows
        ).to(div.dtype) * torch.sum(all_chains(infos.diverging)).to(div.dtype)
        if step >= num_warmup - term_buffer:
            acc = acc + torch.stack([accept, torch.ones_like(accept)])

        if init_buffer <= step < num_warmup - term_buffer:
            n = wn + 1.0
            z = all_chains(states.z)
            delta = z - wmean[None, :]
            wmean_new = wmean + torch.mean(delta, dim=0) / n
            wm2 = wm2 + torch.mean(delta * (z - wmean_new[None, :]), dim=0)
            wmean, wn = wmean_new, n

        if step in switch_steps:
            # Window boundary: switch in the regularized variance estimate,
            # restart the estimator, re-anchor step-size adaptation. The
            # shrinkage toward unit scale at low counts (n/(n+5)) keeps tiny
            # windows from producing a wild metric.
            var = wm2 / torch.clamp_min(wn, 1.0)
            var = (wn / (wn + 5.0)) * var + 1e-3 * (5.0 / (wn + 5.0))
            inv_mass = torch.where(torch.isfinite(var) & (var > 0), var, 1.0)
            wmean, wm2, wn = torch.zeros_like(wmean), torch.zeros_like(wm2), torch.zeros_like(wn)
            da = _da_init(torch.exp(da.log_step))
        return (states, da, inv_mass, wmean, wm2, wn, div, acc)

    def run(seed: int, states: HMCState, step_size=None):
        carry = init(states, step_size)
        for step in range(num_warmup):
            carry = body(carry, step, _generator(seed, _WARMUP, step, states.z.device))
        return finish(carry)

    run.init = init
    run.body = body
    run.finish = finish
    return run


def _mcmc_programs(
    log_prob_fn,
    init_params,
    num_warmup,
    sampler,
    max_tree_depth,
    num_leapfrog,
    target_accept,
    warmup_depth_cap,
    axis=None,
):
    """Everything one MCMC configuration needs: the position's ravel and
    unravel, the flat log density, the transition and the warmup. The JAX
    package caches these per configuration to reuse its compiled programs;
    the port runs eagerly and has nothing to cache."""
    ravel, unravel, dim = _ravel_spec(init_params)

    def flat_log_prob(z):
        return log_prob_fn(unravel(z))

    if sampler == "nuts":
        init_fn, step_fn = nuts(flat_log_prob, max_tree_depth=max_tree_depth)
    elif sampler == "hmc":
        init_fn, step_fn = hmc(flat_log_prob, num_leapfrog=num_leapfrog)
    else:
        raise ValueError(f"unknown sampler: {sampler}")

    step_kwargs_fn = None
    if sampler == "nuts" and warmup_depth_cap is not None:
        init_buffer = _warmup_schedule(num_warmup)[0]
        cap = min(int(warmup_depth_cap), max_tree_depth)

        def step_kwargs_fn(step):
            # Shallow trees while chains walk toward the typical set with an
            # untuned step size (the initial fast buffer); full depth once
            # mass adaptation starts.
            return {"depth_cap": cap if step < init_buffer else max_tree_depth}

    adapt = window_adaptation(step_fn, num_warmup=num_warmup, target_accept=target_accept,
                              axis=axis, step_kwargs_fn=step_kwargs_fn)
    return {
        "ravel": ravel,
        "unravel": unravel,
        "dim": dim,
        "flat_log_prob": flat_log_prob,
        "init_fn": init_fn,
        "step_fn": step_fn,
        "adapt": adapt,
    }


@pinned
def run_mcmc(
    seed: int,
    log_prob_fn: Callable[[Any], torch.Tensor],
    init_params: Any,
    *,
    num_chains: int = 4,
    num_warmup: int = 500,
    num_samples: int = 1000,
    sampler: str = "nuts",
    max_tree_depth: int = 8,
    num_leapfrog: int = 32,
    target_accept: float = 0.8,
    initial_step_size: float | None = 0.1,
    jitter_init: float = 1.0,
    steps_per_dispatch: int | None = 50,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 1,
    warmup_depth_cap: int | None = 4,
    device: Any = None,
) -> tuple[Any, HMCInfo]:
    """End-to-end many-chain MCMC over a pytree-valued posterior.

    Args:
        seed: The run's seed (the JAX package takes a PRNG key); step ``k``
            of each phase draws from a generator seeded with ``(seed,
            phase, k)``.
        log_prob_fn: Log density of a *single* pytree position.
        init_params: An example position pytree (dicts, lists and tuples of
            tensors; chains are initialized by jittering it).
        num_chains: Number of chains, run together on one chain axis.
        sampler: ``"nuts"`` or ``"hmc"``.
        steps_per_dispatch: Run the warmup and sampling loops in chunks of
            at most this many transitions (``None``: one chunk per phase),
            with a checkpoint hook between chunks; the results are bit for
            bit the same whatever the chunking.
        checkpoint_path: If set, save the full sampler state (phase, step,
            chain states, adaptation state, collected samples) to this
            ``.npz`` after every ``checkpoint_every`` chunks, and, when the
            file already exists, RESUME from it instead of starting over.
        checkpoint_every: Chunks between checkpoint writes.
        warmup_depth_cap: NUTS only: cap the tree depth at this value
            during the initial fast warmup buffer (default 4). ``None``
            disables the anneal.
        device: Where the chains run; ``None`` is the card (and raises
            where there is none), ``"cpu"`` the plain path. The log density
            must compute on the same device.

    Returns:
        ``(samples, info)`` where ``samples`` has leading dims
        ``(num_samples, num_chains)`` on every leaf and ``info`` is an
        :class:`HMCInfo` of ``(num_samples, num_chains)`` tensors.
    """
    device = resolve_device(device)
    programs = _mcmc_programs(log_prob_fn, init_params, num_warmup, sampler, max_tree_depth,
                              num_leapfrog, target_accept, warmup_depth_cap)
    return _run_chains(seed, programs, init_params, num_chains=num_chains,
                       num_warmup=num_warmup, num_samples=num_samples,
                       initial_step_size=initial_step_size, jitter_init=jitter_init,
                       steps_per_dispatch=steps_per_dispatch, checkpoint_path=checkpoint_path,
                       checkpoint_every=checkpoint_every, device=device)


def _run_chains(
    seed,
    programs,
    init_params,
    *,
    num_chains,
    num_warmup,
    num_samples,
    initial_step_size,
    jitter_init,
    steps_per_dispatch,
    checkpoint_path,
    checkpoint_every,
    device,
    rows=None,
):
    """:func:`run_mcmc` after its arguments are resolved. ``rows``,
    ``(start, stop)``, runs only those of the ``num_chains`` chains, with
    their rows of every draw (:class:`_Rows`)."""
    unravel, dim, adapt, step_fn = (programs[k] for k in ("unravel", "dim", "adapt", "step_fn"))
    start, stop = (0, num_chains) if rows is None else rows

    def stream(phase, step):
        generator = _generator(seed, phase, step, device)
        return generator if rows is None else _Rows(generator, num_chains, start)

    z0 = programs["ravel"](init_params).to(device)
    if not z0.is_floating_point():
        z0 = z0.to(torch.get_default_dtype())
    jitter = _randn((stop - start, dim), stream(_INIT, 0), z0)
    states = programs["init_fn"](z0[None, :] + jitter_init * jitter)

    if initial_step_size is None:
        # Start dual averaging within a factor of two of a workable step.
        initial_step_size = find_initial_step_size(
            programs["flat_log_prob"], states, stream(_SEARCH, 0))

    def zeros(dtype):
        return torch.zeros(num_samples, stop - start, dtype=dtype, device=device)

    run_state = {
        "phase": np.zeros((), np.int32),  # 0 = warmup, 1 = sampling
        "step": np.zeros((), np.int32),
        "warm": adapt.init(states, initial_step_size),
        "states": states,
        "step_size": z0.new_zeros(()),
        "inv_mass": z0.new_ones(dim),
        "zs": z0.new_zeros(num_samples, stop - start, dim),
        "info": HMCInfo(accept_prob=zeros(z0.dtype), accepted=zeros(torch.bool),
                        energy=zeros(z0.dtype), num_steps=zeros(torch.int32),
                        diverging=zeros(torch.bool)),
    }
    if checkpoint_path is not None and os.path.exists(checkpoint_path):
        run_state = checkpoint.load_pytree(checkpoint_path, run_state)

    chunks = 0

    def maybe_checkpoint(force=False):
        nonlocal chunks
        chunks += 1
        if checkpoint_path is not None and (force or chunks % checkpoint_every == 0):
            checkpoint.save_pytree(checkpoint_path, run_state)

    while int(run_state["phase"]) == 0 and int(run_state["step"]) < num_warmup:
        step = int(run_state["step"])
        carry = run_state["warm"]
        for k in range(step, min(step + (steps_per_dispatch or num_warmup), num_warmup)):
            carry = adapt.body(carry, k, stream(_WARMUP, k))
        run_state["warm"] = carry
        run_state["step"] = np.asarray(k + 1, np.int32)
        maybe_checkpoint()

    if int(run_state["phase"]) == 0:
        states, step_size, inv_mass, _warm_info = adapt.finish(run_state["warm"])
        run_state.update(phase=np.ones((), np.int32), step=np.zeros((), np.int32),
                         states=states, step_size=step_size, inv_mass=inv_mass)
        maybe_checkpoint(force=True)

    states, step_size, inv_mass = (run_state[k] for k in ("states", "step_size", "inv_mass"))
    while int(run_state["step"]) < num_samples:
        step = int(run_state["step"])
        for k in range(step, min(step + (steps_per_dispatch or num_samples), num_samples)):
            states, info = step_fn(stream(_SAMPLE, k), states, step_size, inv_mass)
            run_state["zs"][k] = states.z
            for name, value in zip(HMCInfo._fields, info):
                getattr(run_state["info"], name)[k] = value
        run_state["states"] = states
        run_state["step"] = np.asarray(k + 1, np.int32)
        maybe_checkpoint()

    if checkpoint_path is not None:
        checkpoint.save_pytree(checkpoint_path, run_state)
    return unravel(run_state["zs"]), run_state["info"]
