"""MCMC convergence diagnostics: split R-hat and effective sample size.

Counterpart of ``tinygp_tpu/samplers/diagnostics.py``, with its
conventions: *split* R-hat (each chain halved, so that drift within a chain
registers as disagreement) and Geyer's initial monotone sequence ESS. As
there, the autocovariances are one ``(t, t)`` product of the centred draws
and per-lag sums of its diagonals; here the sums are read through a
strided view of the padded product, in a fixed order.

Every function takes a ``(num_draws, num_chains)`` tensor or array (the
layout :func:`~tinygp_tpu_torch.samplers.run_mcmc` gives each leaf) and
returns tensors; :func:`summary` takes a pytree of them.
"""

from __future__ import annotations

__all__ = ["potential_scale_reduction", "effective_sample_size", "summary"]

from typing import Any

import torch

from tinygp_tpu_torch.helpers import as_hyper, pinned
from tinygp_tpu_torch.utils.tree import tree_flatten_with_path


def _split_chains(x: torch.Tensor) -> torch.Tensor:
    """(draws, chains) -> (draws//2, 2*chains), dropping an odd draw."""
    t = (x.shape[0] // 2) * 2
    return torch.cat([x[: t // 2], x[t // 2 : t]], dim=1)


def potential_scale_reduction(x: Any) -> torch.Tensor:
    """Split R-hat of one scalar quantity, shape ``(draws, chains)``.

    Values near 1 indicate the chains agree; > ~1.01 is the conventional
    flag for non-convergence.
    """
    x = _split_chains(as_hyper(x))
    t = x.shape[0]
    w = torch.mean(torch.var(x, dim=0, correction=1))
    b = t * torch.var(torch.mean(x, dim=0), correction=1)
    var_plus = (t - 1) / t * w + b / t
    return torch.sqrt(var_plus / w)


def _diagonal_sums(P: torch.Tensor) -> torch.Tensor:
    """``sum_i P[i, i + k]`` for k = 0 .. t - 1: row i of the padded
    ``(t, 2t)`` matrix read from its diagonal entry on."""
    t = P.shape[0]
    padded = torch.cat([P, P.new_zeros(t, t)], dim=1).reshape(-1)
    return padded.as_strided((t, t), (2 * t + 1, 1)).sum(dim=0)


@pinned
def _mean_autocovariance(x: torch.Tensor) -> torch.Tensor:
    """Chain-averaged autocovariance at all lags; x (t, c) -> (t,), with
    the biased (1/t) normalization the ESS estimator expects: the
    chain-mean lag products are the ``(t, t)`` Gram matrix ``xc xc^T / c``,
    averaged over the pairs of each lag |i - j| (both triangles)."""
    t = x.shape[0]
    xc = x - torch.mean(x, dim=0, keepdim=True)
    P = (xc @ xc.T) / x.shape[1]
    lags = torch.arange(t, device=x.device)
    sums = _diagonal_sums(P) + _diagonal_sums(P.T.contiguous())
    sums[0] = sums[0] / 2
    counts = torch.where(lags == 0, t, 2 * (t - lags)).to(x.dtype)
    return sums / counts * ((t - lags).to(x.dtype) / t)


def effective_sample_size(x: Any) -> torch.Tensor:
    """ESS of one scalar quantity, shape ``(draws, chains)``.

    Geyer's initial monotone sequence over paired autocorrelations,
    computed from the multi-chain variance estimate (so between-chain
    disagreement deflates the answer, as it inflates R-hat).
    """
    x = _split_chains(as_hyper(x))
    t, c = x.shape
    w = torch.mean(torch.var(x, dim=0, correction=1))
    b_over_t = torch.var(torch.mean(x, dim=0), correction=1)
    var_plus = (t - 1) / t * w + b_over_t

    rho = 1.0 - (w - _mean_autocovariance(x)) / var_plus  # rho[0] ~ 1

    # Pair consecutive lags (Geyer): p_k = rho_{2k} + rho_{2k+1}; keep
    # while positive, enforce monotone non-increase, then sum.
    t2 = t // 2
    pairs = rho[0 : 2 * t2 : 2] + rho[1 : 2 * t2 : 2]
    pairs = pairs * torch.cumprod((pairs > 0.0).to(x.dtype), dim=0)
    pairs = torch.clamp_min(torch.cummin(pairs, dim=0).values, 0.0)
    tau = -1.0 + 2.0 * torch.sum(pairs)
    ess = (t * c) / torch.clamp_min(tau, 1.0 / (t * c))
    return torch.clamp_max(ess, float(t * c))


def summary(samples: Any) -> dict[str, dict[str, torch.Tensor]]:
    """Per-leaf diagnostics for a ``run_mcmc`` result pytree.

    Returns ``{path: {"rhat": ..., "ess": ..., "mean": ..., "sd": ...}}``
    with one entry per flattened scalar dimension of each leaf; ``path`` is
    the leaf's key as the JAX package writes it (``"['log_amp']"``).
    """
    out: dict[str, dict[str, torch.Tensor]] = {}
    leaves, _ = tree_flatten_with_path(samples)
    for name, leaf in leaves:
        arr = as_hyper(leaf)
        arr = arr.reshape(arr.shape[0], arr.shape[1], -1)
        cols = [arr[:, :, k] for k in range(arr.shape[2])]
        out[name] = {
            "rhat": torch.stack([potential_scale_reduction(x) for x in cols]),
            "ess": torch.stack([effective_sample_size(x) for x in cols]),
            "mean": torch.mean(arr, dim=(0, 1)),
            "sd": torch.std(arr, dim=(0, 1), correction=0),
        }
    return out
