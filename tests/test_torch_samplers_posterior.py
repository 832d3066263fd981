"""Many-chain NUTS on a GP hyperparameter posterior, the port against the
JAX package: ``benchmarks/nuts_throughput.py``'s SHO model at N = 64 in
float64, run by each package's ``run_mcmc`` from the same start; the two
draw different random streams (BASELINE.md:36), so their posterior
moments must agree within Monte-Carlo error."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tinygp_tpu import GaussianProcess as JaxGP
from tinygp_tpu.kernels import quasisep as jq
from tinygp_tpu.samplers import run_mcmc as jax_run_mcmc
from tinygp_tpu_torch import GaussianProcess
from tinygp_tpu_torch.kernels import quasisep as tq
from tinygp_tpu_torch.samplers import potential_scale_reduction, run_mcmc, summary

N, CHAINS = 64, 16
KW = dict(num_chains=CHAINS, num_warmup=60, num_samples=60, max_tree_depth=4, jitter_init=0.1,
          steps_per_dispatch=None)
INIT = {"log_amp": 0.0, "log_omega": 1.0, "log_q": 1.0, "log_jitter": -2.0}


def data():
    rng = np.random.default_rng(0)
    t = np.sort(rng.uniform(0, 10, N))
    return t, np.sin(3 * t) * np.exp(-0.1 * t) + 0.3 * rng.normal(size=N)


def model(q, ns, GP, X, Y, **kw):
    def log_prob(params):
        amp, omega, quality, jitter = (ns.exp(params[k]) for k in INIT)
        gp = GP(amp * q.SHO(omega=omega, quality=quality), X, diag=jitter + 0.09,
                assume_sorted=True, **kw)
        return gp.log_probability(Y) - 0.5 * sum(ns.sum(ns.square(v)) for v in params.values())

    return log_prob


def moments(samples):
    return {k: (float(np.mean(np.asarray(v))), float(np.std(np.asarray(v))))
            for k, v in samples.items()}


def test_sho_posterior_agrees_with_jax():
    t, y = data()
    jlp = model(jq, jnp, JaxGP, jnp.asarray(t), jnp.asarray(y))
    jsamples, _ = jax_run_mcmc(jax.random.PRNGKey(0), jlp,
                               {k: jnp.asarray(v) for k, v in INIT.items()}, **KW)
    tlp = model(tq, torch, GaussianProcess, torch.as_tensor(t), torch.as_tensor(y), device="cpu")
    tsamples, info = run_mcmc(0, tlp, {k: torch.tensor(v, dtype=torch.float64)
                                       for k, v in INIT.items()}, device="cpu", **KW)
    assert all(v.shape == (KW["num_samples"], CHAINS) for v in tsamples.values())
    assert torch.isfinite(info.accept_prob).all() and float(info.diverging.float().mean()) < 0.02
    want, got = moments(jsamples), moments(tsamples)
    for k in INIT:
        (mj, sj), (mt, st) = want[k], got[k]
        # Monte-Carlo error of each mean: sd / sqrt(ESS), conservatively
        # with one independent draw per chain.
        mcse = (sj + st) / np.sqrt(CHAINS)
        assert abs(mt - mj) < max(4 * mcse, 0.1), (k, mt, mj, st, sj)
        assert 0.7 < st / sj < 1.4, (k, st, sj)
        assert float(potential_scale_reduction(tsamples[k])) < 1.1
    assert set(summary(tsamples)) == {f"[{k!r}]" for k in INIT}
