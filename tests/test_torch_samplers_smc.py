"""Adaptive tempered SMC on the port against the JAX package.

- The helpers on the same inputs: the ESS to its last bits, the bisected
  temperature step exactly, and systematic resampling's indices for the
  JAX package's own uniform.
- ``tests/test_samplers/test_vi_smc.py``'s Gaussian case on the port, at
  its tolerances: the analytic posterior and evidence, the ladder, the
  acceptance and the weights.
- SMC on ``benchmarks/smc_vi_rate.py``'s SHO posterior at N = 64, both
  packages' ``run_smc`` from the same particles: their posterior moments
  and log evidence agree within Monte-Carlo error.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinygp_tpu import GaussianProcess as JaxGP
from tinygp_tpu.kernels import quasisep as jq
from tinygp_tpu.samplers import run_smc as jax_run_smc
from tinygp_tpu.samplers import smc as jsmc
from tinygp_tpu_torch import GaussianProcess
from tinygp_tpu_torch.kernels import quasisep as tq
from tinygp_tpu_torch.samplers import run_smc
from tinygp_tpu_torch.samplers import smc as tsmc


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The port's side here is many small tensor operations a step; with
    several test workers on one host, intra-op threads only contend for
    the cores (a full-rank fit ran eight times slower so)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def log_weights(seed, n=256):
    rng = np.random.default_rng(seed)
    lw = 3.0 * rng.normal(size=n)
    lw[rng.integers(0, n, 5)] = -np.inf
    return lw


@pytest.mark.parametrize("seed", [0, 1])
def test_ess_and_next_beta_match_jax(seed):
    lw = log_weights(seed)
    # The two logsumexps sum in different orders: the ESS agrees to its
    # last few bits, and the bisection's steps exactly.
    np.testing.assert_allclose(float(tsmc._ess(torch.as_tensor(lw))),
                               float(jsmc._ess(jnp.asarray(lw))), rtol=1e-14)
    jax_next_beta = jax.jit(jsmc._next_beta, static_argnums=2)
    for beta in (0.0, 0.3, 0.97):
        for target in (0.5, 0.9):
            want = jax_next_beta(jnp.asarray(lw), jnp.asarray(beta), target)
            got = tsmc._next_beta(torch.as_tensor(lw), torch.tensor(beta, dtype=torch.float64),
                                  target)
            assert float(got) == float(want), (beta, target)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_systematic_resample_matches_jax(seed):
    lw = log_weights(seed)
    key = jax.random.PRNGKey(seed)
    want = jsmc._systematic_resample(key, jnp.asarray(lw))
    u = torch.tensor(float(jax.random.uniform(key)), dtype=torch.float64)
    got = tsmc._systematic_indices(u, torch.as_tensor(lw))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


MU = np.array([1.0, -2.0])
SD = np.array([0.5, 1.5])


def test_smc_posterior_and_evidence():
    def log_prob(p):
        return -0.5 * torch.sum(torch.square((p["x"] - torch.as_tensor(MU)) / torch.as_tensor(SD)))

    def log_prior(p):
        return -0.5 * torch.sum(torch.square(p["x"]) / 16.0)

    g = torch.Generator().manual_seed(1)
    parts = {"x": 4.0 * torch.randn((2048, 2), generator=g, dtype=torch.float64)}
    out = run_smc(2, log_prior, log_prob, parts, device="cpu")
    x = out.particles["x"].numpy()

    post_var = 1.0 / (1.0 / 16.0 + 1.0 / SD**2)
    post_mean = post_var * MU / SD**2
    np.testing.assert_allclose(x.mean(0), post_mean, atol=0.15)
    np.testing.assert_allclose(x.std(0), np.sqrt(post_var), atol=0.15)
    var_sum = 16.0 + SD**2
    logZ = np.sum(-0.5 * (MU**2 / var_sum + np.log(var_sum / SD**2)))
    np.testing.assert_allclose(float(out.log_evidence), logZ, atol=0.15)
    k = int(out.num_stages)
    assert 1 <= k < 50
    betas = out.betas.numpy()
    assert betas[k - 1] == 1.0
    assert np.all(np.diff(betas[:k]) > 0)
    assert np.all(np.isnan(betas[k:]))
    accs = out.acceptance.numpy()
    assert np.all((accs[:k] >= 0) & (accs[:k] <= 1)) and np.all(np.isnan(accs[k:]))
    np.testing.assert_allclose(out.log_weights.numpy(), -np.log(2048.0), rtol=1e-6)


N, PARTICLES = 64, 512
INIT = {"log_amp": 0.0, "log_omega": 1.0, "log_q": 1.0}


def test_sho_smc_agrees_with_jax():
    """``smc_vi_rate.py``'s model (N(0, 1) priors on three log parameters,
    ``diag=0.09``) at N = 64 in float64, with 512 particles drawn once with
    numpy for both packages."""
    rng = np.random.default_rng(0)
    t = np.sort(rng.uniform(0, 10, N))
    y = np.sin(3 * t) * np.exp(-0.1 * t) + 0.3 * rng.normal(size=N)
    parts = {k: v + np.random.default_rng(5 + i).normal(size=PARTICLES)
             for i, (k, v) in enumerate(INIT.items())}

    def model(q, ns, GP, X, Y, **kw):
        def log_like(p):
            k = ns.exp(p["log_amp"]) * q.SHO(omega=ns.exp(p["log_omega"]),
                                               quality=ns.exp(p["log_q"]))
            return GP(k, X, diag=0.09, assume_sorted=True, **kw).log_probability(Y)

        def log_prior(p):
            return -0.5 * sum(ns.sum(ns.square(v)) for v in p.values())

        return log_prior, log_like

    want = jax_run_smc(jax.random.PRNGKey(0),
                       *model(jq, jnp, JaxGP, jnp.asarray(t), jnp.asarray(y)),
                       {k: jnp.asarray(v) for k, v in parts.items()})
    tsmc.EVALUATIONS = 0
    got = run_smc(0, *model(tq, torch, GaussianProcess, torch.as_tensor(t), torch.as_tensor(y),
                            device="cpu"),
                  {k: torch.as_tensor(v) for k, v in parts.items()}, device="cpu")
    k = int(got.num_stages)
    # Each stage evaluates the likelihood once and the tempered target once
    # before the moves and once a move.
    assert tsmc.EVALUATIONS == k * (2 + 5)
    assert np.all(np.diff(got.betas.numpy()[:k]) > 0) and got.betas[k - 1] == 1.0
    for name in INIT:
        a, b = np.asarray(want.particles[name]), got.particles[name].numpy()
        assert np.isfinite(b).all()
        # Monte-Carlo error of each mean: sd / sqrt(n), with n the target
        # ESS (half the particles), for each package.
        mcse = (a.std() + b.std()) / np.sqrt(PARTICLES / 2)
        assert abs(a.mean() - b.mean()) < 4 * mcse, (name, a.mean(), b.mean(), mcse)
        assert 0.7 < b.std() / a.std() < 1.4, (name, a.std(), b.std())
    assert abs(float(got.log_evidence) - float(want.log_evidence)) < 0.5
