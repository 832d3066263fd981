"""The chain-batched log density and its gradient, the samplers' inner
loop: ``torch.func.vmap(torch.func.grad_and_value(f))`` of a GP log density
on the port against ``jax.vmap(jax.value_and_grad(f))`` on the JAX package,
same inputs (float64 at the tolerance table's 5e-7, float32 at 5e-4), for
``benchmarks/nuts_throughput.py``'s SHO model, a 2-term celerite (m = 4)
and ``SHO + Matern52`` (m = 5); the plain chain-axis versions of B1r and B2
against a loop over the chains; and the once-differentiable rule."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinygp_tpu import GaussianProcess as JaxGP
from tinygp_tpu.kernels import quasisep as jq
from tinygp_tpu_torch import GaussianProcess
from tinygp_tpu_torch.kernels import quasisep as tq
from tinygp_tpu_torch.solvers.quasisep import cuda_loglik
from tinygp_tpu_torch.test_utils import random_qsm_operands

CHAINS, N = 8, 64
RTOL = {np.float64: 5e-7, np.float32: 5e-4}


def data(dtype):
    """``nuts_throughput.py``'s data at N = 64."""
    rng = np.random.default_rng(0)
    t = np.sort(rng.uniform(0, 10, N))
    y = np.sin(3 * t) * np.exp(-0.1 * t) + 0.3 * rng.normal(size=N)
    return t.astype(dtype), y.astype(dtype)


def kernel(q, ns, z):
    """The model's kernel from four log parameters, in either package
    (``q`` its quasisep module, ``ns`` its array namespace)."""
    a, b, c, d = (ns.exp(z[i]) for i in range(4))

    def k(v):  # a constant in the position's dtype
        return ns.asarray(v, dtype=z.dtype)

    return {
        "sho": lambda: a * q.SHO(omega=b, quality=c),
        "celerite2": lambda: (q.Celerite(a=a, b=k(0.1), c=b, d=k(1.0))
                              + q.Celerite(a=c, b=k(0.05), c=k(1.5), d=k(3.0))),
        "sho_matern52": lambda: a * q.SHO(omega=b, quality=k(3.0)) + c * q.Matern52(scale=k(2.5)),
    }


def log_densities(model, dtype):
    t, y = data(dtype)
    X, Y = jnp.asarray(t), jnp.asarray(y)
    Xt, Yt = torch.as_tensor(t), torch.as_tensor(y)

    def jlp(z):
        gp = JaxGP(kernel(jq, jnp, z)[model](), X, diag=jnp.exp(z[3]) + 0.09, assume_sorted=True)
        return gp.log_probability(Y) - 0.5 * jnp.sum(jnp.square(z))

    def tlp(z):
        gp = GaussianProcess(kernel(tq, torch, z)[model](), Xt, diag=torch.exp(z[3]) + 0.09,
                             assume_sorted=True, device="cpu")
        return gp.log_probability(Yt) - 0.5 * torch.sum(torch.square(z))

    return jlp, tlp


def positions(dtype):
    rng = np.random.default_rng(1)
    return (np.array([0.0, 1.0, 1.0, -2.0]) + 0.2 * rng.normal(size=(CHAINS, 4))).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("model", ["sho", "celerite2"])
def test_batched_value_and_grad_matches_jax(model, dtype):
    check_batched_value_and_grad(model, dtype)


def check_batched_value_and_grad(model, dtype):
    jlp, tlp = log_densities(model, dtype)
    z = positions(dtype)
    want_v, want_g = jax.vmap(jax.value_and_grad(jlp))(jnp.asarray(z))
    before = dict(cuda_loglik.LAUNCHES_CHAINS)
    got_g, got_v = torch.func.vmap(torch.func.grad_and_value(tlp))(torch.as_tensor(z))
    assert cuda_loglik.LAUNCHES_CHAINS == before  # the CPU launches nothing
    assert got_v.shape == (CHAINS,) and got_g.shape == (CHAINS, 4)
    assert got_v.dtype == got_g.dtype == torch.as_tensor(z).dtype
    rtol = RTOL[dtype]
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=rtol)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=rtol,
                               atol=rtol * float(np.abs(want_g).max()))
    # The value alone (kernel B1's route) under vmap without a gradient.
    value = torch.func.vmap(tlp)(torch.as_tensor(z))
    np.testing.assert_allclose(value.numpy(), got_v.numpy(), rtol=rtol)


def chain_operands(chains, m, n, shared_y):
    per = [random_qsm_operands(m, n, seed=7 * c + m) for c in range(chains)]
    ops = [torch.as_tensor(np.stack(x)) for x in zip(*per)]
    if shared_y:
        ops[4] = ops[4][0].clone()
    return ops


@pytest.mark.parametrize("shared_y", [False, True], ids=["y", "shared-y"])
@pytest.mark.parametrize("m,n", [(1, 50), (2, 64), (3, 333), (4, 512), (5, 40), (2, 600)])
def test_plain_chain_versions_match_a_loop(m, n, shared_y):
    """The plain chain-axis B1r and B2 (the sequential recurrences up to
    N = 512, the plain scans mapped with vmap above) against the plain
    versions called chain by chain, and the wrappers on CPU tensors."""
    chains = 3
    d, ps, qs, as_, y = chain_operands(chains, m, n, shared_y)
    res = cuda_loglik.plain_loglik_terms_res_chains(d, ps, qs, as_, y)
    assert [tuple(x.shape) for x in res] == [(chains,), (chains,), (chains, m * m, n),
                                             (chains, m, n), (chains, n)]
    qbar = torch.linspace(0.5, 1.5, chains, dtype=torch.float64)
    lbar = torch.tensor(-1.0, dtype=torch.float64)
    grads = cuda_loglik.plain_loglik_bwd_chains(ps, qs, as_, y, *res[2:], qbar, lbar)
    assert [tuple(x.shape) for x in grads] == [(chains, n), (chains, m, n), (chains, m, n),
                                               (chains, m * m, n), (chains, n)]
    for c in range(chains):
        yc = y if shared_y else y[c]
        want = cuda_loglik.plain_loglik_terms_res(d[c], ps[c], qs[c], as_[c], yc)
        for g, w in zip(res, want):
            torch.testing.assert_close(g[c], w, rtol=1e-12, atol=1e-12 * float(w.abs().max()))
        want = cuda_loglik.plain_loglik_bwd(ps[c], qs[c], as_[c], yc, *(x[c] for x in res[2:]),
                                            qbar[c], lbar)
        for g, w in zip(grads, want):
            torch.testing.assert_close(g[c], w, rtol=1e-12, atol=1e-12 * float(w.abs().max()))
    same = cuda_loglik.fused_loglik_res_chains(d, ps, qs, as_, y)
    assert all(torch.equal(a, b) for a, b in zip(same, res))
    assert all(torch.equal(a, b) for a, b in zip(cuda_loglik.fused_loglik_terms_chains(
        d, ps, qs, as_, y), res[:2]))
    same = cuda_loglik.fused_loglik_bwd_chains(ps, qs, as_, y, *res[2:], qbar, lbar)
    assert all(torch.equal(a, b) for a, b in zip(same, grads))
