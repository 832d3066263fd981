"""CARMA on the port against the JAX package, in float64.

- The roots (p = 1, 2 with real and with complex roots, 3 and 5), the
  autocovariance coefficients, ``carma_quads2poly`` and
  ``carma_poly2quads``. Above p = 2 the roots come from 64 Durand-Kerner
  steps, and the order within a conjugate pair, whose real parts differ by
  rounding alone, is not the same in the two packages: those roots are
  compared as sets.
- At p <= 2 (``tests/test_kernels/test_quasisep.py:28``'s case and
  ``test_carma_from_quads``'s among them) the state-space quadruple,
  ``to_stacked_ssm``, ``evaluate`` and a GP's ``log_probability`` with its
  gradient in ``alpha`` and ``beta``.
- Above p = 2 the two packages' kernels differ: the JAX package's
  observation model gives a conjugate pair the components of the wrong
  roots (ROADMAP.md, "Found in the reference"). The port's kernel is held
  against the autocovariance that the JAX package's own roots and
  coefficients give (Kelly et al. 2014, Eq. 4), and its transitions
  against ``expm(F^T dt)``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from tinygp_tpu import GaussianProcess as JaxGP
from tinygp_tpu.kernels import quasisep as jq
from tinygp_tpu_torch import GaussianProcess
from tinygp_tpu_torch.kernels import quasisep as tq
from tinygp_tpu_torch.test_utils import assert_allclose


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The port's side here is many small tensor operations a step; with
    several test workers on one host, intra-op threads only contend for
    the cores (a full-rank fit ran eight times slower so)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# (alpha, beta) by name; the first four take the closed forms.
CASES = {
    "p1": ([0.7], [1.3]),
    "p2_real": ([0.5, 2.0], [1.0, 0.3]),
    "p2_complex": ([1.2, 1.4], [1.7, 0.1]),
    "test_quasisep_28": ([1.4, 2.3], [1.0, 0.1]),
}
# (alpha_quads, beta_quads, beta_mult) by name: test_carma_from_quads's
# case, and two stationary processes with a conjugate pair after real roots
# or before them, whose pairs' own celerite terms are positive.
QUADS = {
    "from_quads_p2": ([1.1, 1.2], [0.9], [0.3]),
    "from_quads_p3": ([1.1, 1.2, 0.5], [0.2], [1.0]),
    "from_quads_p5": ([0.66, 1.15, 1.84, 1.9, 1.24], [1.67, 1.74, 1.01], [1.0]),
}


def kernels(name):
    """The JAX and the port's kernel for a case of CASES or QUADS."""
    if name in CASES:
        alpha, beta = (np.array(v) for v in CASES[name])
        return jq.CARMA(alpha, beta), tq.CARMA(alpha, beta)
    args = [np.array(v) for v in QUADS[name]]
    return jq.CARMA.from_quads(*(jnp.asarray(a) for a in args)), tq.CARMA.from_quads(*args)


def as_set(roots):
    """Complex roots in a canonical order: by real part, then imaginary,
    the real parts rounded past the pair's rounding."""
    roots = np.asarray(roots)
    return roots[np.lexsort((roots.imag, np.round(roots.real, 10)))]


def coords(n=40, seed=84):
    return np.sort(np.random.default_rng(seed).uniform(0, 8, n))


@pytest.mark.parametrize("name", sorted(CASES) + sorted(QUADS))
def test_roots_and_acvf_match_jax(name):
    jk, tk = kernels(name)
    assert_allclose(tk.alpha, jk.alpha)
    assert_allclose(tk.beta, jk.beta)
    poly = np.append(np.asarray(jk.alpha), 1.0)
    want, got = np.asarray(jq.carma_roots(jnp.asarray(poly))), tq.carma_roots(poly).numpy()
    if len(poly) <= 3:
        assert_allclose(got.real, want.real)
        assert_allclose(got.imag, want.imag)
        assert_allclose(tk.arroots_re, jk.arroots_re)
        assert_allclose(tk.arroots_im, jk.arroots_im)
    else:
        got, want = as_set(got), as_set(want)
        assert_allclose(got.real, want.real)
        assert_allclose(got.imag, want.imag)
    # The coefficients from the same roots, op for op.
    roots = np.asarray(jk.arroots)
    want = np.asarray(jq.carma_acvf(jnp.asarray(roots), jk.alpha, jk.beta))
    got = tq.carma_acvf(roots, np.asarray(jk.alpha), np.asarray(jk.beta)).numpy()
    assert_allclose(got.real, want.real)
    assert_allclose(got.imag, want.imag)


@pytest.mark.parametrize("quads", [[1.1, 1.2, 1.0], [0.9, 0.3], [1.1, 1.2, 0.5, 2.0],
                                   [0.66, 1.15, 1.84, 1.9, 1.24, 1.0]])
def test_quads2poly_matches_jax(quads):
    assert_allclose(tq.carma_quads2poly(np.array(quads)),
                    jq.carma_quads2poly(jnp.asarray(quads)))


@pytest.mark.parametrize("poly", [[0.7, 1.3], [1.2, 1.4, 1.0], [1.0, 2.5, 2.0], [0.27, 0.3]])
def test_poly2quads_matches_jax(poly):
    assert_allclose(tq.carma_poly2quads(np.array(poly)), jq.carma_poly2quads(jnp.asarray(poly)))


LOW_ORDERS = sorted(CASES) + ["from_quads_p2"]


@pytest.mark.parametrize("name", LOW_ORDERS)
def test_state_space_matches_jax(name):
    jk, tk = kernels(name)
    X = coords()
    assert_allclose(tk.design_matrix(), jk.design_matrix())
    assert_allclose(tk.stationary_covariance(), jk.stationary_covariance())
    assert_allclose(tk.observation_model(torch.tensor(0.3, dtype=torch.float64)),
                    jk.observation_model(0.3))
    assert_allclose(tk.transition_matrix(torch.tensor(0.1, dtype=torch.float64),
                                         torch.tensor(0.47, dtype=torch.float64)),
                    jk.transition_matrix(0.1, 0.47))
    for g, w in zip(tk.to_stacked_ssm(torch.as_tensor(X)), jk.to_stacked_ssm(jnp.asarray(X))):
        assert_allclose(g, w)
    assert_allclose(tk(torch.as_tensor(X), torch.as_tensor(X[::3])), jk(X, X[::3]))


@pytest.mark.parametrize("name", sorted(CASES) + sorted(QUADS))
def test_kernel_is_the_autocovariance(name):
    """The port's kernel against the sum of ``acf_k exp(r_k tau)`` over the
    JAX package's roots and coefficients, and each transition against
    ``expm(F^T dt)``."""
    jk, tk = kernels(name)
    tau = np.linspace(0.0, 6.0, 25)
    roots, acf = np.asarray(jk.arroots), np.asarray(jk.acf)
    want = np.real(np.sum(acf[:, None] * np.exp(roots[:, None] * tau[None, :]), axis=0))
    got = tk.evaluate(torch.zeros((), dtype=torch.float64), torch.as_tensor(tau))
    assert_allclose(got, want)
    F = tk.design_matrix().numpy()
    A = tk.transition_matrix(torch.tensor(0.1, dtype=torch.float64),
                             torch.tensor(0.47, dtype=torch.float64)).numpy()
    np.testing.assert_allclose(A, scipy.linalg.expm(F.T * 0.37), atol=1e-12)


@pytest.mark.parametrize("name", ["p2_complex", "test_quasisep_28"])
def test_log_probability_and_gradient_match_jax(name):
    alpha, beta = (np.array(v) for v in CASES[name])
    rng = np.random.default_rng(3)
    X = np.sort(rng.uniform(0, 20, 200))
    y = rng.normal(size=200)

    def jax_lp(a, b):
        gp = JaxGP(jq.CARMA(a, b), jnp.asarray(X), diag=0.1, assume_sorted=True)
        return gp.log_probability(jnp.asarray(y))

    want, want_grad = jax.jit(jax.value_and_grad(jax_lp, argnums=(0, 1)))(
        jnp.asarray(alpha), jnp.asarray(beta))
    a = torch.as_tensor(alpha).requires_grad_(True)
    b = torch.as_tensor(beta).requires_grad_(True)
    gp = GaussianProcess(tq.CARMA(a, b), torch.as_tensor(X), diag=0.1, assume_sorted=True,
                         device="cpu")
    got = gp.log_probability(torch.as_tensor(y))
    got_grad = torch.autograd.grad(got, (a, b))
    assert_allclose(got.detach(), want)
    for g, w in zip(got_grad, want_grad):
        assert_allclose(g, w)


def test_from_quads_p3_log_probability_matches_dense():
    """A p = 3 process's O(N) log-likelihood against a dense Cholesky of
    the same kernel, in float64."""
    _, tk = kernels("from_quads_p3")
    X = torch.as_tensor(coords(300, seed=5))
    y = torch.as_tensor(np.random.default_rng(6).normal(size=300))
    got = GaussianProcess(tk, X, diag=0.1, assume_sorted=True, device="cpu").log_probability(y)
    K = tk(X, X) + 0.1 * torch.eye(300, dtype=torch.float64)
    L = torch.linalg.cholesky(K)
    alpha = torch.linalg.solve_triangular(L, y[:, None], upper=False)[:, 0]
    want = -0.5 * alpha @ alpha - torch.log(torch.diagonal(L)).sum() - 150 * np.log(2 * np.pi)
    assert_allclose(got, want)
