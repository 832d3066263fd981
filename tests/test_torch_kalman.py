"""The Kalman oracle (``solvers/kalman.py``) against the JAX package's and
against the quasiseparable solver, on the CPU. Mirrors
``tests/test_solvers/test_kalman.py`` (its 2 tests, 5 cases) and adds the
gains and innovations, the gradient, and the oracle's refusals. Float64 at
the tolerance table's 5e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinygp_tpu as jt
from tinygp_tpu.kernels import quasisep as jq
from tinygp_tpu.solvers import kalman as jkalman
from tinygp_tpu_torch import GaussianProcess
from tinygp_tpu_torch.kernels import quasisep as tq
from tinygp_tpu_torch.noise import Banded, Diagonal
from tinygp_tpu_torch.solvers import KalmanSolver
from tinygp_tpu_torch.solvers import kalman as tkalman
from tinygp_tpu_torch.test_utils import assert_allclose


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """A loop over N of tiny products: with several test workers on one
    host, intra-op threads only contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def data():
    rng = np.random.default_rng(33)
    X = np.sort(rng.uniform(0, 10, 50))
    y = rng.normal(size=50)
    return X, y


KERNELS = {
    "m32": lambda q: q.Matern32(scale=1.5),
    "sho": lambda q: q.SHO(omega=1.2, quality=3.0),
    "exp": lambda q: q.Exp(scale=0.8, sigma=1.3),
    "sum": lambda q: q.Exp(scale=1.5) + q.Matern32(scale=2.0),
}


@pytest.mark.parametrize("name", list(KERNELS))
def test_kalman_matches_quasisep(name):
    X, y = data()
    kernel = KERNELS[name](tq)
    gp_k = GaussianProcess(kernel, X, diag=0.2, solver=KalmanSolver, device="cpu")
    gp_q = GaussianProcess(kernel, X, diag=0.2, device="cpu")
    assert_allclose(gp_k.log_probability(y), gp_q.log_probability(y))
    jgp = jt.GaussianProcess(KERNELS[name](jq), jnp.asarray(X), diag=0.2,
                             solver=jkalman.KalmanSolver)
    assert_allclose(gp_k.log_probability(y), jgp.log_probability(jnp.asarray(y)))
    # The filter's own outputs, the JAX solver's.
    for got, want in ((gp_k.solver.s, jgp.solver.s), (gp_k.solver.K, jgp.solver.K),
                      (gp_k.solver.solve_triangular(torch.as_tensor(y)),
                       jgp.solver.solve_triangular(jnp.asarray(y)))):
        assert_allclose(got, want)


def test_kalman_matches_direct_formula():
    """Hand-rolled MVN log-likelihood through the innovations decomposition."""
    X, y = data()
    kernel = tq.Matern32(scale=1.5)
    gp = GaussianProcess(kernel, X, diag=0.2, solver=KalmanSolver, device="cpu")

    K = kernel(torch.as_tensor(X), torch.as_tensor(X)).numpy() + 0.2 * np.eye(50)
    _, logdet = np.linalg.slogdet(K)
    expect = -0.5 * (y @ np.linalg.solve(K, y) + logdet + 50 * np.log(2 * np.pi))
    assert_allclose(gp.log_probability(y), expect)


def test_kalman_gradient_matches_jax():
    """The loop is plain autograd: its gradient in (sigma, scale) against
    ``jax.grad`` of the JAX oracle."""
    X, y = data()

    th = torch.tensor([1.3, 1.5], dtype=torch.float64, requires_grad=True)
    gp = GaussianProcess(tq.Matern32(scale=th[1], sigma=th[0]), X, diag=0.2,
                         solver=KalmanSolver, device="cpu")
    (got,) = torch.autograd.grad(gp.log_probability(y), th)

    def loss(th):
        return jt.GaussianProcess(jq.Matern32(scale=th[1], sigma=th[0]), jnp.asarray(X),
                                  diag=0.2, solver=jkalman.KalmanSolver
                                  ).log_probability(jnp.asarray(y))

    assert_allclose(got, jax.grad(loss)(jnp.asarray([1.3, 1.5])))


def test_kalman_gains_and_filter_against_jax():
    """The two recursions alone, on the same random state-space operands."""
    rng = np.random.default_rng(7)
    n, m = 30, 3
    Pinf = np.eye(m) + 0.1 * np.ones((m, m))
    A = 0.9 * np.eye(m) + 0.05 * rng.normal(size=(n, m, m))
    H = rng.normal(size=(n, m))
    diag = rng.uniform(0.1, 0.3, n)
    y = rng.normal(size=n)
    s, K = tkalman.kalman_gains(*(torch.as_tensor(v) for v in (Pinf, A, H, diag)))
    js, jK = jkalman.kalman_gains(Pinf, A, H, diag)
    assert_allclose(s, js)
    assert_allclose(K, jK)
    v = tkalman.kalman_filter(*(torch.as_tensor(x) for x in (A, H)), K, torch.as_tensor(y))
    assert_allclose(v, jkalman.kalman_filter(A, H, jK, y))


def test_kalman_refusals():
    """The oracle's types and checks are the JAX solver's: a state-space
    kernel, diagonal noise, no precomputed covariance, and only the
    marginal-likelihood path."""
    from tinygp_tpu_torch import kernels

    X, y = data()
    Xt = torch.as_tensor(X)
    noise = Diagonal(torch.full((50,), 0.2, dtype=torch.float64))
    with pytest.raises(TypeError, match="state-space"):
        KalmanSolver(kernels.Matern32(scale=1.5), Xt, noise)
    with pytest.raises(TypeError, match="diagonal"):
        KalmanSolver(tq.Matern32(scale=1.5), Xt,
                     Banded(noise.diag, torch.zeros(50, 1, dtype=torch.float64)))
    with pytest.raises(TypeError, match="precomputed"):
        KalmanSolver(tq.Matern32(scale=1.5), Xt, noise, covariance=object())
    solver = KalmanSolver(tq.Matern32(scale=1.5), Xt, noise)
    for call in (solver.variance, solver.covariance,
                 lambda: solver.solve_triangular(Xt, transpose=True),
                 lambda: solver.dot_triangular(Xt),
                 lambda: solver.condition(tq.Matern32(scale=1.5), None, noise)):
        with pytest.raises(NotImplementedError, match="oracle"):
            call()
