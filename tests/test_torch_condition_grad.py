"""Gradients through conditioning on the O(N) path, against the JAX
package, on the CPU: the port's scans differentiate through their
hand-written adjoints (``cuda_scan``'s ``Function`` s), the code the card
runs around kernel B3.

- the gradient in ``(amp, scale)`` of a held-out loss built from
  ``predict(y, X_test, return_var=True)`` (the triangular solves, the
  cross-covariance's scans, the dense downdate) at m = 2;
- the gradient of the posterior process's ``log_probability`` from
  ``condition(y)`` (the QSM product's coupling scans, the order-4m factor
  at the generic orders 8 and 12, its Riccati flow and solves);
- the gradient of the posterior's mean and variance at the training points;
- ``tests/test_solvers/test_quasisep/test_ops.py:116`` (the gradient of a
  triangular product) and ``test_solver.py:170`` (the log-likelihood's
  gradient against the dense solver's).

The JAX references use the sequential strategy (``parallel=False``), whose
gradient is plain autodiff of ``lax.scan``: the JAX package's parallel
posterior factor at order 8 or 12 takes minutes to compile. Float64 at the
tolerance table's 5e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinygp_tpu as jt
from tinygp_tpu import noise as jnoise
from tinygp_tpu.kernels import quasisep as jq
from tinygp_tpu.solvers.quasisep import ops as jops
from tinygp_tpu.solvers.quasisep.solver import QuasisepSolver as JaxQuasisepSolver
from tinygp_tpu_torch import GaussianProcess, kernels
from tinygp_tpu_torch.kernels import quasisep as tq
from tinygp_tpu_torch.solvers import DirectSolver
from tinygp_tpu_torch.solvers.quasisep import ops as tops
from tinygp_tpu_torch.test_utils import assert_allclose

N, N_TEST, POST_DIAG = 100, 40, 1e-3
MODELS = {
    "matern32": lambda q, amp, scale: amp * q.Matern32(scale=scale),
    "matern52": lambda q, amp, scale: amp * q.Matern52(scale=scale),
    "sho": lambda q, amp, scale: amp * q.SHO(omega=scale, quality=3.0),
}
THETA = (1.5, 2.5)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small tensor operations a step: with several test workers on
    one host, intra-op threads only contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def data(n=N, seed=42):
    rng = np.random.default_rng(seed)
    X = np.sort(rng.uniform(0, 10, n))
    y = rng.normal(size=n)
    X_test = np.linspace(0, 10, N_TEST)
    w = rng.normal(size=N_TEST)
    return X, y, X_test, w


def torch_grad(loss, theta=THETA):
    th = torch.tensor(theta, dtype=torch.float64, requires_grad=True)
    value = loss(th)
    (grad,) = torch.autograd.grad(value, th)
    return value, grad


def jax_grad(loss, theta=THETA):
    return jax.jit(jax.value_and_grad(loss))(jnp.asarray(theta))


@pytest.mark.parametrize("model", ["matern32"])
def test_predict_loss_gradient(model):
    """``sum(w * mu) + sum(var)`` at new points (m = 2; the generic orders
    are the posteriors' below)."""
    X, y, X_test, w = data()
    build = MODELS[model]

    def loss_torch(th):
        gp = GaussianProcess(build(tq, th[0], th[1]), X, diag=0.1, device="cpu")
        mu, var = gp.predict(y, X_test, return_var=True)
        return torch.sum(torch.as_tensor(w) * mu) + torch.sum(var)

    def loss_jax(th):
        gp = jt.GaussianProcess(build(jq, th[0], th[1]), jnp.asarray(X), diag=0.1,
                                parallel=False)
        mu, var = gp.predict(jnp.asarray(y), jnp.asarray(X_test), return_var=True)
        return jnp.sum(w * mu) + jnp.sum(var)

    got, want = torch_grad(loss_torch), jax_grad(loss_jax)
    assert_allclose(got[0], want[0])
    assert_allclose(got[1], want[1])


def _jax_posterior_log_prob(build, th, X, y):
    """The JAX posterior process's ``log_probability(y)``, as its
    ``condition(y, diag=POST_DIAG)`` builds it, with a sequential solver."""
    Xj, yj = jnp.asarray(X), jnp.asarray(y)
    gp = jt.GaussianProcess(build(jq, th[0], th[1]), Xj, diag=0.1, parallel=False)
    _, _, loc = gp._condition(yj, None, True)
    noise = jnoise.Diagonal(diag=jnp.full(X.shape, POST_DIAG))
    cov = gp.solver.condition(gp.kernel, None, noise)
    post = JaxQuasisepSolver(None, Xj, noise, covariance=cov, parallel=False)
    return post.log_likelihood(yj - loc)


@pytest.mark.parametrize("model", ["matern32", "sho", "matern52"])
def test_posterior_log_probability_gradient(model):
    """The posterior of order 4m (8, 8, 12): the coupling scans of
    ``factor.inv() @ M`` and its gram, then the generic-order factor."""
    X, y, _, _ = data()
    build = MODELS[model]

    def loss_torch(th):
        gp = GaussianProcess(build(tq, th[0], th[1]), X, diag=0.1, device="cpu")
        post = gp.condition(y, diag=POST_DIAG).gp
        assert post.solver.matrix.lower.p.shape[1] == 4 * gp.solver.matrix.lower.p.shape[1]
        return post.log_probability(y)

    got = torch_grad(loss_torch)
    want = jax_grad(lambda th: _jax_posterior_log_prob(build, th, X, y))
    assert_allclose(got[0], want[0])
    assert_allclose(got[1], want[1])


def test_posterior_mean_and_variance_gradient():
    """``sum(w * loc) + sum(variance)`` of ``condition(y)``'s process at the
    training points, whose variance is the QSM posterior's diagonal."""
    X, y, _, _ = data(n=80)
    w = np.random.default_rng(3).normal(size=80)
    build = MODELS["matern32"]

    def loss_torch(th):
        gp = GaussianProcess(build(tq, th[0], th[1]), X, diag=0.1, device="cpu")
        post = gp.condition(y).gp
        return torch.sum(torch.as_tensor(w) * post.loc) + torch.sum(post.variance)

    def loss_jax(th):
        Xj, yj = jnp.asarray(X), jnp.asarray(y)
        gp = jt.GaussianProcess(build(jq, th[0], th[1]), Xj, diag=0.1, parallel=False)
        _, _, loc = gp._condition(yj, None, True)
        noise = jnoise.Diagonal(diag=jnp.full(X.shape, jnp.sqrt(jnp.finfo(Xj.dtype).eps)))
        var = gp.solver.condition(gp.kernel, None, noise).diag.d
        return jnp.sum(w * loc) + jnp.sum(var)

    got, want = torch_grad(loss_torch), jax_grad(loss_jax)
    assert_allclose(got[0], want[0])
    assert_allclose(got[1], want[1])


def _system():
    """``test_ops.py``'s order-2 system (odd n: the blocked scan's padding)."""
    rng = np.random.default_rng(101)
    n, m = 65, 2
    p = 0.3 * rng.normal(size=(n, m))
    q = 0.3 * rng.normal(size=(n, m))
    a = 0.8 * np.stack([np.eye(m) + 0.1 * rng.normal(size=(m, m)) for _ in range(n)])
    d = 2.0 + rng.uniform(size=n)
    x = rng.normal(size=(n, 3))
    return d, p, q, a, x


@pytest.mark.parametrize("parallel", [False, True], ids=["sequential", "parallel"])
def test_ops_grad(parallel):
    """``test_ops.py:116``: the gradient of a strictly lower product in its
    row generators, sequential and parallel, against the JAX package's."""
    _, p, q, a, x = _system()
    f_torch = tops.lower_matmul_parallel if parallel else tops.lower_matmul
    qt, at, xt = (torch.as_tensor(v) for v in (q, a, x))
    pt = torch.tensor(p, requires_grad=True)
    (got,) = torch.autograd.grad(torch.sum(torch.square(f_torch(pt, qt, at, xt))), pt)
    want = jax.grad(lambda p_: jnp.sum(jnp.square(jops.lower_matmul(p_, q, a, x))))(p)
    assert_allclose(got, want)


@pytest.mark.parametrize("parallel", [False, True], ids=["sequential", "parallel"])
def test_grad_matches_dense(parallel):
    """``test_solver.py:170``: the quasiseparable log-likelihood's gradient
    in the scale against the dense solver's (atol 1e-5) and the JAX
    package's."""
    rng = np.random.default_rng(9)
    X = np.sort(rng.uniform(0, 10, 75))
    y = np.sin(X) + 0.1 * rng.normal(size=75)

    def grad(build, **kwargs):
        scale = torch.tensor(1.7, dtype=torch.float64, requires_grad=True)
        gp = GaussianProcess(build(scale), X, diag=0.1, device="cpu", **kwargs)
        return torch.autograd.grad(gp.log_probability(y), scale)[0]

    g_q = grad(lambda s: tq.Matern32(scale=s), parallel=parallel)
    g_d = grad(lambda s: kernels.Matern32(scale=s), solver=DirectSolver)
    assert_allclose(g_q, g_d, atol=1e-5)
    g_j = jax.grad(lambda s: jt.GaussianProcess(
        jq.Matern32(scale=s), jnp.asarray(X), diag=0.1, parallel=parallel
    ).log_probability(jnp.asarray(y)))(1.7)
    assert_allclose(g_q, g_j)


def test_float32_predict_loss_gradient_where_the_card_holds_it():
    """The configuration at which ``chip_smoke.py`` holds the card's float32
    gradient through conditioning to 5e-4: every 1000th of ``bench.py``'s
    1e5 points (N = 100), 1000 new points, ``1.5 * Matern32(2.5)``,
    ``diag=0.1``. There the port's float32 gradient on the CPU and the JAX
    package's (x64 off, sequential) each lie within 5e-4 of the largest
    entry of the float64 gradient on the same float32-rounded inputs, and
    of each other, so the card's limit is one float32 arithmetic can meet."""
    rng = np.random.default_rng(42)
    X5 = np.sort(rng.uniform(0, 10, 100_000))
    y5 = rng.normal(size=100_000)
    X, y = (a[::1000].astype(np.float32) for a in (X5, y5))
    X_test = np.linspace(0, 10, 1000)
    w = np.random.default_rng(7).normal(size=1000)

    def grad_torch(dtype):
        th = torch.tensor(THETA, dtype=dtype, requires_grad=True)
        gp = GaussianProcess(th[0] * tq.Matern32(scale=th[1]), torch.as_tensor(X, dtype=dtype),
                             diag=0.1, device="cpu")
        mu, var = gp.predict(torch.as_tensor(y, dtype=dtype),
                             torch.as_tensor(X_test, dtype=dtype), return_var=True)
        loss = torch.sum(torch.as_tensor(w, dtype=dtype) * mu) + torch.sum(var)
        return torch.autograd.grad(loss, th)[0].double().numpy()

    def loss_jax(th):
        gp = jt.GaussianProcess(th[0] * jq.Matern32(scale=th[1]), jnp.asarray(X), diag=0.1,
                                parallel=False)
        mu, var = gp.predict(jnp.asarray(y), jnp.asarray(X_test, jnp.float32), return_var=True)
        return jnp.sum(jnp.asarray(w, jnp.float32) * mu) + jnp.sum(var)

    with jax.enable_x64(False):
        th = jnp.asarray(THETA, jnp.float32)
        assert "f64" not in str(jax.make_jaxpr(jax.grad(loss_jax))(th))
        g_jax = np.asarray(jax.jit(jax.grad(loss_jax))(th), dtype=np.float64)
    g32, g64 = grad_torch(torch.float32), grad_torch(torch.float64)

    def err(got, want):
        return np.max(np.abs(got - want)) / np.max(np.abs(want))

    assert err(g32, g64) <= 5e-4
    assert err(g_jax, g64) <= 5e-4
    assert err(g32, g_jax) <= 5e-4
