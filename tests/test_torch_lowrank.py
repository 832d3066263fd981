"""The inducing-point low-rank solver (``solvers/lowrank.py``) against the
JAX package's, on the CPU. Mirrors ``tests/test_solvers/test_lowrank.py``
(its 11 tests: with ``Z = X`` the FITC construction is exact and matches
the dense solver; with M < N every quantity matches a dense treatment of
the approximate prior ``Khat = D + W W^T``) and holds the log-likelihood,
its gradient, the conditionals and ``_cap_apply``'s Daleckii-Krein
gradient on a rank-deficient capacitance to the JAX package's. Float64 at
the tolerance table's 5e-7 unless the mirrored test says otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinygp_tpu as jt
from tinygp_tpu.solvers import lowrank as jlowrank
from tinygp_tpu_torch import GaussianProcess, kernels
from tinygp_tpu_torch.noise import Dense, Diagonal
from tinygp_tpu_torch.solvers import DirectSolver, LowRankSolver
from tinygp_tpu_torch.solvers.lowrank import _cap_apply
from tinygp_tpu_torch.test_utils import assert_allclose


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def data():
    rng = np.random.default_rng(31)
    X = np.sort(rng.uniform(0, 10, 150))
    y = np.sin(X) + 0.1 * rng.normal(size=150)
    return X, y


def kernel():
    return 1.3 * kernels.ExpSquared(scale=1.5)


def jax_kernel():
    return 1.3 * jt.kernels.ExpSquared(scale=1.5)


def _diag(X, value):
    return Diagonal(torch.full((len(X),), value, dtype=torch.float64))


def test_exact_when_inducing_equals_inputs():
    X, y = data()
    gp_dense = GaussianProcess(kernel(), X, diag=0.1, solver=DirectSolver, device="cpu")
    gp_lr = GaussianProcess(kernel(), X, diag=0.1, solver=LowRankSolver,
                            inducing_points=X, device="cpu")
    assert_allclose(gp_lr.log_probability(y), gp_dense.log_probability(y))
    assert_allclose(gp_lr.variance, gp_dense.variance)

    grid = np.linspace(0, 10, 40)
    _, cond_d = gp_dense.condition(y, grid)
    _, cond_l = gp_lr.condition(y, grid)
    assert_allclose(cond_l.loc, cond_d.loc)
    assert_allclose(cond_l.variance, cond_d.variance)


def test_woodbury_matches_dense_oracle():
    X, y = data()
    Xt, yt = torch.as_tensor(X), torch.as_tensor(y)
    solver = LowRankSolver(kernel(), Xt, noise=_diag(X, 0.1), inducing_points=Xt[::5])
    Khat = solver.covariance().numpy()

    n = X.shape[0]
    sign, logdet = np.linalg.slogdet(Khat)
    assert sign > 0
    assert_allclose(solver.normalization(), 0.5 * logdet + 0.5 * n * np.log(2 * np.pi))

    alpha = solver.solve_triangular(yt)
    assert_allclose(torch.sum(alpha**2), y @ np.linalg.solve(Khat, y))

    v = torch.as_tensor(np.random.default_rng(0).normal(size=n))
    Lv = solver.dot_triangular(v)
    assert_allclose(solver.dot_triangular(solver.solve_triangular(Lv)), Lv)
    kinv = solver.solve_triangular(solver.solve_triangular(v), transpose=True)
    assert_allclose(kinv, np.linalg.solve(Khat, v.numpy()))


def test_fitc_diagonal_is_exact():
    X, _ = data()
    Xt = torch.as_tensor(X)
    solver = LowRankSolver(kernel(), Xt, noise=_diag(X, 0.1), inducing_points=Xt[::7])
    assert_allclose(solver.variance(), kernel()(Xt) + 0.1)
    assert_allclose(torch.diagonal(solver.covariance()), kernel()(Xt) + 0.1)


def test_sampling_covariance():
    X, _ = data()
    gp = GaussianProcess(kernel(), X, diag=0.1, solver=LowRankSolver,
                         inducing_points=X[::5], device="cpu")
    draws = gp.sample(torch.Generator().manual_seed(0), shape=(20000,))
    assert draws.shape == (20000, X.shape[0])
    emp = np.cov(draws.numpy(), rowvar=False)
    assert float(np.max(np.abs(emp - gp.solver.covariance().numpy()))) < 0.1


def _loss_torch(th, X, y, Z):
    gp = GaussianProcess(th[0] * kernels.ExpSquared(scale=th[1]), X, diag=0.1,
                         solver=LowRankSolver, inducing_points=Z, device="cpu")
    return -gp.log_probability(y)


def _loss_jax(th, X, y, Z):
    gp = jt.GaussianProcess(th[0] * jt.kernels.ExpSquared(scale=th[1]), jnp.asarray(X),
                            diag=0.1, solver=jlowrank.LowRankSolver,
                            inducing_points=jnp.asarray(Z))
    return -gp.log_probability(jnp.asarray(y))


def test_gradients_flow():
    """Finite, equal to the JAX package's, and to finite differences."""
    X, y = data()
    th = torch.tensor([1.3, 1.5], dtype=torch.float64, requires_grad=True)
    loss = _loss_torch(th, X, y, X[::5])
    (g,) = torch.autograd.grad(loss, th)
    assert torch.all(torch.isfinite(g))
    value, want = jax.jit(jax.value_and_grad(_loss_jax))(jnp.asarray([1.3, 1.5]), X, y, X[::5])
    assert_allclose(loss, value)
    assert_allclose(g, want)

    eps = 1e-3

    def f(a):
        return float(_loss_torch(torch.tensor([a, 1.5], dtype=torch.float64), X, y, X[::5]))

    np.testing.assert_allclose(float(g[0]), (f(1.3 + eps) - f(1.3 - eps)) / (2 * eps),
                               rtol=1e-2)


def test_validation():
    X = torch.linspace(0, 1, 16, dtype=torch.float64)
    with pytest.raises(TypeError, match="inducing_points"):
        LowRankSolver(kernel(), X, noise=_diag(X, 0.1))
    with pytest.raises(TypeError, match="Diagonal"):
        LowRankSolver(kernel(), X, noise=Dense(0.1 * torch.eye(16, dtype=torch.float64)),
                      inducing_points=X[::2])
    with pytest.raises(TypeError, match="structured"):
        LowRankSolver(kernel(), X, noise=_diag(X, 0.1), covariance=torch.eye(16),
                      inducing_points=X[::2])


def test_condition_includes_predictive_noise():
    X, y = data()
    gp = GaussianProcess(kernel(), X, diag=0.1, solver=LowRankSolver,
                         inducing_points=X[::5], device="cpu")
    grid = np.linspace(0, 10, 30)
    _, cond_noisy = gp.condition(y, grid, diag=0.25)
    _, cond_clean = gp.condition(y, grid)
    jitter = np.sqrt(np.finfo(np.float64).eps)
    assert_allclose(cond_noisy.variance - cond_clean.variance, np.full(30, 0.25 - jitter))


def test_posterior_covariance_is_psd_off_inducing():
    X, y = data()
    gp = GaussianProcess(kernel(), X, diag=0.05, solver=LowRankSolver,
                         inducing_points=X[::25], device="cpu")
    grid = np.linspace(X[0], X[-1], 120)
    _, cond = gp.condition(y, grid)
    eigs = np.linalg.eigvalsh(cond.covariance.numpy())
    assert eigs.min() > -1e-5 * max(1.0, eigs.max())


def test_gradients_finite_with_duplicate_inducing():
    """Duplicated Z makes W rank-deficient (repeated zero eigenvalues of the
    capacitance): the Daleckii-Krein gradient stays finite and equals the
    JAX package's."""
    X, y = data()
    Z = np.concatenate([X[::10], X[::10]])
    th = torch.tensor([1.3, 1.5], dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(_loss_torch(th, X, y, Z), th)
    assert torch.all(torch.isfinite(g))
    assert_allclose(g, jax.jit(jax.grad(_loss_jax))(jnp.asarray([1.3, 1.5]), X, y, Z))


def test_cap_apply_nan_input_poisons_not_crashes():
    """A non-finite capacitance never reaches ``eigh``: the output and the
    gradient are NaN, and the GP's log probability is -inf."""
    S = torch.full((4, 4), torch.nan, dtype=torch.float32, requires_grad=True)
    T = torch.ones((4, 1), dtype=torch.float32)
    out = _cap_apply(S, T, -1)
    assert torch.all(torch.isnan(out))
    (grad,) = torch.autograd.grad(torch.sum(out), S)
    assert torch.all(torch.isnan(grad))

    X, y = data()
    gp = GaussianProcess(kernel(), X, diag=0.1, solver=LowRankSolver,
                         inducing_points=X[::5], device="cpu")
    gp.solver.S = torch.full_like(gp.solver.S, torch.nan)
    assert gp.log_probability(y) == -torch.inf
    assert torch.all(torch.isnan(gp.solver.solve_triangular(torch.as_tensor(y))))


def test_f32_clustered_inducing_loglik_finite():
    """The trace-scaled ridge keeps the factor of Kmm finite for clustered
    inducing points in float32."""
    rng = np.random.default_rng(42)
    n, m = 2048, 256
    X = np.sort(rng.uniform(0, 10, n)).astype(np.float32)
    y = rng.normal(size=n).astype(np.float32)
    Z = X[:: n // m][:m]
    gp = GaussianProcess(1.5 * kernels.Matern32(scale=2.5), X, diag=0.1,
                         solver=LowRankSolver, inducing_points=Z, device="cpu")
    val = gp.log_probability(y)
    assert val.dtype == torch.float32 and torch.isfinite(val)


@pytest.mark.parametrize("sign", [-1, 1])
def test_cap_apply_gradient_matches_jax_on_rank_deficient(sign):
    """``_cap_apply``'s gradient (a VJP here, the JAX package's custom JVP
    there) on a rank-deficient PSD S with repeated zero eigenvalues."""
    rng = np.random.default_rng(12)
    V = rng.normal(size=(30, 4))
    V = np.concatenate([V, V[:, :2]], axis=1)  # 6 columns of rank 4
    S = V.T @ V
    T = rng.normal(size=(6, 3))
    ct = rng.normal(size=(6, 3))

    St, Tt = (torch.tensor(a, requires_grad=True) for a in (S, T))
    out = _cap_apply(St, Tt, sign)
    got = torch.autograd.grad(torch.sum(out * torch.as_tensor(ct)), (St, Tt))
    assert all(torch.all(torch.isfinite(g)) for g in got)

    def f(S, T):
        return jnp.sum(jlowrank._cap_apply(S, T, sign) * ct)

    value, want = jax.value_and_grad(f, argnums=(0, 1))(S, T)
    assert_allclose(torch.sum(out * torch.as_tensor(ct)), value)
    # JAX's cotangent of S is its symmetric part's, as the JVP symmetrizes.
    assert_allclose(got[0], 0.5 * (want[0] + want[0].T))
    assert_allclose(got[1], want[1])


def test_subset_of_regressors_matches_jax():
    """``fitc=False``: the Nystrom diagonal; value, variance and the
    conditionals against the JAX package's."""
    X, y = data()
    Xt = torch.as_tensor(X)
    solver = LowRankSolver(kernel(), Xt, noise=_diag(X, 0.1), inducing_points=Xt[::5],
                           fitc=False)
    from tinygp_tpu.noise import Diagonal as JaxDiagonal

    grid = np.linspace(0, 10, 20)

    @jax.jit
    def reference(X, y, grid):
        jsolver = jlowrank.LowRankSolver(jax_kernel(), X, JaxDiagonal(diag=jnp.full(150, 0.1)),
                                         inducing_points=X[::5], fitc=False)
        cond = jsolver.condition(jax_kernel(), grid, JaxDiagonal(diag=jnp.full(20, 0.1)))
        return jsolver.variance(), jsolver.log_likelihood(y), cond

    variance, loglik, cond = reference(X, y, grid)
    assert_allclose(solver.variance(), variance)
    assert_allclose(solver.log_likelihood(torch.as_tensor(y)), loglik)
    assert_allclose(solver.condition(kernel(), torch.as_tensor(grid), _diag(grid, 0.1)), cond)
