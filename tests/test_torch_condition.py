"""Conditioning, prediction and sampling on the O(N) path, against the JAX
package: ``GaussianProcess.condition(y)`` (its log probability and the
posterior's ``loc`` and ``variance``), ``predict`` at the training and at
new points, the solver's triangular solves and products and its
normalization, for SHO, Matern32, Exp, Matern52 and the 2-term celerite
sum at N = 300, with ``Banded`` noise and with a precomputed covariance.
Float64 at the tolerance table's 5e-7.

Each kernel's JAX reference is computed once per module, in one ``jit``,
with the sequential strategy. It takes the posterior's ``loc`` and
``variance`` where the JAX ``condition`` takes them (``gp.py:200-214``):
the mean of ``_condition``, and the diagonal of ``solver.condition`` with
the posterior's default noise. It skips the posterior process itself,
whose eager order-4m factor is dead code for both and takes minutes to
compile (the port builds that factor only on use).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from tinygp_tpu import GaussianProcess as JaxGP
from tinygp_tpu import noise as jnoise
from tinygp_tpu.kernels import quasisep as jq
from tinygp_tpu_torch import GaussianProcess
from tinygp_tpu_torch.kernels import quasisep as tq
from tinygp_tpu_torch.kernels.base import Conditioned
from tinygp_tpu_torch.noise import Banded
from tinygp_tpu_torch.solvers.quasisep.core import SymmQSM
from tinygp_tpu_torch.test_utils import assert_allclose

N = 300
MODELS = {
    "sho": lambda q: 1.2 * q.SHO(omega=1.5, quality=3.0),
    "matern32": lambda q: 1.5 * q.Matern32(scale=2.5),
    "exp": lambda q: q.Exp(scale=1.0, sigma=0.8),
    "matern52": lambda q: q.Matern52(scale=1.5),
    "celerite2": lambda q: q.Celerite(a=1.0, b=0.1, c=0.5, d=1.0)
    + q.Celerite(a=0.5, b=0.05, c=1.5, d=3.0),
}


def data(n=N, seed=11):
    rng = np.random.default_rng(seed)
    X = np.sort(rng.uniform(0, 10, n))
    y = np.sin(2.0 * X) + 0.3 * rng.normal(size=n)
    # New points before the first input, after the last and in between.
    X_test = np.concatenate([[-0.7], np.sort(rng.uniform(0, 10, 40)), [10.4, 11.0]])
    eps = rng.normal(size=(n, 3))
    return X, y, X_test, eps


def jax_reference(kernel, X, y, X_test, eps, **gp_kwargs):
    """Everything the tests compare, from one jitted JAX program."""

    @jax.jit
    def run(X, y, X_test, eps):
        gp = JaxGP(kernel(jq), X, parallel=False, **gp_kwargs)
        _, log_prob, loc = gp._condition(y, None, True)
        post_noise = jnoise.Diagonal(
            diag=jnp.full(X.shape, jnp.sqrt(jnp.finfo(X.dtype).eps))
        )
        return {
            "log_prob": log_prob,
            "loc": loc,
            "variance": gp.solver.condition(gp.kernel, None, post_noise).diag.d,
            "predict_test": gp.predict(y, X_test),
            "predict_test_nomean": gp.predict(y, X_test, include_mean=False),
            "white": gp.solver.solve_triangular(y - gp.loc),
            "white_t": gp.solver.solve_triangular(y, transpose=True),
            "dot": gp.solver.dot_triangular(eps),
            "normalization": gp.solver.normalization(),
            "log_probability": gp.log_probability(y),
        }

    out = run(*map(jnp.asarray, (X, y, X_test, eps)))
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module", params=sorted(MODELS))
def case(request):
    """(name, port GP, its data, the JAX reference) per kernel."""
    X, y, X_test, eps = data()
    kernel = MODELS[request.param]
    ref = jax_reference(kernel, X, y, X_test, eps, diag=0.1, mean=0.3)
    gp = GaussianProcess(kernel(tq), torch.tensor(X), diag=0.1, mean=0.3, device="cpu")
    return request.param, gp, (X, y, X_test, eps), ref


def test_condition_matches_jax(case):
    name, gp, (X, y, _, _), ref = case
    log_prob, post = gp.condition(y)
    assert_allclose(log_prob, ref["log_prob"])
    assert_allclose(post.loc, ref["loc"])
    assert_allclose(post.variance, ref["variance"])
    # The posterior: a SymmQSM of order 4m at the training points.
    m = gp.solver.ssm[1].shape[0]
    assert isinstance(post.solver.matrix, SymmQSM)
    assert post.solver.matrix.lower.p.shape == (N, 4 * m)
    assert isinstance(post.kernel, Conditioned)
    assert torch.equal(post.X, gp.X)
    # The same log probability as the fused route.
    assert_allclose(log_prob, gp.log_probability(y))
    assert_allclose(ref["log_probability"], ref["log_prob"])


def test_predict_matches_jax(case):
    _, gp, (_, y, X_test, _), ref = case
    assert_allclose(gp.predict(y), ref["loc"])
    loc, var = gp.predict(y, return_var=True)
    assert_allclose(loc, ref["loc"])
    assert_allclose(var, ref["variance"])
    mu = gp.predict(y, X_test)
    assert mu.shape == (X_test.shape[0],)
    assert_allclose(mu, ref["predict_test"])
    assert_allclose(gp.predict(y, X_test, include_mean=False), ref["predict_test_nomean"])


def test_solver_matches_jax(case):
    _, gp, (_, y, _, eps), ref = case
    solver = gp.solver
    assert_allclose(solver.solve_triangular(torch.tensor(y) - gp.loc), ref["white"])
    assert_allclose(solver.solve_triangular(torch.tensor(y), transpose=True), ref["white_t"])
    assert_allclose(solver.dot_triangular(torch.tensor(eps)), ref["dot"])
    assert_allclose(solver.normalization(), ref["normalization"])


def test_posterior_against_dense_algebra():
    """The posterior process as a whole: its covariance, its kernel, its
    mean function and its own log probability (the lazily built order-4m
    factor) against dense linear algebra."""
    n = 100
    X, y, X_test, _ = data(n=n)
    gp = GaussianProcess(MODELS["exp"](tq), torch.tensor(X), diag=0.1, device="cpu")
    _, post = gp.condition(y, diag=0.05)
    Xt = torch.tensor(X)
    K = gp.kernel(Xt, Xt)
    C = K + 0.1 * torch.eye(n)
    want = K + 0.05 * torch.eye(n) - K @ torch.linalg.solve(C, K)
    assert_allclose(post.covariance, want)
    assert_allclose(post.kernel(Xt, Xt), K - K @ torch.linalg.solve(C, K))
    assert_allclose(post.kernel(Xt), torch.diagonal(K - K @ torch.linalg.solve(C, K)))
    Xs = torch.tensor(X_test)
    assert_allclose(post.mean_function(Xs), gp.predict(y, X_test))
    assert_allclose(post.kernel.evaluate(Xs[:5], Xs[3:8]), torch.diagonal(post.kernel(Xs[:5], Xs[3:8])))
    z = np.random.default_rng(3).normal(size=n)
    want = scipy.stats.multivariate_normal(post.loc.numpy(), want.numpy()).logpdf(z)
    assert_allclose(post.log_probability(z), want)


def test_banded_noise_matches_jax():
    X, y, X_test, eps = data()
    rng = np.random.default_rng(5)
    diag = rng.uniform(0.3, 0.5, N)
    off = 0.05 * rng.uniform(size=(N, 2))
    kernel = MODELS["sho"]
    ref = jax_reference(
        kernel, X, y, X_test, eps, noise=jnoise.Banded(diag=jnp.asarray(diag), off_diags=jnp.asarray(off))
    )
    noise = Banded(torch.tensor(diag), torch.tensor(off))
    gp = GaussianProcess(kernel(tq), torch.tensor(X), noise=noise, device="cpu")
    # Not Diagonal: no fused operands; the covariance is kernel + band.
    assert gp.solver.ssm is None and gp.solver.matrix.lower.p.shape == (N, 4)
    assert_allclose(gp.log_probability(y), ref["log_probability"])
    log_prob, post = gp.condition(y)
    assert_allclose(log_prob, ref["log_prob"])
    assert_allclose(post.loc, ref["loc"])
    assert_allclose(post.variance, ref["variance"])
    assert_allclose(gp.predict(y, X_test), ref["predict_test"])
    assert_allclose(gp.solver.dot_triangular(torch.tensor(eps)), ref["dot"])
    x = torch.tensor(eps)
    assert_allclose(noise @ x, noise.to_qsm().to_dense() @ x)
    # The dense sum, which the dense solver factors, is the same band.
    assert_allclose(noise + torch.eye(N, dtype=torch.float64),
                    noise.to_qsm().to_dense() + torch.eye(N, dtype=torch.float64))


def test_precomputed_covariance_matches_jax():
    X, y, _, eps = data()
    kernel = MODELS["matern32"]
    Xj = jnp.asarray(X)
    Kj = kernel(jq).to_symm_qsm(Xj) + jnoise.Diagonal(diag=jnp.full(N, 0.1)).to_qsm()
    want = JaxGP(kernel(jq), Xj, covariance_value=Kj, parallel=False)
    K = kernel(tq).to_symm_qsm(torch.tensor(X)) + Banded(
        torch.full((N,), 0.1, dtype=torch.float64), torch.zeros(N, 1, dtype=torch.float64)
    ).to_qsm()
    gp = GaussianProcess(kernel(tq), torch.tensor(X), covariance_value=K, device="cpu")
    assert gp.solver.ssm is None
    assert_allclose(gp.log_probability(y), want.log_probability(jnp.asarray(y)))
    assert_allclose(gp.variance, want.variance)
    assert_allclose(gp.solver.dot_triangular(torch.tensor(eps)), want.solver.dot_triangular(jnp.asarray(eps)))


def test_sequential_strategy_matches_parallel():
    X, y, X_test, _ = data(n=150)
    kernel = MODELS["matern32"](tq)
    outs = []
    for parallel in (True, False):
        gp = GaussianProcess(kernel, torch.tensor(X), diag=0.1, parallel=parallel, device="cpu")
        log_prob, post = gp.condition(y)
        outs.append((log_prob, post.loc, post.variance, gp.predict(y, X_test)))
    for a, b in zip(*outs):
        assert_allclose(a, b)


def test_kernel_argument_matches_jax():
    """Conditioning with one term of a sum as the cross-covariance."""
    X, y, X_test, _ = data()

    @jax.jit
    def run(X, y, X_test):
        gp = JaxGP(MODELS["celerite2"](jq), X, diag=0.1, parallel=False)
        term = jq.Celerite(a=1.0, b=0.1, c=0.5, d=1.0)
        # The means that `predict` and `condition` return (see the module
        # docstring).
        return gp._condition(y, None, True, term)[2], gp._condition(y, X_test, True, term)[2]

    want = run(*map(jnp.asarray, (X, y, X_test)))
    gp = GaussianProcess(MODELS["celerite2"](tq), torch.tensor(X), diag=0.1, device="cpu")
    term = tq.Celerite(a=1.0, b=0.1, c=0.5, d=1.0)
    _, post = gp.condition(y, kernel=term)
    assert_allclose(post.loc, want[0])
    assert_allclose(gp.predict(y, X_test, kernel=term), want[1])


def test_sample_shape_device_generator_and_moments():
    X = np.linspace(0, 5, 40)
    gp = GaussianProcess(MODELS["matern32"](tq), torch.tensor(X), diag=0.1, mean=0.5, device="cpu")
    draw = gp.sample(torch.Generator().manual_seed(7), (4000,))
    assert draw.shape == (4000, 40) and draw.dtype == torch.float64
    assert draw.device.type == "cpu"
    assert gp.sample(torch.Generator().manual_seed(3)).shape == (40,)
    again = gp.sample(torch.Generator().manual_seed(7), (4000,))
    assert torch.equal(draw, again)
    assert not torch.equal(draw, gp.sample(torch.Generator().manual_seed(8), (4000,)))
    # Moments: the sample covariance is the model's within Monte-Carlo
    # error (entries of a Wishart draw have sd <= sqrt(2/S) * var).
    K = gp.covariance
    S = torch.cov(draw.T)
    assert float((S - K).abs().max()) < 6 * math.sqrt(2 / 4000) * float(K.max())
    assert float((draw.mean(0) - 0.5).abs().max()) < 6 * math.sqrt(float(K.max()) / 4000)


def test_dot_triangular_is_the_factor():
    X, y, _, eps = data(n=80)
    gp = GaussianProcess(MODELS["sho"](tq), torch.tensor(X), diag=0.1, device="cpu")
    L = gp.solver.dot_triangular(torch.eye(80, dtype=torch.float64))
    assert_allclose(L @ L.T, gp.covariance)
    assert_allclose(torch.triu(L, 1), torch.zeros(80, 80, dtype=torch.float64))


@pytest.mark.parametrize(
    "call",
    [
        lambda gp, y, Xt: gp.condition(y, Xt),
        lambda gp, y, Xt: gp.predict(y, Xt, return_var=True),
        lambda gp, y, Xt: gp.predict(y, Xt, return_cov=True),
        lambda gp, y, Xt: gp.solver.condition(Conditioned(gp.X, gp.solver, gp.kernel), None, gp.noise),
    ],
    ids=["condition_at_new_points", "var_at_new_points", "cov_at_new_points", "dense_kernel"],
)
def test_dense_posteriors_match_the_dense_kernel_process(call):
    """The quasiseparable process's dense posteriors (at new points, or
    over a kernel that is not quasiseparable) agree with the same model's
    dense-kernel process."""
    from tinygp_tpu_torch import kernels as tk

    X, y, X_test, _ = data(n=50)
    gp = GaussianProcess(MODELS["matern32"](tq), torch.tensor(X), diag=0.1, device="cpu")
    dense = GaussianProcess(MODELS["matern32"](tk), torch.tensor(X), diag=0.1, device="cpu")
    got, want = call(gp, y, X_test), call(dense, y, X_test)
    if hasattr(got, "gp"):
        got, want = (got[0], got.gp.loc, got.gp.variance), (want[0], want.gp.loc, want.gp.variance)
    elif isinstance(got, torch.Tensor):
        # The solvers' own condition: the O(N) solver's dense branch leaves
        # the noise out, as the JAX one does; the dense solver adds it.
        got, want = (got,), (want - torch.diag(gp.noise.diagonal()),)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert_allclose(g, w)


def test_test_points_must_match_the_inputs():
    X, y, _, _ = data(n=50)
    gp = GaussianProcess(MODELS["matern32"](tq), torch.tensor(X), diag=0.1, device="cpu")
    with pytest.raises(ValueError, match="trailing"):
        gp.predict(y, np.zeros((3, 2)))


def test_float32_condition_is_finite_and_close():
    """float32, as the card's float32 run: finite, and within the float32
    tolerance of float64 for the mean."""
    X, y, X_test, _ = data()
    outs = {}
    for dtype in (torch.float32, torch.float64):
        gp = GaussianProcess(MODELS["sho"](tq), torch.tensor(X, dtype=dtype), diag=0.1, device="cpu")
        log_prob, post = gp.condition(y)
        outs[dtype] = (log_prob, post.loc, gp.predict(y, X_test), post.variance)
        assert all(torch.isfinite(x).all() and x.dtype == dtype for x in outs[dtype])
    for a, b in list(zip(outs[torch.float32], outs[torch.float64]))[:3]:
        assert_allclose(a, b)
