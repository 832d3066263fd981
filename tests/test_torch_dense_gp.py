"""The dense path end to end: ``GaussianProcess`` with a kernel that is not
quasiseparable (the ``DirectSolver``), and the dense posterior of a
quasiseparable process at new points, against the JAX package on the same
data.

Float64 comparisons use the table's 5e-7; the float32 fused route uses the
JAX test's own bound (5e-4 relative plus 1e-3,
``tests/test_ops_dense.py:318``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinygp_tpu import GaussianProcess as JaxGP
from tinygp_tpu import kernels as jk
from tinygp_tpu import noise as jnoise
from tinygp_tpu import transforms as jt
from tinygp_tpu.kernels import quasisep as jq
from tinygp_tpu.ops import dense as jdense
from tinygp_tpu_torch import GaussianProcess, kernels as tk, noise as tnoise, transforms as tt
from tinygp_tpu_torch.kernels import quasisep as tq
from tinygp_tpu_torch.ops import dense as tdense
from tinygp_tpu_torch.solvers import DirectSolver
from tinygp_tpu_torch.test_utils import assert_allclose


def data(n, seed=42, d=None):
    rng = np.random.default_rng(seed)
    X = np.sort(rng.uniform(0, 10, n)) if d is None else rng.uniform(0, 10, (n, d))
    return X, rng.normal(size=n)


MODELS = {
    "matern32": (lambda k: 1.5 * k.Matern32(scale=2.5), None),
    "expsquared_sum": (lambda k: k.ExpSquared(scale=1.2) + 0.5 * k.Exp(scale=3.0), None),
    "rq_nx3": (lambda k: k.RationalQuadratic(scale=2.0, alpha=1.5), 3),
}


def both(name, n, seed=42, **kwargs):
    make, d = MODELS[name]
    X, y = data(n, seed, d)
    jgp = JaxGP(make(jk), jnp.asarray(X), **kwargs)
    tgp = GaussianProcess(make(tk), torch.as_tensor(X), device="cpu", **kwargs)
    return jgp, tgp, X, y


@pytest.mark.parametrize("name", sorted(MODELS))
def test_log_probability_matches_jax(name):
    jgp, tgp, _, y = both(name, 300, diag=0.1)
    assert isinstance(tgp.solver, DirectSolver)
    assert_allclose(tgp.log_probability(y), float(jgp.log_probability(jnp.asarray(y))))


def test_fused_route_float32_matches_jax(monkeypatch):
    """Above the size gate the float32 log probability takes the
    strip-built fused route (B5 and B4 with its side products) in both."""
    monkeypatch.setattr(jdense, "_MIN_BLOCKED", 256)
    monkeypatch.setattr(tdense, "_MIN_BLOCKED", 256)
    X, y = data(768, seed=3)
    X32 = X.astype(np.float32)
    want = float(JaxGP(1.5 * jk.Matern32(scale=2.5), jnp.asarray(X32), diag=0.1)
                 .log_probability(jnp.asarray(y, jnp.float32)))
    calls = []
    real = tdense._ScaledLoglik.apply
    monkeypatch.setattr(tdense._ScaledLoglik, "apply", lambda *a: calls.append(a[4]) or real(*a))
    tgp = GaussianProcess(1.5 * tk.Matern32(scale=2.5), torch.as_tensor(X32), diag=0.1, device="cpu")
    got = float(tgp.log_probability(y))
    assert calls == [True]  # the strip-built, lower-only route
    assert abs(got - want) < 5e-4 * abs(want) + 1e-3
    # And against the generic route in float64.
    ref = float(GaussianProcess(1.5 * tk.Matern32(scale=2.5), torch.as_tensor(X), diag=0.1,
                                device="cpu").log_probability(y))
    assert abs(got - ref) < 5e-4 * abs(ref) + 1e-3


@pytest.mark.parametrize("fused", [False, True])
def test_breakdown_gives_minus_inf_as_jax(fused, monkeypatch):
    """An indefinite covariance: NaN from the factor, -inf from the GP, on
    the generic route (float64) and on the fused one (float32, past the
    size gate, where the guard re-factors natively and still finds NaN)."""
    if fused:
        monkeypatch.setattr(jdense, "_MIN_BLOCKED", 256)
        monkeypatch.setattr(tdense, "_MIN_BLOCKED", 256)
    X, y = data(600)
    dtype = np.float32 if fused else np.float64
    jlp = JaxGP(jk.Matern32(scale=1.0), jnp.asarray(X, dtype), diag=-10.0).log_probability(
        jnp.asarray(y, dtype))
    assert float(jlp) == -np.inf
    before = tdense.NATIVE_REFACTORS
    gp = GaussianProcess(tk.Matern32(scale=1.0), torch.as_tensor(X.astype(dtype)), diag=-10.0,
                         device="cpu")
    assert gp.log_probability(y).item() == -np.inf
    assert tdense.NATIVE_REFACTORS == before + fused


def test_blocked_false_and_solver_kwargs_are_dropped():
    X, y = data(200)
    gp = GaussianProcess(tk.Matern52(scale=1.0), torch.as_tensor(X), diag=0.1, device="cpu",
                         blocked=False, assume_sorted=True, parallel=False)
    assert not gp.solver.blocked
    want = float(JaxGP(jk.Matern52(scale=1.0), jnp.asarray(X), diag=0.1).log_probability(jnp.asarray(y)))
    assert_allclose(gp.log_probability(y), want)


@pytest.mark.parametrize("name", ["matern32", "rq_nx3"])
def test_condition_matches_jax(name):
    jgp, tgp, X, y = both(name, 250, diag=0.1)
    d = MODELS[name][1]
    X_test = np.linspace(-1, 11, 40) if d is None else np.random.default_rng(9).uniform(0, 10, (40, d))
    for Xt in (None, X_test):
        jlp, jpost = jgp.condition(jnp.asarray(y), None if Xt is None else jnp.asarray(Xt))
        tlp, tpost = tgp.condition(y, None if Xt is None else torch.as_tensor(Xt))
        assert_allclose(tlp, float(jlp))
        assert_allclose(tpost.loc, jpost.loc)
        assert_allclose(tpost.variance, jpost.variance)
        assert_allclose(tpost.covariance, jpost.covariance)


def test_predict_matches_jax():
    jgp, tgp, _, y = both("expsquared_sum", 250, diag=0.1)
    X_test = np.linspace(-1, 11, 40)
    for kw in ({}, {"return_var": True}, {"return_cov": True}, {"include_mean": False}):
        want = jgp.predict(jnp.asarray(y), jnp.asarray(X_test), **kw)
        got = tgp.predict(y, torch.as_tensor(X_test), **kw)
        for g, w in zip(*(x if isinstance(x, tuple) else (x,) for x in (got, want))):
            assert_allclose(g, w)


def test_sample_is_mean_plus_factor_times_white_noise():
    _, tgp, _, _ = both("matern32", 200, diag=0.1)
    draws = tgp.sample(torch.Generator().manual_seed(3), (5,))
    assert draws.shape == (5, 200) and torch.isfinite(draws).all()
    eps = torch.randn((200, 5), generator=torch.Generator().manual_seed(3), dtype=torch.float64)
    assert_allclose(draws, (tgp.loc[:, None] + tgp.solver.scale_tril @ eps).T)


def test_dense_and_banded_noise_match_jax():
    X, y = data(150)
    rng = np.random.default_rng(8)
    A = rng.normal(size=(150, 150)) / np.sqrt(150)
    value = 0.1 * np.eye(150) + 0.02 * (A @ A.T)
    diag, off = rng.uniform(0.2, 0.4, 150), 0.02 * rng.normal(size=(150, 2))
    cases = [
        (jnoise.Dense(value=jnp.asarray(value)), tnoise.Dense(torch.as_tensor(value))),
        (jnoise.Banded(diag=jnp.asarray(diag), off_diags=jnp.asarray(off)),
         tnoise.Banded(torch.as_tensor(diag), torch.as_tensor(off))),
    ]
    for jn, tn in cases:
        K = np.zeros((150, 150))
        assert_allclose(tn + torch.as_tensor(K), jn + jnp.asarray(K))
        want = JaxGP(jk.Matern32(scale=1.5), jnp.asarray(X), noise=jn).log_probability(jnp.asarray(y))
        gp = GaussianProcess(tk.Matern32(scale=1.5), torch.as_tensor(X), noise=tn, device="cpu")
        assert gp.solver.kernel is None  # no strip-built route for non-diagonal noise
        assert float(gp.solver.rel_floor) == 0.0
        assert_allclose(gp.log_probability(y), float(want))
        assert_allclose(gp.predict(y), JaxGP(jk.Matern32(scale=1.5), jnp.asarray(X), noise=jn).predict(jnp.asarray(y)))


def test_transformed_kernel_on_vectors_matches_jax():
    X, y = data(120, d=2)
    jkern = jt.Linear(scale=np.array([0.5, 2.0]), kernel=jk.ExpSquared(scale=1.5))
    tkern = tt.Linear(scale=torch.tensor([0.5, 2.0], dtype=torch.float64), kernel=tk.ExpSquared(scale=1.5))
    want = JaxGP(jkern, jnp.asarray(X), diag=0.2).log_probability(jnp.asarray(y))
    got = GaussianProcess(tkern, torch.as_tensor(X), diag=0.2, device="cpu").log_probability(y)
    assert_allclose(got, float(want))


def test_dense_gradient_matches_jax():
    import jax

    X, y = data(200)

    def jax_lp(p):
        return JaxGP(p["amp"] * jk.Matern32(scale=p["scale"]), jnp.asarray(X), diag=p["diag"]).log_probability(jnp.asarray(y))

    want = jax.grad(jax_lp)({"amp": 1.5, "scale": 2.5, "diag": 0.1})
    leaves = [torch.tensor(v, dtype=torch.float64, requires_grad=True) for v in (1.5, 2.5, 0.1)]
    gp = GaussianProcess(leaves[0] * tk.Matern32(scale=leaves[1]), torch.as_tensor(X),
                         diag=leaves[2], device="cpu")
    got = torch.autograd.grad(gp.log_probability(y), leaves)
    for g, k in zip(got, ("amp", "scale", "diag")):
        assert g != 0
        assert_allclose(g, float(want[k]))


def test_quasisep_variance_at_new_points_matches_jax():
    """``predict(..., return_var=True)`` at new points takes the dense
    posterior of the O(N) solver."""
    X, y = data(300, seed=5)
    X_test = np.linspace(-0.5, 10.5, 60)
    jgp = JaxGP(1.5 * jq.Matern32(scale=2.5), jnp.asarray(X), diag=0.1, assume_sorted=True)
    tgp = GaussianProcess(1.5 * tq.Matern32(scale=2.5), torch.as_tensor(X), diag=0.1,
                          assume_sorted=True, device="cpu")
    jpost = jgp.condition(jnp.asarray(y), jnp.asarray(X_test)).gp
    mu, var = tgp.predict(y, torch.as_tensor(X_test), return_var=True)
    assert isinstance(tgp.condition(y, torch.as_tensor(X_test)).gp.solver, DirectSolver)
    assert_allclose(mu, jpost.loc)
    assert_allclose(var, jpost.variance)
    _, cov = tgp.predict(y, torch.as_tensor(X_test), return_cov=True)
    assert_allclose(cov, jpost.covariance)
    # Against the dense kernel's posterior on the same data.
    dense = GaussianProcess(1.5 * tk.Matern32(scale=2.5), torch.as_tensor(X), diag=0.1, device="cpu")
    assert_allclose(var, dense.predict(y, torch.as_tensor(X_test), return_var=True)[1])


def test_posterior_variance_does_not_factor():
    """A posterior built from its covariance reads its variance off the
    diagonal; the factor is built only by what needs it."""
    _, tgp, _, y = both("matern32", 100, diag=0.1)
    post = tgp.condition(y, torch.linspace(0, 10, 30, dtype=torch.float64)).gp
    assert post.variance.shape == (30,)
    assert post.solver._scale_tril is None
    assert tgp.solver._scale_tril is not None


def test_gp_over_a_conditioned_kernel_matches_jax():
    """A process whose kernel is a dense posterior's (``Conditioned`` over
    a ``DirectSolver``) takes the dense solver in both packages."""
    jgp, tgp, _, y = both("matern32", 120, diag=0.1)
    X_new, y_new = data(50, seed=7)
    jpost, tpost = jgp.condition(jnp.asarray(y)).gp, tgp.condition(y).gp
    want = JaxGP(jpost.kernel, jnp.asarray(X_new), diag=0.2).log_probability(jnp.asarray(y_new))
    gp = GaussianProcess(tpost.kernel, torch.as_tensor(X_new), diag=0.2, device="cpu")
    assert isinstance(gp.solver, DirectSolver)
    assert_allclose(gp.log_probability(y_new), float(want))
