"""The port's HMC and NUTS against the JAX package's: the pieces on the
same inputs (the leapfrog step, the kinetic energy, the U-turn test, dual
averaging, the warmup schedule), the samplers' moments on
``tests/test_samplers/test_mcmc.py``'s Gaussian targets within Monte-Carlo
error (the two packages draw different random streams, BASELINE.md:36),
and the driver: chunked runs equal a single one bit for bit, and a run
resumed from its checkpoint equals the uninterrupted one."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinygp_tpu_torch.samplers import find_initial_step_size, nuts, run_mcmc, window_adaptation

jhmc = importlib.import_module("tinygp_tpu.samplers.hmc")
thmc = importlib.import_module("tinygp_tpu_torch.samplers.hmc")

MU = np.array([1.0, -2.0, 0.5])
SD = np.array([0.5, 1.5, 1.0])
RTOL = 5e-7


def t64(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


def gaussian(mu, sd):
    """The same diagonal Gaussian log density in both packages."""
    return (lambda z: -0.5 * jnp.sum(jnp.square((z - mu) / sd)),
            lambda z: -0.5 * torch.sum(torch.square((z - t64(mu)) / t64(sd))))


# ---------------------------------------------------------------------------
# The pieces, on the same inputs.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("step_size", [0.3, -0.05])
def test_leapfrog_matches_jax(step_size):
    rng = np.random.default_rng(0)
    jlp, tlp = gaussian(MU, SD)
    z, r = rng.normal(size=(6, 3)), rng.normal(size=(6, 3))
    inv_mass = rng.uniform(0.5, 2.0, size=3)
    jvg = jax.value_and_grad(jlp)
    want = jax.vmap(lambda z, r: jhmc._leapfrog(jvg, z, r, jvg(z)[1], step_size, inv_mass))(z, r)
    tvg = thmc._value_and_grad(tlp)
    got = thmc._leapfrog(tvg, t64(z), t64(r), tvg(t64(z))[1], step_size, t64(inv_mass))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=1e-12)


def test_kinetic_and_turning_match_jax():
    rng = np.random.default_rng(1)
    r, rl, rr, s = (rng.normal(size=(64, 5)) for _ in range(4))
    inv_mass = rng.uniform(0.5, 2.0, size=5)
    want = jax.vmap(lambda x: jhmc._kinetic(x, inv_mass))(r)
    np.testing.assert_allclose(thmc._kinetic(t64(r), t64(inv_mass)).numpy(), np.asarray(want),
                               rtol=RTOL)
    want = jax.vmap(lambda a, b, c: jhmc._is_turning(a, b, c, inv_mass))(rl, rr, s)
    got = thmc._is_turning(t64(rl), t64(rr), t64(s), t64(inv_mass))
    assert 0 < int(got.sum()) < 64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dual_averaging_matches_jax():
    accepts = np.random.default_rng(2).uniform(0.2, 1.0, size=60)
    js, ts = jhmc._da_init(jnp.asarray(0.3)), thmc._da_init(t64(0.3))
    for a in accepts:
        js, ts = jhmc._da_update(js, jnp.asarray(a), 0.8), thmc._da_update(ts, t64(a), 0.8)
        for g, w in zip(ts, js):
            np.testing.assert_allclose(float(g), float(w), rtol=RTOL)


@pytest.mark.parametrize("num_warmup", [1, 5, 40, 100, 149, 150, 151, 500, 1000, 1789])
def test_warmup_schedule_matches_jax(num_warmup):
    assert thmc._warmup_schedule(num_warmup) == jhmc._warmup_schedule(num_warmup)


def test_warmup_schedule_structure():
    init, switches, term = thmc._warmup_schedule(1000)
    assert (init, term, switches[0]) == (75, 50, 75 + 25 - 1)
    widths = np.diff([init - 1] + switches)
    assert all(b == 2 * a for a, b in zip(widths[:-2], widths[1:-1]))
    assert switches[-1] == 1000 - term - 1


def test_ravel_spec_matches_jax():
    init = {"b": torch.zeros(2, 3), "a": torch.arange(2.0), "c": [torch.tensor(5.0)]}
    ravel, unravel, dim = thmc._ravel_spec(init)
    jinit = jax.tree_util.tree_map(lambda x: jnp.asarray(x.numpy()), init)
    jravel, _, jdim = jhmc._ravel_spec(jinit)
    assert dim == jdim == 9
    flat = ravel(init)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jravel(jinit)))
    back = unravel(torch.stack([flat, 2 * flat]))  # leading axes pass through
    assert back["b"].shape == (2, 2, 3) and back["c"][0].shape == (2,)
    torch.testing.assert_close(back["b"][1], 2 * init["b"])


# ---------------------------------------------------------------------------
# The samplers on Gaussian targets: moments within Monte-Carlo error.
# ---------------------------------------------------------------------------


def log_prob(p):
    return -0.5 * torch.sum(torch.square((p["x"] - t64(MU)) / t64(SD)))


@pytest.mark.parametrize("sampler", ["nuts", "hmc"])
def test_gaussian_moments(sampler):
    samples, info = run_mcmc(0, log_prob, {"x": torch.zeros(3, dtype=torch.float64)},
                             num_chains=16, num_warmup=400, num_samples=400, sampler=sampler,
                             num_leapfrog=16, device="cpu")
    assert samples["x"].shape == (400, 16, 3)
    x = samples["x"].reshape(-1, 3).numpy()
    np.testing.assert_allclose(x.mean(0), MU, atol=0.1)
    np.testing.assert_allclose(x.std(0), SD, atol=0.15)
    assert torch.isfinite(info.accept_prob).all()


def test_nuts_accept_near_target():
    _, info = run_mcmc(1, log_prob, {"x": torch.zeros(3, dtype=torch.float64)}, num_chains=8,
                       num_warmup=500, num_samples=200, target_accept=0.8, device="cpu")
    assert 0.6 < float(info.accept_prob.mean()) < 0.99
    assert info.num_steps.dtype == torch.int32 and int(info.num_steps.max()) < 2**8


def test_correlated_target():
    cov = np.array([[1.0, 0.9], [0.9, 1.0]])
    prec = t64(np.linalg.inv(cov))
    samples, _ = run_mcmc(2, lambda p: -0.5 * p["x"] @ prec @ p["x"],
                          {"x": torch.zeros(2, dtype=torch.float64)}, num_chains=16,
                          num_warmup=500, num_samples=500, device="cpu")
    emp = np.cov(samples["x"].reshape(-1, 2).numpy(), rowvar=False)
    np.testing.assert_allclose(emp, cov, atol=0.15)


def test_pytree_positions():
    def lp(p):
        return -0.5 * (torch.sum(torch.square(p["a"] - 1.0))
                       + torch.sum(torch.square(p["b"]["c"] + 2.0)))

    f64 = {"dtype": torch.float64}
    init = {"a": torch.zeros(2, **f64), "b": {"c": torch.zeros((), **f64)}}
    samples, _ = run_mcmc(3, lp, init, num_chains=8, num_warmup=300, num_samples=300, device="cpu")
    assert samples["a"].shape == (300, 8, 2) and samples["b"]["c"].shape == (300, 8)
    np.testing.assert_allclose(samples["a"].mean((0, 1)).numpy(), [1.0, 1.0], atol=0.1)
    np.testing.assert_allclose(float(samples["b"]["c"].mean()), -2.0, atol=0.1)


def test_find_initial_step_size_scales_with_target():
    def search(sd):
        lp = lambda z: -0.5 * torch.sum(torch.square(z / sd))
        init_fn, _ = nuts(lp)
        z0 = 0.1 * sd * torch.randn(32, 4, generator=torch.Generator().manual_seed(0),
                                    dtype=torch.float64)
        return float(find_initial_step_size(lp, init_fn(z0),
                                            torch.Generator().manual_seed(1)))

    wide, narrow = search(1.0), search(0.01)
    assert 0.05 < wide < 5.0 and 5e-4 < narrow < 5e-2 and narrow < wide / 10


def test_staged_windows_handle_ill_conditioned_target():
    """``test_mcmc.py``'s test: an axis-aligned Gaussian with a 1e4 spread
    in curvature; after the expanding windows the terminal buffer's accept
    statistic is on the 0.8 target and the metric tracks the variances."""
    sd = np.logspace(-2, 0, 6)
    lp = lambda z: -0.5 * torch.sum(torch.square(z / t64(sd)))
    num_chains, num_warmup = 16, 600
    init_fn, step_fn = nuts(lp, max_tree_depth=9)
    adapt = window_adaptation(step_fn, num_warmup=num_warmup, target_accept=0.8)
    z0 = 0.1 * torch.randn(num_chains, 6, generator=torch.Generator().manual_seed(42),
                           dtype=torch.float64) * t64(sd)
    states, step_size, inv_mass, info = adapt(42, init_fn(z0))
    assert abs(float(info.final_accept) - 0.8) < 0.05
    ratio = inv_mass.numpy() / sd**2
    assert np.all(ratio > 0.2) and np.all(ratio < 5.0) and float(step_size) > 0.0
    div = info.divergences_per_window.numpy()
    assert div.shape == (len(thmc._warmup_schedule(num_warmup)[1]) + 2,)
    assert div.sum() < 0.05 * num_chains * num_warmup


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_mcmc(0, log_prob, {"x": torch.zeros(3)}, num_chains=2, num_warmup=2, num_samples=2)


# ---------------------------------------------------------------------------
# The driver: chunks and checkpoints.
# ---------------------------------------------------------------------------


def _target(params):
    return (-0.5 * torch.sum(torch.square(params["x"] - 1.5))
            - 0.5 * torch.sum(torch.square(params["y"] + 0.5) / 0.25))


INIT = {"x": torch.zeros(2, dtype=torch.float64), "y": torch.zeros(3, dtype=torch.float64)}
KW = dict(num_chains=4, num_warmup=27, num_samples=18, initial_step_size=0.5, device="cpu")


def assert_runs_equal(a, b):
    for k in a[0]:
        assert torch.equal(a[0][k], b[0][k])
    for x, y in zip(a[1], b[1]):
        assert torch.equal(x, y)


@pytest.mark.parametrize("sampler", ["hmc", "nuts"])
def test_chunked_matches_single_dispatch(sampler):
    kw = dict(KW, sampler=sampler, num_leapfrog=4, max_tree_depth=4)
    one = run_mcmc(0, _target, INIT, steps_per_dispatch=None, **kw)
    for chunk in (7, 1):
        assert_runs_equal(one, run_mcmc(0, _target, INIT, steps_per_dispatch=chunk, **kw))
    other = run_mcmc(1, _target, INIT, steps_per_dispatch=None, **kw)
    assert not torch.equal(one[0]["x"], other[0]["x"])


@pytest.mark.parametrize("fail_at", [2, 4, 6])
def test_checkpoint_resume(tmp_path, monkeypatch, fail_at):
    """A run interrupted after its ``fail_at``-th checkpoint (in the
    warmup, at its end, in the sampling) resumes to the uninterrupted
    result, bit for bit."""
    kw = dict(KW, sampler="nuts", max_tree_depth=4, steps_per_dispatch=9)
    path = str(tmp_path / "mcmc.npz")
    full = run_mcmc(1, _target, INIT, **kw)
    real_save = thmc.checkpoint.save_pytree
    calls = {"n": 0}

    def exploding_save(p, tree):
        real_save(p, tree)
        calls["n"] += 1
        if calls["n"] == fail_at:
            raise RuntimeError("simulated preemption")

    monkeypatch.setattr(thmc.checkpoint, "save_pytree", exploding_save)
    with pytest.raises(RuntimeError, match="preemption"):
        run_mcmc(1, _target, INIT, checkpoint_path=path, **kw)
    monkeypatch.setattr(thmc.checkpoint, "save_pytree", real_save)
    assert_runs_equal(full, run_mcmc(1, _target, INIT, checkpoint_path=path, **kw))
