"""Float32 conditioning and sampling at the training points (ROADMAP C8).

For ``1.5 * Matern32(scale=2.5)``, ``diag=0.1``, on every ``step``-th point
of ``bench.py``'s N = 1e5 draws: in float32 arithmetic the posterior
variance at the training points cancels (it was 0.60 of its largest value
off the float64 one at N = 1e4, and negative), and the float32 Cholesky
factor applied to white noise was 9.3e-4 of the largest draw off at
N = 1e5. A float32 quasiseparable process now conditions and samples
through its float64 twin, each result rounded once to float32
(``gp.py``). Held here within 5e-4 of the largest magnitude: at N = 1000
against the JAX package's figures (``tests/c8_reference.py``, x64 on
float32 inputs, its float64 result), at N = 1e4 against the port's own
float64 on the same float32 values.
"""

import functools

import numpy as np
import pytest
import torch

from tinygp_tpu_torch import GaussianProcess
from tinygp_tpu_torch.kernels import quasisep

TOL = 5e-4

# python tests/c8_reference.py 100
JAX_N1000 = {
    "indices": [0, 1, 137, 500, 998, 999],
    "loc": [-0.1627235603504652, -0.1664830573717865, -0.07764004715046616,
            -0.16558717183334284, 0.2294439117507157, 0.23365429520019976],
    "variance": [0.007638816182061303, 0.007064508130856462, 0.0023593504086827366,
                 0.0023062660224351106, 0.007138872426041276, 0.007797583426249144],
    "loc_sum": -33.81423403976689,
    "variance_sum": 2.436246423742634,
    "loc_absmax": 0.25184549268167067,
    "variance_absmax": 0.007797583426249144,
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.cache
def draws(step):
    rng = np.random.default_rng(42)
    X = np.sort(rng.uniform(0, 10, 100_000))[::step]
    y = rng.normal(size=100_000)[::step]
    return X.astype(np.float32), y.astype(np.float32)


def process(step, dtype):
    """The model on the float32 draws in ``dtype``; the float64 one takes
    the float32 value of ``diag`` too, so that both hold the same
    numbers."""
    X, _ = draws(step)
    return GaussianProcess(1.5 * quasisep.Matern32(scale=2.5), torch.as_tensor(X, dtype=dtype),
                           diag=float(np.float32(0.1)), assume_sorted=True, device="cpu")


@functools.cache
def posterior(step, dtype):
    _, y = draws(step)
    return process(step, dtype).condition(torch.as_tensor(y, dtype=dtype)).gp


def off(got, want):
    got, want = (np.asarray(x, dtype=np.float64) for x in (got, want))
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def test_condition_against_the_jax_package():
    """N = 1000: the float32 posterior mean and variance at the stored
    indices within 5e-4 of the JAX result's largest magnitude, their sums
    within n times that."""
    post = posterior(100, torch.float32)
    assert post.loc.dtype == post.variance.dtype == torch.float32
    idx = JAX_N1000["indices"]
    for name, got in (("loc", post.loc), ("variance", post.variance)):
        got = got.double().numpy()
        scale = JAX_N1000[f"{name}_absmax"]
        assert np.max(np.abs(got[idx] - JAX_N1000[name])) <= TOL * scale, name
        assert abs(got.sum() - JAX_N1000[f"{name}_sum"]) <= TOL * scale * got.size, name


@pytest.mark.parametrize("step", [100, 10])
def test_float32_condition_holds_to_float64(step):
    """N = 1000 and 1e4: the float32 mean and variance within 5e-4 of the
    float64 ones' largest magnitude, and no variance negative."""
    p32, p64 = posterior(step, torch.float32), posterior(step, torch.float64)
    assert off(p32.loc, p64.loc) <= TOL
    assert off(p32.variance, p64.variance) <= TOL
    assert float(p32.variance.min()) > 0.0


def test_float32_predict_mean_at_the_training_points():
    """``predict(y)`` without ``X_test`` takes the same float64 route."""
    _, y = draws(10)
    mu = process(10, torch.float32).predict(torch.as_tensor(y))
    assert mu.dtype == torch.float32
    assert off(mu, posterior(10, torch.float64).loc) <= TOL


def reference_draw(gp64, n, seed):
    """The float64 factor applied to the float32 standard-normal draws
    that ``sample`` makes from ``seed``."""
    eps = torch.randn((n, 4), generator=torch.Generator().manual_seed(seed), dtype=torch.float32)
    return gp64.mean + torch.movedim(gp64.solver.dot_triangular(eps.double()), 0, -1)


@pytest.mark.parametrize("step,which", [(10, "prior"), (100, "posterior")])
def test_float32_sample_holds_to_float64(step, which):
    """The prior at N = 1e4 and the posterior at N = 1000 (whose float32
    factor was NaN): four float32 draws within 5e-4 of the float64 factor
    applied to the same draws, all finite."""
    if which == "prior":
        g32, g64 = process(step, torch.float32), process(step, torch.float64)
    else:
        g32, g64 = posterior(step, torch.float32), posterior(step, torch.float64)
    got = g32.sample(torch.Generator().manual_seed(5), (4,))
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    assert off(got, reference_draw(g64, g32.num_data, 5)) <= TOL
