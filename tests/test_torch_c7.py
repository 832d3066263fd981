"""The float32 held-out ``predict`` loss of ``chip_smoke.predict_loss``:
``sum(w * mu) + sum(var)`` of ``predict(y, linspace(0, 10, 1000),
return_var=True)`` for ``amp * Matern32(scale)`` at ``(1.5, 2.5)``,
``diag=0.1``, on every ``step``-th point of ``bench.py``'s N = 1e5 draws.

In float32 arithmetic the posterior variance at new points cancels to a
few digits, and the mean loses as many. The JAX package under x64 forms
Matern32's transitions from a NumPy float64 constant, so on float32 inputs
it conditions in float64; the port's float32 process conditions at new
points in float64 too (``gp.py``). Its CPU float32 value and gradient are
held here to its own float64 ones on the same draws (within 1e-5 of the
value, relative, and 5e-4 of the gradient's largest entry), and at
N = 1000 to the JAX package's float32 figures.
"""

import functools

import numpy as np
import pytest
import torch

from tinygp_tpu_torch import GaussianProcess
from tinygp_tpu_torch.kernels import quasisep

THETA = (1.5, 2.5)

# The JAX package's figures at N = 1000, made by tests/c7_reference.py
# (python tests/c7_reference.py 100): value and gradient in (amp, scale)
# of jit(value_and_grad) under x64, on float64 and on float32 inputs.
JAX_N1000 = {
    "float64": (11.559979513930354, (0.6961957705549366, -1.2187642229256634)),
    "float32": (11.559983880580406, (0.69622802734375, -1.218766212463379)),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.cache
def value_and_grad(step, dtype):
    rng = np.random.default_rng(42)
    X = np.sort(rng.uniform(0, 10, 100_000))[::step]
    y = rng.normal(size=100_000)[::step]
    w = np.random.default_rng(7).normal(size=1000)
    X, y, X_test, w = (torch.as_tensor(a, dtype=dtype)
                       for a in (X, y, np.linspace(0, 10, 1000), w))
    th = torch.tensor(THETA, dtype=dtype, requires_grad=True)
    gp = GaussianProcess(th[0] * quasisep.Matern32(scale=th[1]), X, diag=0.1,
                         assume_sorted=True, device="cpu")
    mu, var = gp.predict(y, X_test, return_var=True)
    assert mu.dtype == var.dtype == dtype
    loss = torch.sum(w * mu) + torch.sum(var)
    (grad,) = torch.autograd.grad(loss, th)
    return float(loss.detach()), grad.double().numpy()


def off(got, want):
    return float(np.max(np.abs(np.asarray(got) - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("step", [1000, 100])
def test_float32_predict_loss_holds_to_float64(step):
    """N = 100 and 1000: the float32 value within 1e-5 relative of the
    float64 one and the gradient within 5e-4 of its largest entry."""
    v64, g64 = value_and_grad(step, torch.float64)
    v32, g32 = value_and_grad(step, torch.float32)
    assert abs(v32 - v64) <= 1e-5 * abs(v64)
    assert off(g32, g64) <= 5e-4


def test_predict_loss_against_the_jax_package():
    """N = 1000: float64 to float64 within the tolerance table's 5e-7, and
    float32 to the JAX package's float32 within 1e-5 of the value and 5e-4
    of the gradient's largest entry."""
    for dtype, (value, grad) in JAX_N1000.items():
        v, g = value_and_grad(100, getattr(torch, dtype))
        if dtype == "float64":
            assert abs(v - value) <= 5e-7 * abs(value) and off(g, grad) <= 5e-7
        else:
            assert abs(v - value) <= 1e-5 * abs(value) and off(g, grad) <= 5e-4
