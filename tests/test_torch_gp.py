"""The slice end to end: ``GaussianProcess.log_probability`` of the port
against the JAX package on the same data, on the main path's models."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinygp_tpu import GaussianProcess as JaxGP
from tinygp_tpu.kernels import quasisep as jq
from tinygp_tpu_torch import GaussianProcess
from tinygp_tpu_torch.kernels import quasisep as tq
from tinygp_tpu_torch.test_utils import assert_allclose

# (kernel builder, N): the benchmark's Matern32, the flagship SHO and the
# 2-term celerite sum, each built the same way in both packages.
MODELS = {
    "matern32": (lambda q: 1.5 * q.Matern32(scale=2.5), 10_000),
    "sho": (lambda q: 1.2 * q.SHO(omega=1.5, quality=3.0), 8192),
    "celerite2": (
        lambda q: q.Celerite(a=1.0, b=0.1, c=0.5, d=1.0)
        + q.Celerite(a=0.5, b=0.05, c=1.5, d=3.0),
        2000,
    ),
}


def data(n, seed=42):
    rng = np.random.default_rng(seed)
    return np.sort(rng.uniform(0, 10, n)), rng.normal(size=n)


def jax_logprob(kernel, X, y, **kwargs):
    def fn(X, y):
        gp = JaxGP(kernel(jq), X, assume_sorted=True, **kwargs)
        return gp.log_probability(y)

    return float(jax.jit(fn)(jnp.asarray(X), jnp.asarray(y)))


def torch_logprob(kernel, X, y, dtype=torch.float64, **kwargs):
    X = torch.as_tensor(X, dtype=dtype)
    gp = GaussianProcess(kernel(tq), X, assume_sorted=True, device="cpu", **kwargs)
    return gp.log_probability(y)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_log_probability_matches_jax(name):
    kernel, n = MODELS[name]
    X, y = data(n)
    want = jax_logprob(kernel, X, y, diag=0.1)
    got = torch_logprob(kernel, X, y, diag=0.1)
    assert got.dtype == torch.float64
    assert_allclose(got, want)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_log_probability_float32(name):
    kernel, n = MODELS[name]
    X, y = data(n)
    want = jax_logprob(kernel, X, y, diag=0.1)
    got = torch_logprob(kernel, X, y, dtype=torch.float32, diag=0.1)
    assert got.dtype == torch.float32
    assert_allclose(got, np.float64(want))


def test_mean_and_per_point_diag():
    kernel, _ = MODELS["sho"]
    X, y = data(1500, seed=3)
    diag = np.random.default_rng(4).uniform(0.05, 0.2, X.shape[0])
    want = jax_logprob(kernel, X, y, diag=jnp.asarray(diag), mean=0.7)
    got = torch_logprob(kernel, X, y, diag=diag, mean=0.7)
    assert_allclose(got, want)


def test_negative_diag_gives_minus_inf_as_jax():
    kernel, _ = MODELS["matern32"]
    X, y = data(300)
    assert jax_logprob(kernel, X, y, diag=-10.0) == -np.inf
    assert torch_logprob(kernel, X, y, diag=-10.0).item() == -np.inf


def test_unsorted_inputs_raise():
    X, _ = data(50)
    with pytest.raises(ValueError, match="sorted"):
        GaussianProcess(tq.Matern32(scale=1.0), X[::-1].copy(), device="cpu")


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a host without CUDA")
    X, _ = data(50)
    with pytest.raises(RuntimeError, match="CUDA"):
        GaussianProcess(tq.Matern32(scale=1.0), X)
