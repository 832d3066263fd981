"""The port's sequence-parallel scans in gloo groups of 1, 2 and 4 CPU
processes (``torch_parallel_ranks.py``, suite ``scan``), at
``tests/test_parallel/test_sharded_scan.py``'s N = 256 and models, against
the JAX package's single-device ``GaussianProcess.log_probability`` and
its gradient (the sharded VJP compiles slowly there, so its single-device
functions, with the sequential strategy, are the reference), against the
port's one-rank call, and against the one-process scans.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parallel_ranks as ranks

from tinygp_tpu import GaussianProcess as JaxGP
from tinygp_tpu.kernels import quasisep as jq
from tinygp_tpu_torch.test_utils import assert_allclose

WORLDS = (1, 2, 4)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return ranks.Groups("scan", WORLDS, str(tmp_path_factory.mktemp("scan"))).wait()


@pytest.fixture(scope="module")
def data():
    X, y = ranks.gp_data()
    return jnp.asarray(X), jnp.asarray(y)


@pytest.mark.parametrize("world", (2, 4))
@pytest.mark.parametrize("name", sorted(ranks.SCAN_KERNELS))
def test_sharded_loglik_and_gradient_match(results, data, world, name):
    """Value and gradient in (amp, scale), whole on every rank, against the
    JAX package's single device and the port's one-rank call."""
    X, y = data
    make = ranks.SCAN_KERNELS[name]

    def single(amp, scale):
        return JaxGP(make(jq, amp, scale), X, diag=0.1, assume_sorted=True,
                     parallel=False).log_probability(y)

    value, grads = jax.jit(jax.value_and_grad(single, argnums=(0, 1)))(1.4, 2.1)
    one_rank = results[1][0][name]
    for got in results[world]:
        got = [float(g) for g in got[name]]
        assert_allclose(got[0], float(value))
        assert_allclose(got[1:], [float(g) for g in grads])
        assert_allclose(got, [float(g) for g in one_rank])


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_scans_match_one_process(results, world):
    """The sharded affine and Riccati scans on random operands: each rank's
    slice of the one-process sequential scan."""
    for got in results[world]:
        for key in ("affine", "riccati"):
            assert_allclose(*got[key])


@pytest.mark.parametrize("world", (2, 4))
def test_sharded_loglik_rejects_uneven(results, world):
    assert all(r["uneven"] for r in results[world])


@pytest.mark.parametrize("world", (2, 4))
def test_sharded_loglik_chains(results, data, world):
    """Chains x sequence on a (world / 2, 2) mesh: each rank's chain block
    against per-chain single-device values; the gradient of the sum over
    the chains on every rank against the single-device sum's; the
    validation errors."""
    X, y = data
    scales = [1.3, 2.1, 0.8, 3.0]
    ys = [y, -y, 0.5 * y, y**2 - 1.0]

    def value(s, yy):
        return JaxGP(jq.Matern32(scale=s), X, diag=0.1, assume_sorted=True,
                     parallel=False).log_probability(yy)

    want = np.asarray(jax.jit(jax.vmap(value))(jnp.asarray(scales), jnp.stack(ys)))
    grad = np.asarray(jax.jit(jax.grad(lambda s: jnp.sum(jax.vmap(value)(s, jnp.stack([y, -y])))))(
        jnp.asarray([1.5, 2.5])))
    per_block = 4 // (world // 2)
    for rank, got in enumerate(results[world]):
        block = (rank // 2) * per_block
        assert_allclose(got["chains"], want[block : block + per_block])
        assert_allclose(got["chains_grad"], grad)
        assert all(got["chains_errors"])


def test_to_stacked_ssm_with_previous_points():
    """``to_stacked_ssm(X, X_prev=...)`` against the JAX package, for a
    kernel on the base route and a quasiseparable sum."""
    from tinygp_tpu_torch.kernels import quasisep as tq

    X, _ = ranks.gp_data(n=40)
    X_prev = X - np.random.default_rng(2).uniform(0.01, 0.2, 40)
    for make in ranks.SCAN_KERNELS.values():
        got = make(tq, 1.4, 2.1).to_stacked_ssm(torch.as_tensor(X), X_prev=torch.as_tensor(X_prev))
        want = make(jq, 1.4, 2.1).to_stacked_ssm(jnp.asarray(X), X_prev=jnp.asarray(X_prev))
        for g, w in zip(got, want):
            assert_allclose(g, np.asarray(w))
        # Without X_prev, the first point pairs with itself.
        got = make(tq, 1.4, 2.1).to_stacked_ssm(torch.as_tensor(X))
        want = make(jq, 1.4, 2.1).to_stacked_ssm(jnp.asarray(X))
        for g, w in zip(got, want):
            assert_allclose(g, np.asarray(w))
