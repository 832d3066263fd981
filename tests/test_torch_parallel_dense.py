"""The port's tensor-parallel dense Cholesky in gloo groups of 2 and 4
CPU processes (``torch_parallel_ranks.py``, suite ``dense``), at
``tests/test_parallel/test_dense_tp.py``'s sizes, against
``jnp.linalg.cholesky`` and its gradient on the same numpy input.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_parallel_ranks as ranks

WORLDS = (2, 4)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return ranks.Groups("dense", WORLDS, str(tmp_path_factory.mktemp("dense"))).wait()


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("n,block", [(512, 64), (512, 128)])
def test_matches_single_device(results, world, n, block):
    """Each rank's column block, side by side, is the factor."""
    rng = np.random.default_rng(7)
    A = rng.normal(size=(n, n)) / np.sqrt(n)
    want = np.asarray(jnp.linalg.cholesky(jnp.asarray(A @ A.T + np.eye(n))))
    blocks = [r[(n, block)].numpy() for r in results[world]]
    assert all(b.shape == (n, n // world) for b in blocks)
    np.testing.assert_allclose(np.concatenate(blocks, axis=1), want, atol=1e-8)


@pytest.mark.parametrize("world", WORLDS)
def test_reverse_mode_grad_matches_native(results, world):
    """The gradient of the sum of the factor, whole on every rank: the
    broadcasts' adjoints and the input's group sum."""
    n = 256
    A = jnp.asarray(np.random.default_rng(3).normal(size=(n, n)) / np.sqrt(n))

    def f_ref(A):
        return jnp.sum(jnp.tril(jnp.linalg.cholesky(A @ A.T + jnp.eye(n, dtype=A.dtype))))

    want = np.asarray(jax.grad(f_ref)(A))
    for r in results[world]:
        assert np.all(np.isfinite(r["grad"].numpy()))
        np.testing.assert_allclose(r["grad"].numpy(), want, atol=1e-8)


@pytest.mark.parametrize("world", WORLDS)
def test_uneven_raises(results, world):
    assert all(r["uneven"] for r in results[world])
