"""The port's MCMC diagnostics and checkpoints against the JAX package's,
on the same numpy arrays (float64, the tolerance table's 5e-7), with the
cases of ``tests/test_samplers/test_diagnostics.py`` and
``test_checkpoint.py``; and the port's own pytree flatten against
``jax.tree_util``."""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinygp_tpu.samplers import diagnostics as jdiag
from tinygp_tpu.utils import checkpoint as jck
from tinygp_tpu_torch.samplers import diagnostics as tdiag
from tinygp_tpu_torch.samplers import effective_sample_size, potential_scale_reduction, summary
from tinygp_tpu_torch.utils import checkpoint as tck
from tinygp_tpu_torch.utils import load_pytree, save_pytree
from tinygp_tpu_torch.utils.tree import tree_flatten, tree_flatten_with_path, tree_unflatten

RTOL = 5e-7


def _ar1(rng, t, c, rho):
    out = np.zeros((t, c))
    out[0] = rng.normal(size=c)
    innov = rng.normal(size=(t, c)) * np.sqrt(1 - rho**2)
    for i in range(1, t):
        out[i] = rho * out[i - 1] + innov[i]
    return out


def _cases():
    """The JAX tests' draws: iid, AR(1), two stuck chains, a drift, and a
    ragged odd length."""
    out = {"iid": np.random.default_rng(0).normal(size=(500, 8)),
           "ar1": _ar1(np.random.default_rng(1), 2000, 8, 0.9)}
    x = np.random.default_rng(2).normal(size=(400, 4))
    x[:, :2] += 5.0
    out["stuck"] = x
    t = 400
    out["drift"] = np.random.default_rng(3).normal(size=(t, 4)) + np.linspace(-2, 2, t)[:, None]
    out["odd"] = np.random.default_rng(5).normal(size=(37, 3))
    return out


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("fn", ["potential_scale_reduction", "effective_sample_size"])
def test_diagnostic_matches_jax(fn, name):
    x = CASES[name]
    want = float(getattr(jdiag, fn)(jnp.asarray(x)))
    got = getattr(tdiag, fn)(x)
    assert got.dtype == torch.float64 and got.shape == ()
    np.testing.assert_allclose(float(got), want, rtol=RTOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_mean_autocovariance_matches_jax(name):
    x = CASES[name]
    want = np.asarray(jdiag._mean_autocovariance(jdiag._split_chains(jnp.asarray(x))))
    got = tdiag._mean_autocovariance(tdiag._split_chains(torch.as_tensor(x)))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=RTOL * np.abs(want).max())


def test_known_answers():
    """The JAX tests' limits, on the port: iid R-hat near 1 and ESS near
    the count, AR(1)'s efficiency, stuck chains and drift flagged."""
    rhat = float(potential_scale_reduction(CASES["iid"]))
    ess = float(effective_sample_size(CASES["iid"]))
    assert abs(rhat - 1.0) < 0.02 and 0.75 * 4000 < ess <= 4000
    expected = 16000 * (1 - 0.9) / (1 + 0.9)
    assert 0.5 * expected < float(effective_sample_size(CASES["ar1"])) < 2.0 * expected
    assert float(potential_scale_reduction(CASES["ar1"])) < 1.05
    assert float(potential_scale_reduction(CASES["stuck"])) > 1.5
    assert float(effective_sample_size(CASES["stuck"])) < 100
    assert float(potential_scale_reduction(CASES["drift"])) > 1.2


def test_summary_matches_jax():
    rng = np.random.default_rng(4)
    samples = {"a": rng.normal(size=(200, 4, 2)), "b": rng.normal(size=(200, 4)),
               "c": [rng.normal(size=(200, 4, 3))]}
    want = jdiag.summary(jax.tree_util.tree_map(jnp.asarray, samples))
    got = summary({k: (torch.as_tensor(v) if k != "c" else [torch.as_tensor(v[0])])
                   for k, v in samples.items()})
    assert list(got) == list(want)
    for key in want:
        for stat in ("rhat", "ess", "mean", "sd"):
            np.testing.assert_allclose(got[key][stat].numpy(), np.asarray(want[key][stat]),
                                       rtol=RTOL)


Pair = collections.namedtuple("Pair", ["first", "second"])

TREES = [
    {"b": np.ones(2), "a": [np.zeros(3), (np.float32(2.0), None)], "c": {"z": 1.0, "y": 2}},
    Pair(first=np.arange(3.0), second={"k": np.eye(2)}),
    [np.ones(()), ()],
]


@pytest.mark.parametrize("tree", TREES, ids=["dict", "namedtuple", "list"])
def test_tree_flatten_matches_jax(tree):
    leaves, spec = tree_flatten(tree)
    want = jax.tree_util.tree_leaves(tree)
    assert len(leaves) == len(want)
    for a, b in zip(leaves, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    paths = [p for p, _ in tree_flatten_with_path(tree)[0]]
    want_paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert paths == want_paths
    back = tree_unflatten(spec, leaves)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)


def test_pytree_roundtrip(tmp_path):
    """``test_checkpoint.py``'s round trip, with tensors: a tensor leaf
    comes back a tensor of its template's dtype, any other leaf an array."""
    tree = {"a": torch.arange(6.0).reshape(2, 3),
            "b": (np.int32(3), torch.ones(4, dtype=torch.bool))}
    path = str(tmp_path / "t.npz")
    save_pytree(path, tree)
    like = {"a": torch.zeros(2, 3), "b": (np.int32(0), torch.zeros(4, dtype=torch.bool))}
    back = load_pytree(path, like)
    assert isinstance(back["a"], torch.Tensor) and back["a"].dtype == torch.float32
    assert isinstance(back["b"][0], np.ndarray)
    for l1, l2 in zip(tree_flatten(tree)[0], tree_flatten(back)[0]):
        np.testing.assert_array_equal(np.asarray(l1), np.asarray(l2))


def test_load_shape_mismatch(tmp_path):
    path = str(tmp_path / "t.npz")
    save_pytree(path, {"a": torch.ones(3)})
    with pytest.raises(ValueError, match="shape"):
        load_pytree(path, {"a": torch.ones(4)})
    with pytest.raises(ValueError, match="leaves"):
        load_pytree(path, {"a": torch.ones(3), "b": torch.ones(1)})


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_cross_read(tmp_path, writer):
    """A file either package writes, the other reads back to the same
    values: the leaves are in the same order."""
    rng = np.random.default_rng(6)
    tree = {"z": rng.normal(size=(4, 3)), "step": np.int32(7),
            "info": (rng.normal(size=5), np.array([True, False]))}
    path = str(tmp_path / "x.npz")
    (jck.save_pytree if writer == "jax" else tck.save_pytree)(path, tree)
    back = (tck.load_pytree if writer == "jax" else jck.load_pytree)(path, tree)
    for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
