"""The port's quasiseparable kernels against the JAX package.

Each JAX kernel is described as a tree of numpy arrays, rebuilt in the port
with ``convert.kernel_from_tree``, and both generate the stacked operands
``(d, ps, qs, as_)`` on the same coordinates.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinygp_tpu.kernels import quasisep as jq
from tinygp_tpu_torch.convert import kernel_from_tree
from tinygp_tpu_torch.kernels import quasisep as tq
from tinygp_tpu_torch.test_utils import assert_allclose


def jax_tree(kernel):
    """The port's description of a JAX kernel, from its dataclass fields."""
    params, children = {}, {}
    for f in dataclasses.fields(kernel):
        if f.metadata.get("pytree_static"):
            continue
        value = getattr(kernel, f.name)
        if isinstance(value, jq.Quasisep):
            children[f.name] = jax_tree(value)
        else:
            params[f.name] = np.asarray(value)
    return {"class": type(kernel).__name__, "params": params, "children": children}


KERNELS = {
    "exp": lambda: jq.Exp(scale=1.3, sigma=0.7),
    "matern32": lambda: jq.Matern32(scale=1.8),
    "matern52": lambda: jq.Matern52(scale=0.9, sigma=1.2),
    "cosine": lambda: jq.Cosine(scale=2.5),
    "celerite": lambda: jq.Celerite(a=1.1, b=0.8, c=0.9, d=0.1),
    "sho_under": lambda: jq.SHO(omega=1.5, quality=3.0),
    "sho_over": lambda: jq.SHO(omega=1.5, quality=0.3, sigma=0.8),
    "sho_crit_lo": lambda: jq.SHO(omega=1.5, quality=0.5 - 1e-7),
    "sho_crit_hi": lambda: jq.SHO(omega=1.5, quality=0.5 + 1e-7),
    "scale": lambda: 1.5 * jq.Matern32(scale=2.5),
    "product": lambda: jq.Matern32(scale=1.5) * jq.Cosine(scale=2.5),
    "sum": lambda: jq.Celerite(a=1.0, b=0.1, c=0.5, d=1.0)
    + jq.Celerite(a=0.5, b=0.05, c=1.5, d=3.0),
    "scaled_sum": lambda: 1.3
    * (jq.Matern32(scale=1.0) + jq.SHO(omega=1.5, quality=2.0)),
}


@pytest.fixture(scope="module")
def coords():
    rng = np.random.default_rng(11)
    return np.sort(rng.uniform(0, 10, 200))


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_stacked_ssm_matches_jax(coords, name):
    jk = KERNELS[name]()
    tk = kernel_from_tree(jax_tree(jk), device="cpu", dtype=torch.float64)
    want = jk.to_stacked_ssm(jnp.asarray(coords))
    got = tk.to_stacked_ssm(torch.as_tensor(coords))
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        assert tuple(g.shape) == w.shape
        assert_allclose(g, w)


def test_stacked_ssm_float32(coords):
    jk = KERNELS["sum"]()
    tk = kernel_from_tree(jax_tree(jk), device="cpu", dtype=torch.float32)
    want = jk.to_stacked_ssm(jnp.asarray(coords))
    got = tk.to_stacked_ssm(torch.as_tensor(coords, dtype=torch.float32))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert_allclose(g, w)


@pytest.mark.parametrize("name", ["matern52", "sho_under", "product", "sum"])
def test_evaluate_matches_jax(coords, name):
    jk = KERNELS[name]()
    tk = kernel_from_tree(jax_tree(jk), device="cpu", dtype=torch.float64)
    X1, X2 = coords[:30], coords[::7]
    assert_allclose(tk(torch.as_tensor(X1), torch.as_tensor(X2)), jk(X1, X2))
    assert_allclose(tk(torch.as_tensor(X1)), jk(X1))


def test_algebra_builds_the_same_tree():
    m32 = tq.Matern32(scale=2.5)
    assert sum([m32]) is m32
    k = 1.5 * m32 + tq.Exp(scale=1.0) * tq.Cosine(scale=2.0)
    assert isinstance(k, tq.Sum)
    assert isinstance(k.kernel1, tq.Scale)
    assert isinstance(k.kernel2, tq.Product)
    with pytest.raises(ValueError):
        m32 * torch.ones(2)
    # CARMA converts from its JAX fields, its derived ones recomputed.
    jk = jq.CARMA(alpha=np.array([1.4, 2.3]), beta=np.array([1.0, 0.1]))
    tk = kernel_from_tree(jax_tree(jk), device="cpu")
    assert isinstance(tk, tq.CARMA)
    X = np.linspace(0.0, 5.0, 20)
    for g, w in zip(tk.to_stacked_ssm(torch.as_tensor(X)), jk.to_stacked_ssm(jnp.asarray(X))):
        assert_allclose(g, w)
