"""The port's dense kernels, their algebra and the input transforms against
the JAX package.

Each JAX kernel is described as a tree of numpy arrays by walking its
dataclass fields, rebuilt in the port with ``convert.kernel_from_tree``,
and both build the matrix and the diagonal on the same float64
coordinates, ``(N,)`` and ``(N, 3)``; the tolerance is the float64 entry of
the table (5e-7).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinygp_tpu import kernels as jk
from tinygp_tpu import transforms as jt
from tinygp_tpu.kernels.distance import Distance as JaxDistance
from tinygp_tpu_torch import kernels as tk
from tinygp_tpu_torch import transforms as tt
from tinygp_tpu_torch.convert import kernel_from_tree
from tinygp_tpu_torch.kernels import quasisep as tq
from tinygp_tpu_torch.test_utils import assert_allclose


def jax_tree(obj):
    """The port's description of a JAX kernel, distance or transform."""
    params, children, static = {}, {}, {}
    for f in dataclasses.fields(obj):
        value = getattr(obj, f.name)
        if f.metadata.get("pytree_static"):
            static[f.name] = value
        elif isinstance(value, jk.Kernel | JaxDistance):
            children[f.name] = jax_tree(value)
        else:
            params[f.name] = np.asarray(value)
    module = type(obj).__module__.rsplit(".", 1)[1]
    return {
        "class": f"{module}.{type(obj).__name__}",
        "params": params,
        "children": children,
        "static": static,
    }


def port(jax_kernel):
    return kernel_from_tree(jax_tree(jax_kernel), device="cpu", dtype=torch.float64)


@pytest.fixture(scope="module", params=[(), (3,)], ids=["N", "Nx3"])
def coords(request):
    rng = np.random.default_rng(5)
    shape = request.param
    return rng.uniform(-2, 2, (40, *shape)), rng.uniform(-2, 2, (25, *shape))


def check(jax_kernel, torch_kernel, X1, X2):
    want = jax_kernel(jnp.asarray(X1), jnp.asarray(X2))
    got = torch_kernel(torch.as_tensor(X1), torch.as_tensor(X2))
    assert got.dtype == torch.float64 and tuple(got.shape) == want.shape
    assert_allclose(got, want)
    assert_allclose(torch_kernel(torch.as_tensor(X1)), jax_kernel(jnp.asarray(X1)))


STATIONARY = {
    "Exp": dict(scale=1.3),
    "ExpSquared": dict(scale=0.8),
    "Matern32": dict(scale=1.8),
    "Matern52": dict(scale=0.9),
    "Cosine": dict(scale=2.5),
    "ExpSineSquared": dict(scale=1.7, gamma=0.6),
    "RationalQuadratic": dict(scale=1.2, alpha=1.5),
}


@pytest.mark.parametrize("distance", ["L1Distance", "L2Distance"])
@pytest.mark.parametrize("name", sorted(STATIONARY))
def test_stationary_matches_jax(coords, name, distance):
    jax_kernel = getattr(jk, name)(distance=getattr(jk, distance)(), **STATIONARY[name])
    torch_kernel = port(jax_kernel)
    assert type(torch_kernel) is getattr(tk, name)
    assert type(torch_kernel.distance) is getattr(tk, distance)
    check(jax_kernel, torch_kernel, *coords)


@pytest.mark.parametrize("name", ["ExpSquared", "RationalQuadratic", "Matern32"])
def test_default_distance_matches_jax(name):
    rng = np.random.default_rng(1)
    X = rng.uniform(-2, 2, (30, 3))
    jax_kernel = getattr(jk, name)(**STATIONARY[name])
    torch_kernel = getattr(tk, name)(**STATIONARY[name])
    check(jax_kernel, torch_kernel, X, X[:7])


ALGEBRA = {
    "sum_product": lambda k: 1.5 * k.Matern32(scale=2.5) + 0.3 * k.ExpSquared(scale=1.0),
    "constant": lambda k: k.Constant(0.7),
    "dot_product": lambda k: k.DotProduct(),
    "polynomial": lambda k: k.Polynomial(order=2.0, scale=1.5, sigma=0.3),
    "scalar_sum": lambda k: k.Matern52(scale=1.1) + 0.2,
    "product_of_kernels": lambda k: k.Exp(scale=2.0) * k.Cosine(scale=3.0),
}


@pytest.mark.parametrize("name", sorted(ALGEBRA))
def test_algebra_matches_jax(coords, name):
    jax_kernel = ALGEBRA[name](jk)
    torch_kernel = port(jax_kernel)
    # The operators build the same tree in the port.
    built = ALGEBRA[name](tk)
    assert type(built) is type(torch_kernel)
    check(jax_kernel, torch_kernel, *coords)
    check(jax_kernel, built, *coords)


def test_custom_matches_jax(coords):
    jax_kernel = jk.Custom(lambda x, y: jnp.exp(-jnp.sum(jnp.square(x - y))))
    torch_kernel = tk.Custom(lambda x, y: torch.exp(-torch.sum(torch.square(x - y), dim=-1)))
    check(jax_kernel, torch_kernel, *coords)


def test_dense_plus_quasisep_is_a_dense_sum():
    from tinygp_tpu.kernels import quasisep as jq

    rng = np.random.default_rng(2)
    X1, X2 = np.sort(rng.uniform(0, 5, 30)), np.sort(rng.uniform(0, 5, 20))
    jax_kernel = jk.ExpSquared(scale=1.0) + jq.Matern32(scale=1.5)
    torch_kernel = tk.ExpSquared(scale=1.0) + tq.Matern32(scale=1.5)
    assert isinstance(torch_kernel, tk.Sum) and not isinstance(torch_kernel, tq.Quasisep)
    check(jax_kernel, torch_kernel, X1, X2)
    assert_allclose(port(jax_kernel)(torch.as_tensor(X1), torch.as_tensor(X2)),
                    jax_kernel(jnp.asarray(X1), jnp.asarray(X2)))
    # The quasiseparable side still refuses a dense operand, as in JAX.
    with pytest.raises(ValueError, match="non-quasiseparable"):
        tq.Matern32(scale=1.5) + tk.ExpSquared(scale=1.0)
    with pytest.raises(ValueError, match="non-quasiseparable"):
        jq.Matern32(scale=1.5) + jk.ExpSquared(scale=1.0)


TRANSFORMS = {
    "linear_vector": lambda: jt.Linear(scale=np.array([2.0, 0.5, 1.3]), kernel=jk.ExpSquared()),
    "linear_matrix": lambda: jt.Linear(
        scale=np.array([[1.0, 0.2, 0.0], [0.0, 0.7, 0.1], [0.3, 0.0, 1.5]]),
        kernel=jk.Matern32(scale=1.2),
    ),
    "cholesky_diagonal": lambda: jt.Cholesky(factor=np.array([1.5, 0.7, 2.0]), kernel=jk.ExpSquared()),
    "cholesky_packed": lambda: jt.Cholesky.from_parameters(
        jnp.array([1.5, 0.7, 2.0]), jnp.array([0.3, -0.2, 0.4]), jk.Matern52(scale=1.1)
    ),
    "subspace_int": lambda: jt.Subspace(axis=1, kernel=jk.Matern32(scale=0.8)),
    # The JAX Subspace indexes a point with `axis`, so a tuple or a list
    # fails there; a numpy array works.
    "subspace_array": lambda: jt.Subspace(axis=np.array([0, 2]), kernel=jk.ExpSquared(scale=1.4)),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transforms_match_jax(name):
    rng = np.random.default_rng(3)
    X1, X2 = rng.uniform(-2, 2, (30, 3)), rng.uniform(-2, 2, (20, 3))
    jax_kernel = TRANSFORMS[name]()
    torch_kernel = port(jax_kernel)
    assert type(torch_kernel).__name__ == type(jax_kernel).__name__
    check(jax_kernel, torch_kernel, X1, X2)


def test_transform_callable_and_from_parameters():
    rng = np.random.default_rng(4)
    X1, X2 = rng.uniform(-2, 2, (30, 3)), rng.uniform(-2, 2, (20, 3))
    jax_kernel = jt.Transform(lambda x: jnp.sin(x), jk.ExpSquared(scale=0.9))
    torch_kernel = tt.Transform(torch.sin, tk.ExpSquared(scale=0.9))
    check(jax_kernel, torch_kernel, X1, X2)
    packed = tt.Cholesky.from_parameters(
        torch.tensor([1.5, 0.7, 2.0], dtype=torch.float64),
        torch.tensor([0.3, -0.2, 0.4], dtype=torch.float64),
        tk.Matern52(scale=1.1),
    )
    check(TRANSFORMS["cholesky_packed"](), packed, X1, X2)
    with pytest.raises(ValueError, match="strictly-lower"):
        tt.Cholesky.from_parameters(torch.ones(3), torch.ones(2), tk.ExpSquared())


def test_refusals_match_jax():
    X = torch.linspace(0, 1, 5, dtype=torch.float64)
    with pytest.raises(ValueError, match="scalar length scale"):
        tk.Matern32(scale=torch.ones(2))(X, X)
    with pytest.raises(ValueError, match="gamma"):
        tk.ExpSineSquared(scale=1.0)
    with pytest.raises(ValueError, match="alpha"):
        tk.RationalQuadratic(scale=1.0)
    with pytest.raises(ValueError, match="scalar"):
        tk.Constant(torch.ones(2))(X, X)
    with pytest.raises(ValueError, match="no kernel"):
        kernel_from_tree({"class": "stationary.CARMA"}, device="cpu")
    assert sum([tk.Matern32()]).__class__ is tk.Matern32


def test_unit_distance_and_l2_gradient_at_zero():
    X = torch.tensor([[0.0, 1.0], [0.0, 1.0], [2.0, -1.0]], dtype=torch.float64)
    k = tk.Matern32(scale=1.0, distance=tk.distance.UnitDistance())
    assert_allclose(k(X, X), np.full((3, 3), float(k.profile(torch.tensor(1.0)))))
    x = X.clone().requires_grad_(True)
    grad, = torch.autograd.grad(tk.ExpSquared(scale=1.0)(x, x).sum(), x)
    assert torch.isfinite(grad).all()
    r = tk.L2Distance().distance(x[:, None], x[None])
    grad, = torch.autograd.grad(r.sum(), x)
    assert torch.isfinite(grad).all()
