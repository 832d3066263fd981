"""The port's tiled gram builder (``ops.gram``, kernel B7's wrapper, gate and
plain version) against the JAX package's.

On the CPU ``gram_tiled`` runs its plain version; the kernel itself is held
to it on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``). The
inputs are made with numpy from a seed, in float32, and fed to both
packages. Against the JAX builder (Pallas in interpret mode) the tolerance
is its own test's, rtol = atol = 1e-6 (``tests/test_kernels/
test_pallas_gram.py``); the JAX kernels' own ``kernel(X1, X2)``, which that
file holds the builder to, is the cheaper reference for the rest, at the
same tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinygp_tpu import kernels as jk
from tinygp_tpu import transforms as jt
from tinygp_tpu.kernels.distance import Distance as JaxDistance
from tinygp_tpu.ops.pallas_gram import gram_tiled as jax_gram_tiled
from tinygp_tpu_torch import kernels as tk
from tinygp_tpu_torch import transforms as tt
from tinygp_tpu_torch.convert import kernel_from_tree
from tinygp_tpu_torch.ops import gram


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
    """The port's kernel, its hyperparameters in float64 (the port's own
    default for Python numbers), which ``gram_tiled`` casts to float32."""
    return kernel_from_tree(jax_tree(jax_kernel), device="cpu", dtype=torch.float64)


def check(got, want):
    assert got.dtype == torch.float32 and tuple(got.shape) == np.shape(want)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def points(seed, *shapes, low=-2.0, high=2.0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(low, high, shape).astype(np.float32) for shape in shapes]


# -- against the JAX builder, on its own test's four cases --------------------

BUILDER = {
    "matern32": lambda: 1.3 * jk.Matern32(scale=1.7),
    "expsq": lambda: jk.ExpSquared(scale=0.8),
    "composite": lambda: jk.ExpSineSquared(scale=2.0, gamma=0.9)
    + jk.RationalQuadratic(alpha=1.1),
}


@pytest.mark.parametrize("name", sorted(BUILDER))
def test_matches_jax_builder_1d(name):
    rng = np.random.default_rng(0)
    X1 = rng.uniform(0, 10, 21).astype(np.float32)
    X2 = rng.uniform(0, 10, 13).astype(np.float32)
    jax_kernel = BUILDER[name]()
    want = jax_gram_tiled(jax_kernel, jnp.asarray(X1), jnp.asarray(X2), tile=8, interpret=True)
    got = gram.gram_tiled(port(jax_kernel), torch.as_tensor(X1), torch.as_tensor(X2), tile=8)
    check(got, want)


def test_matches_jax_builder_2d_inputs():
    rng = np.random.default_rng(1)
    X1 = rng.normal(size=(17, 3)).astype(np.float32)
    X2 = rng.normal(size=(9, 3)).astype(np.float32)
    jax_kernel = jk.ExpSquared(scale=1.2)
    want = jax_gram_tiled(jax_kernel, jnp.asarray(X1), jnp.asarray(X2), tile=8, interpret=True)
    got = gram.gram_tiled(port(jax_kernel), torch.as_tensor(X1), torch.as_tensor(X2), tile=8)
    check(got, want)


# -- against the JAX kernels' own matrix ----------------------------------------

STATIONARY = {
    "Exp": dict(scale=1.3),
    "ExpSquared": dict(scale=0.8),
    "Matern32": dict(scale=1.8),
    "Matern52": dict(scale=0.9),
    "Cosine": dict(scale=2.5),
    "ExpSineSquared": dict(scale=1.7, gamma=0.6),
    "RationalQuadratic": dict(scale=1.2, alpha=1.5),
}


@pytest.mark.parametrize("shape", [(), (3,)], ids=["N", "Nx3"])
@pytest.mark.parametrize("distance", ["L1Distance", "L2Distance"])
@pytest.mark.parametrize("name", sorted(STATIONARY))
def test_leaf_matches_jax(name, distance, shape):
    X1, X2 = points(5, (23, *shape), (16, *shape))
    jax_kernel = getattr(jk, name)(distance=getattr(jk, distance)(), **STATIONARY[name])
    kernel = port(jax_kernel)
    assert type(kernel.distance) is getattr(tk, distance)
    T1, T2 = torch.as_tensor(X1), torch.as_tensor(X2)
    assert gram.supports_tiled_gram(kernel, T1, T2)
    check(gram.gram_tiled(kernel, T1, T2), jax_kernel(jnp.asarray(X1), jnp.asarray(X2)))
    # A point against itself: the differences are exactly zero, so the
    # diagonal is exactly the variance.
    assert torch.equal(gram.gram_tiled(kernel, T1, T1).diagonal(), torch.ones(23))


ROOTS = {
    "linear_vector": lambda: jt.Linear(
        scale=np.array([2.0, 0.5, 1.3], np.float32), kernel=jk.ExpSquared(scale=1.1)
    ),
    "linear_matrix": lambda: jt.Linear(
        scale=np.array([[1.0, 0.2, 0.0], [0.0, 0.7, 0.1]], np.float32),
        kernel=jk.Matern32(scale=1.2),
    ),
    "cholesky_matrix": lambda: jt.Cholesky.from_parameters(
        jnp.array([1.5, 0.7, 2.0], jnp.float32),
        jnp.array([0.3, -0.2, 0.4], jnp.float32),
        jk.Matern52(scale=1.1),
    ),
    "subspace": lambda: jt.Subspace(axis=np.array([0, 2]), kernel=jk.Exp(scale=1.4)),
    "nested": lambda: jt.Linear(
        scale=np.array([0.8, 1.7, 0.4], np.float32),
        kernel=jt.Subspace(axis=np.array([2, 1]), kernel=0.5 * jk.Matern32(scale=0.9)),
    ),
}


@pytest.mark.parametrize("name", sorted(ROOTS))
def test_root_transform_matches_jax(name):
    X1, X2 = points(3, (19, 3), (11, 3))
    jax_kernel = ROOTS[name]()
    kernel = port(jax_kernel)
    assert type(kernel).__name__ == type(jax_kernel).__name__
    check(
        gram.gram_tiled(kernel, torch.as_tensor(X1), torch.as_tensor(X2)),
        jax_kernel(jnp.asarray(X1), jnp.asarray(X2)),
    )


def composite(k):
    """A three-deep tree of sums and products over four leaves."""
    return (1.3 * k.Matern32(scale=1.7) + k.Exp(scale=0.9)) * (
        k.ExpSquared(scale=1.1) + 0.5 * k.Cosine(scale=2.0)
    )


@pytest.mark.parametrize("shape", [(), (3,)], ids=["N", "Nx3"])
def test_composite_tree_matches_jax(shape):
    X1, X2 = points(6, (23, *shape), (16, *shape))
    jax_kernel = composite(jk)
    kernel = port(jax_kernel)
    assert type(kernel) is type(composite(tk)) is tk.Product
    check(
        gram.gram_tiled(kernel, torch.as_tensor(X1), torch.as_tensor(X2)),
        jax_kernel(jnp.asarray(X1), jnp.asarray(X2)),
    )


# -- gradients ---------------------------------------------------------------


def test_gradients_match_jax_builder():
    # tests/test_kernels/test_pallas_gram.py's gradient test, through both
    # builders.
    rng = np.random.default_rng(2)
    X = rng.uniform(0, 5, 12).astype(np.float32)
    w = np.arange(12.0, dtype=np.float32)

    def jax_loss(scale):
        K = jax_gram_tiled(jk.Matern32(scale=scale), jnp.asarray(X), jnp.asarray(X), tile=8,
                           interpret=True)
        return jnp.sum(jnp.sin(K) * w)

    want = jax.grad(jax_loss)(jnp.float32(1.4))
    scale = torch.tensor(1.4, dtype=torch.float32, requires_grad=True)
    Xt = torch.as_tensor(X)
    K = gram.gram_tiled(tk.Matern32(scale=scale), Xt, Xt, tile=8)
    (got,) = torch.autograd.grad((torch.sin(K) * torch.as_tensor(w)).sum(), scale)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_gradients_in_x1_and_amplitude_match_jax_builder():
    X1, X2 = points(8, (12, 2), (9, 2), low=0.0, high=5.0)
    w = np.arange(9.0, dtype=np.float32)

    def jax_loss(amp, X1):
        k = jk.Constant(amp) * jk.Matern32(scale=jnp.float32(1.3))
        K = jax_gram_tiled(k, X1, jnp.asarray(X2), tile=8, interpret=True)
        return jnp.sum(jnp.sin(K) * w)

    want_amp, want_x1 = jax.grad(jax_loss, argnums=(0, 1))(jnp.float32(0.7), jnp.asarray(X1))
    # A float64 amplitude, as the port stores a Python number: its cotangent
    # comes back in float64.
    amp = torch.tensor(0.7, dtype=torch.float64, requires_grad=True)
    x1 = torch.as_tensor(X1).requires_grad_(True)
    k = tk.Constant(amp) * tk.Matern32(scale=torch.tensor(1.3, dtype=torch.float32))
    K = gram.gram_tiled(k, x1, torch.as_tensor(X2))
    got_amp, got_x1 = torch.autograd.grad((torch.sin(K) * torch.as_tensor(w)).sum(), (amp, x1))
    assert got_amp.dtype == torch.float64 and got_x1.dtype == torch.float32
    np.testing.assert_allclose(float(got_amp), float(want_amp), rtol=1e-5)
    np.testing.assert_allclose(got_x1.numpy(), np.asarray(want_x1), rtol=1e-5, atol=1e-6)


def test_gradients_reach_root_transforms_and_both_inputs():
    X1, X2 = points(9, (10, 3), (7, 3))
    leaves = {
        "scale": torch.tensor([2.0, 0.5, 1.3], dtype=torch.float64),
        "length": torch.tensor(1.1, dtype=torch.float64),
        "X1": torch.as_tensor(X1),
        "X2": torch.as_tensor(X2),
    }

    def grads(builder):
        ts = {k: v.clone().requires_grad_(True) for k, v in leaves.items()}
        k = tt.Linear(ts["scale"], tk.ExpSquared(scale=ts["length"]))
        K = builder(k, ts["X1"], ts["X2"])
        return torch.autograd.grad(torch.sin(K).sum(), list(ts.values()))

    got = grads(gram.gram_tiled)
    want = grads(gram.plain_gram)
    for g, v in zip(got, want):
        assert g.dtype == v.dtype
        torch.testing.assert_close(g, v, rtol=1e-6, atol=1e-6)


def test_second_derivative_raises():
    scale = torch.tensor(1.4, requires_grad=True)
    X = torch.linspace(0, 3, 6)
    K = gram.gram_tiled(tk.Matern32(scale=scale), X, X)
    (g,) = torch.autograd.grad(K.sum(), scale, create_graph=True)
    with pytest.raises(RuntimeError):
        g.backward()


# -- the gate ------------------------------------------------------------------


def test_gate_mirrors_jax_refusals():
    k = tk.Matern32(scale=1.0)
    X32 = torch.zeros(4)
    assert gram.supports_tiled_gram(k, X32, X32)
    # The JAX test's refusals: tuple (pytree) inputs and 3-d inputs.
    assert not gram.supports_tiled_gram(k, (X32, X32), X32)
    assert not gram.supports_tiled_gram(k, torch.zeros(4, 2, 2), X32)
    # A numpy array is not a tensor; float64 inputs are refused.
    assert not gram.supports_tiled_gram(k, np.zeros(4, np.float32), X32)
    assert not gram.supports_tiled_gram(k, torch.zeros(4, dtype=torch.float64), X32)
    assert not gram.supports_tiled_gram(k, torch.zeros(4, 2), torch.zeros(3, 3))
    # Float64 hyperparameters are accepted (cast to float32), where the JAX
    # gate refuses strong float64 ones.
    k64 = tk.Matern32(scale=torch.tensor(1.0, dtype=torch.float64))
    assert k64.scale.dtype == torch.float64 and gram.supports_tiled_gram(k64, X32, X32)
    assert not gram.supports_tiled_gram(tk.Matern32(scale=torch.ones(2)), X32, X32)
    with pytest.raises(ValueError, match="float32"):
        gram.gram_tiled(k, torch.zeros(4, dtype=torch.float64), X32)


REFUSED = {
    "dot_product": lambda: tk.DotProduct(),
    "polynomial": lambda: tk.Polynomial(order=2.0),
    "custom": lambda: tk.Custom(lambda x, y: torch.sum(x * y, dim=-1)),
    "callable_transform": lambda: tt.Transform(torch.sin, tk.ExpSquared()),
    "transform_below_sum": lambda: tk.Matern32() + tt.Linear(2.0, tk.Exp()),
    "quasisep_in_sum": lambda: tk.ExpSquared() + tk.quasisep.Matern32(scale=1.5),
    "unit_distance": lambda: tk.Matern32(distance=tk.distance.UnitDistance()),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_gate_refuses_kernels_outside_the_set(name):
    X = torch.linspace(0, 1, 5)
    kernel = REFUSED[name]()
    assert not gram.supports_tiled_gram(kernel, X, X)
    before = dict(gram.LAUNCHES)
    with pytest.raises(ValueError, match="tiled gram builder"):
        gram.gram_tiled(kernel, X, X)
    assert gram.LAUNCHES == before


def test_stack_depth_and_node_count_are_capped():
    X = torch.linspace(0, 1, 5)
    # A right-nested sum keeps every leaf on the stack until the end.
    deep = tk.Matern32()
    for _ in range(gram.MAX_STACK - 1):
        deep = tk.Exp() + deep
    assert gram.supports_tiled_gram(deep, X, X)
    torch.testing.assert_close(gram.gram_tiled(deep, X, X), gram.plain_gram(deep, X, X))
    deeper = tk.Exp() + deep
    assert not gram.supports_tiled_gram(deeper, X, X)
    with pytest.raises(ValueError, match="stack deeper"):
        gram.gram_tiled(deeper, X, X)
    # A left-nested sum needs a stack of two however long it is, but B7's
    # program holds at most MAX_OPS nodes.
    wide = sum(tk.Exp(scale=1.0 + i) for i in range(gram.MAX_OPS // 2))
    assert gram.supports_tiled_gram(wide, X, X)
    wider = wide + tk.Exp() + tk.Exp()
    with pytest.raises(ValueError, match="more than"):
        gram.gram_tiled(wider, X, X)


def test_features_and_tile_are_checked():
    k = tk.ExpSquared()
    wide = torch.zeros(3, gram.MAX_D + 1)
    assert not gram.supports_tiled_gram(k, wide, wide)
    # A subspace brings the points back within the limit.
    sub = tt.Subspace(axis=np.arange(gram.MAX_D), kernel=k)
    assert gram.supports_tiled_gram(sub, wide, wide)
    X = torch.linspace(0, 1, 5)
    for tile in (0, -8, 2.5, True, "8"):
        with pytest.raises(ValueError, match="tile"):
            gram.gram_tiled(k, X, X, tile=tile)
    # tile changes no result.
    assert torch.equal(gram.gram_tiled(k, X, X, tile=1), gram.gram_tiled(k, X, X, tile=256))


def test_cpu_runs_the_plain_version():
    X1, X2 = points(11, (9,), (4,))
    k = composite(tk)
    T1, T2 = torch.as_tensor(X1), torch.as_tensor(X2)
    before = dict(gram.LAUNCHES)
    got = gram.gram_tiled(k, T1, T2)
    assert gram.LAUNCHES == before
    assert torch.equal(got, gram.plain_gram(k, T1, T2))
    # The plain version is the kernel's own matrix in float32 arithmetic.
    torch.testing.assert_close(got.double(), k(T1.double(), T2.double()), rtol=1e-6, atol=1e-6)


# -- the program, built once per tree structure ---------------------------------


def widest(k):
    """The largest tree B7 takes: MAX_STACK leaves right-nested (every one
    on the stack at once), then leaves summed on the left up to 63 nodes,
    the most below MAX_OPS (a tree of sums and products has an odd count)."""
    tree = k.Matern32(scale=1.3)
    for i in range(gram.MAX_STACK - 1):
        tree = k.Exp(scale=1.0 + i) + tree
    nodes = 2 * gram.MAX_STACK - 1
    i = 0
    while nodes + 2 <= gram.MAX_OPS:
        tree = tree + k.Matern52(scale=2.0 + 0.1 * i)
        nodes += 2
        i += 1
    return tree


# (the tree, nodes, B7's ops with each constant factor of a leaf fused:
# (opcode, metric, parameter offset, the factor's offset or -1), the
# deepest B7's stack gets)
DEPTHS = {
    "leaf": (lambda k: k.Matern32(scale=1.7), 1, [(5, 0, 0, -1)], 1),
    "constant times leaf": (lambda k: 1.5 * k.Matern32(scale=2.5), 3, [(5, 0, 1, 0)], 1),
    "leaf times constant": (lambda k: k.Matern32(scale=2.5) * 1.5, 3, [(5, 0, 0, 1)], 1),
    "constant plus leaf": (lambda k: 1.5 + k.Matern32(scale=2.5), 3,
                           [(0, 0, 0, -1), (5, 0, 1, -1), (1, 0, 0, -1)], 2),
    # (1.3 M32 + Exp) (ExpSq + 0.5 Cos): the postfix C M32 * Exp + ExpSq C Cos * + *,
    # four deep, fused to M32c Exp + ExpSq Cosc + *, three deep.
    "composite": (composite, 11, [(5, 0, 1, 0), (3, 0, 2, -1), (1, 0, 0, -1), (4, 1, 3, -1),
                                  (7, 0, 5, 4), (1, 0, 0, -1), (2, 0, 0, -1)], 3),
    "deepest and widest": (widest, gram.MAX_OPS - 1, None, gram.MAX_STACK),
}


@pytest.mark.parametrize("name", sorted(DEPTHS))
def test_program_depth_and_size(name):
    build, nodes, fused, depth = DEPTHS[name]
    X = torch.linspace(0, 3, 7)
    kernel = build(tk)
    assert gram.supports_tiled_gram(kernel, X, X)
    _, _, ops, params, _ = gram._compile(kernel, X, X)
    assert len(ops) == nodes
    prog = gram._program(ops)
    got = list(zip(prog.op, prog.metric, prog.param, prog.factor))[:prog.n_ops]
    assert got == gram._fused(ops) and (fused is None or got == fused)
    assert (prog.depth, prog.n_params) == (depth, len(params))
    torch.testing.assert_close(gram.gram_tiled(kernel, X, X), gram.plain_gram(kernel, X, X))


PAIRS = {
    # (second tree, same program): the first is 1.5 * Matern32(scale=2.5).
    "other values": (lambda: 0.3 * tk.Matern32(scale=0.9), True),
    "float32 values": (lambda: tk.Constant(torch.tensor(0.3)) * tk.Matern32(
        scale=torch.tensor(0.9)), True),
    "other leaf": (lambda: 1.5 * tk.Matern52(scale=2.5), False),
    "other metric": (lambda: 1.5 * tk.Matern32(scale=2.5, distance=tk.L2Distance()), False),
    "other order": (lambda: tk.Matern32(scale=2.5) * 1.5, False),
    "sum for product": (lambda: 1.5 + tk.Matern32(scale=2.5), False),
}


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_programs_are_shared_by_structure_only(name):
    """Trees of one structure share one cached program and differ only in
    their parameter vectors; a structural change gives a new program."""
    build, same = PAIRS[name]
    X = torch.linspace(0, 3, 7)
    first, second = 1.5 * tk.Matern32(scale=2.5), build()
    _, _, ops1, params1, _ = gram._compile(first, X, X)
    _, _, ops2, params2, _ = gram._compile(second, X, X)
    assert (gram._program(ops1) is gram._program(ops2)) is same
    vec1, vec2 = gram._param_vector(params1, X.device), gram._param_vector(params2, X.device)
    assert vec1.dtype == vec2.dtype == torch.float32
    assert vec1.tolist() == [1.5, 2.5]
    if same:
        np.testing.assert_array_equal(vec2.numpy(), np.float32([0.3, 0.9]))
    torch.testing.assert_close(gram.gram_tiled(second, X, X), gram.plain_gram(second, X, X))


@pytest.mark.parametrize("how", ["in place", "replaced"])
def test_parameter_vector_reads_the_values_of_each_call(how):
    X = torch.linspace(0, 3, 7)
    kernel = 1.5 * tk.Matern32(scale=2.5)
    _, _, ops, params, _ = gram._compile(kernel, X, X)
    before = gram._param_vector(params, X.device)
    if how == "in place":
        kernel.kernel2.scale.fill_(0.5)
    else:
        kernel.kernel2.scale = torch.tensor(0.5, dtype=torch.float64)
    _, _, ops_after, params_after, _ = gram._compile(kernel, X, X)
    assert gram._program(ops_after) is gram._program(ops)
    assert before.tolist() == [1.5, 2.5]
    assert gram._param_vector(params_after, X.device).tolist() == [1.5, 0.5]


def with_parameter(where):
    """A tree with one ``nn.Parameter`` registered at ``where`` (or, for
    "none", a parameter registered as None, which holds no value)."""
    kernel = tt.Linear(torch.tensor(2.0), 1.5 * tk.Matern32(scale=2.5))
    node = {"root": kernel, "constant": kernel.kernel.kernel1, "leaf": kernel.kernel.kernel2,
            "distance": kernel.kernel.kernel2.distance, "none": kernel.kernel.kernel2}[where]
    node.register_parameter("extra", None if where == "none" else
                            torch.nn.Parameter(torch.tensor(1.0)))
    return kernel


@pytest.mark.parametrize("where", ["root", "constant", "leaf", "distance", "none"])
def test_gate_refuses_parameters_anywhere_in_the_tree(where):
    # The gate's rule: no nn.Parameter anywhere in the module tree, as
    # ``kernel.parameters()`` finds them.
    X = torch.linspace(0, 1, 5)
    kernel = with_parameter(where)
    holds = next(kernel.parameters(), None) is not None
    assert holds is (where != "none")
    assert gram.supports_tiled_gram(kernel, X, X) is not holds
    if holds:
        with pytest.raises(ValueError, match="buffers"):
            gram.gram_tiled(kernel, X, X)
