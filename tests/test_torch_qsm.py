"""The port's QSM classes (``core.py``), their algebra (``ops.py``) and the
rectangular ``GeneralQSM`` against the JAX package, on the same
well-conditioned random matrices (``test_utils.random_qsm_tree``), carried
across with ``convert.qsm_from_tree``. Float64 at the tolerance table's
5e-7."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinygp_tpu.kernels import quasisep as jq
from tinygp_tpu.solvers.quasisep import core as jcore
from tinygp_tpu.solvers.quasisep import ops as jops
from tinygp_tpu_torch.convert import qsm_from_tree
from tinygp_tpu_torch.kernels import quasisep as tq
from tinygp_tpu_torch.solvers.quasisep import core, ops
from tinygp_tpu_torch.test_utils import assert_allclose, random_qsm_tree

N = 60
CLASSES = [
    "DiagQSM",
    "StrictLowerTriQSM",
    "StrictUpperTriQSM",
    "LowerTriQSM",
    "UpperTriQSM",
    "SquareQSM",
    "SymmQSM",
]


def jax_qsm(tree):
    fields = {k: jnp.asarray(v) for k, v in tree["params"].items()}
    fields.update({k: jax_qsm(v) for k, v in tree["children"].items()})
    return getattr(jcore, tree["class"])(**fields)


def pair(name, m=2, seed=0, n=N):
    """The same random matrix in both packages: (port, JAX)."""
    tree = random_qsm_tree(name, n, m, seed)
    return qsm_from_tree(tree, device="cpu"), jax_qsm(tree)


def rhs(shape, seed=5):
    x = np.random.default_rng(seed).normal(size=shape)
    return torch.tensor(x), jnp.asarray(x)


def assert_same_qsm(got, want):
    """The same class, and the same fields in the same layout. (Cheaper
    than the JAX package's ``to_dense``, which compiles a program per
    class and shape.)"""
    assert type(got).__name__ == type(want).__name__
    leaves, jleaves = got._leaves(), jax.tree_util.tree_leaves(want)
    assert [tuple(x.shape) for x in leaves] == [x.shape for x in jleaves]
    for g, w in zip(leaves, jleaves):
        assert_allclose(g, w)


@pytest.mark.parametrize("name", CLASSES)
def test_to_dense_and_transpose_match_jax(name):
    M, J = pair(name, m=3)
    assert type(M).__name__ == name and M.shape == (N, N)
    assert_allclose(M.to_dense(), J.to_dense())
    assert_allclose(M.T.to_dense(), J.T.to_dense())
    assert type(M.T).__name__ == type(J.T).__name__


@pytest.mark.parametrize("parallel", [True, False], ids=["parallel", "sequential"])
@pytest.mark.parametrize("name", CLASSES)
def test_matmul_matches_jax(name, parallel):
    M, J = pair(name)
    x, xj = rhs((N, 3))
    want = J.matmul(xj)
    assert_allclose(M.matmul(x, parallel=parallel), want)
    if parallel:
        assert_allclose(M @ x, want)
        assert_allclose(M @ x[:, 0], J @ xj[:, 0])
        # x @ M through the free transpose.
        assert_allclose(x.T @ M, xj.T @ J.to_dense())


@pytest.mark.parametrize("parallel", [True, False], ids=["parallel", "sequential"])
@pytest.mark.parametrize("name", ["LowerTriQSM", "UpperTriQSM"])
def test_solve_matches_jax(name, parallel):
    M, J = pair(name, m=3)
    y, yj = rhs((N, 2))
    got = M.solve(y, parallel=parallel)
    assert_allclose(got, J.solve(yj))
    assert_allclose(M.matmul(got), y)


@pytest.mark.parametrize("name", ["LowerTriQSM", "UpperTriQSM", "SquareQSM", "SymmQSM"])
def test_inv_matches_jax(name):
    M, J = pair(name)
    inv = M.inv()
    assert_same_qsm(inv, J.inv())
    assert_allclose(inv.to_dense() @ M.to_dense(), torch.eye(N, dtype=torch.float64))


def test_symm_inv_sequential_matches_parallel():
    M, J = pair("SymmQSM", m=3)
    want = J.inv(parallel=False)
    assert_same_qsm(M.inv(parallel=False), want)
    assert_same_qsm(M.inv(parallel=True), want)


@pytest.mark.parametrize("parallel", [True, False], ids=["parallel", "sequential"])
@pytest.mark.parametrize("m", [1, 2, 4])
def test_cholesky_matches_jax(m, parallel):
    M, J = pair("SymmQSM", m=m)
    L = M.cholesky(parallel=parallel)
    assert_same_qsm(L, J.cholesky(parallel=False))
    assert_allclose(L.to_dense() @ L.to_dense().T, M.to_dense())


def test_gram_matches_jax():
    M, J = pair("SquareQSM")
    G = M.gram()
    assert G.lower.p.shape == (N, 4)
    assert_same_qsm(G, J.gram())
    assert_allclose(G.to_dense(), M.to_dense().T @ M.to_dense())


ARITH = [
    ("SymmQSM", "DiagQSM"),
    ("SymmQSM", "SymmQSM"),
    ("LowerTriQSM", "UpperTriQSM"),
    ("SquareQSM", "SymmQSM"),
    ("StrictLowerTriQSM", "StrictLowerTriQSM"),
]


@pytest.mark.parametrize("names", ARITH, ids="+".join)
def test_add_sub_mul_match_jax(names):
    (A, Aj), (B, Bj) = pair(names[0], seed=1), pair(names[1], seed=2)
    for got, want in [
        (A + B, Aj + Bj), (A - B, Aj - Bj), (A * B, Aj * Bj), (-A, -Aj),
        (2.5 * A, 2.5 * Aj), (A * 0.5, Aj * 0.5),
    ]:
        assert_same_qsm(got, want)
    with pytest.raises(ValueError, match="scalar"):
        A * torch.ones(N, dtype=torch.float64)
    Ad, Bd = A.to_dense(), B.to_dense()
    assert_allclose((A + B).to_dense(), Ad + Bd)
    assert_allclose((A - B).to_dense(), Ad - Bd)
    assert_allclose((A * B).to_dense(), Ad * Bd)


MUL = [
    ("LowerTriQSM", "SymmQSM"),
    ("SquareQSM", "SquareQSM"),
    ("SymmQSM", "SymmQSM"),
    ("DiagQSM", "LowerTriQSM"),
    ("StrictLowerTriQSM", "StrictUpperTriQSM"),
    ("UpperTriQSM", "LowerTriQSM"),
    ("DiagQSM", "DiagQSM"),
]


@pytest.mark.parametrize("names", MUL, ids="@".join)
def test_qsm_mul_matches_jax(names):
    (A, Aj), (B, Bj) = pair(names[0], seed=1), pair(names[1], seed=2)
    got = A @ B
    assert_same_qsm(got, Aj @ Bj)
    assert_allclose(got.to_dense(), A.to_dense() @ B.to_dense())


def test_condition_algebra_matches_jax():
    """The posterior algebra of conditioning, term by term:
    ``(M + noise) - (L^-1 M)^T (L^-1 M)`` with order 4m."""
    (M, Mj), (K, Kj) = pair("SymmQSM", seed=1), pair("SymmQSM", seed=2)
    Linv, Linvj = K.cholesky().inv(), Kj.cholesky().inv()
    prod, prodj = Linv @ M, Linvj @ Mj
    assert_same_qsm(prod, prodj)
    delta = prod.gram()
    post = (M + core.DiagQSM(d=torch.full((N,), 0.1, dtype=torch.float64))) - delta
    postj = (Mj + jcore.DiagQSM(d=jnp.full((N,), 0.1))) - prodj.gram()
    assert post.lower.p.shape == (N, 8)
    assert_same_qsm(post, postj)
    Kd = K.to_dense()
    Md = M.to_dense()
    assert_allclose(post.to_dense(), Md + 0.1 * torch.eye(N) - Md @ torch.linalg.solve(Kd, Md))


ALIASES = [
    "lower_matmul", "lower_matmul_parallel", "upper_matmul", "upper_matmul_parallel",
    "lower_solve", "lower_solve_parallel", "upper_solve", "upper_solve_parallel",
    "cholesky", "cholesky_parallel", "symm_inv", "symm_inv_parallel",
]


@pytest.mark.parametrize("name", ALIASES)
def test_ops_aliases_match_jax(name):
    tree = random_qsm_tree("SymmQSM", N, 2, seed=3)
    d = tree["children"]["diag"]["params"]["d"]
    p, q, a = (tree["children"]["lower"]["params"][k] for k in "pqa")
    x = np.random.default_rng(4).normal(size=(N, 2))
    if "matmul" in name:
        args = (p, q, a, x)
    elif "solve" in name:
        args = (d, p, q, a, x)
    else:
        args = (d, p, q, a)
    want = getattr(jops, name)(*map(jnp.asarray, args))
    got = getattr(ops, name)(*(torch.tensor(v) for v in args))
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_allclose(g, w)


# ---------------------------------------------------------------------------
# Rectangular matrices and the kernels' QSM forms.
# ---------------------------------------------------------------------------

KERNELS = {
    "matern32": lambda q: 1.5 * q.Matern32(scale=2.5),
    "celerite2": lambda q: q.Celerite(a=1.0, b=0.1, c=0.5, d=1.0)
    + q.Celerite(a=0.5, b=0.05, c=1.5, d=3.0),
}


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_general_qsm_matmul_matches_jax(name):
    rng = np.random.default_rng(6)
    X2 = np.sort(rng.uniform(0, 10, N))
    # Test points before the first column, after the last and in between.
    X1 = np.concatenate([[-1.5, -0.2], np.sort(rng.uniform(0, 10, 20)), [10.3, 12.0]])
    x = rng.normal(size=(N, 2))
    kj, kt = KERNELS[name](jq), KERNELS[name](tq)
    want = kj.to_general_qsm(jnp.asarray(X1), jnp.asarray(X2)).matmul(jnp.asarray(x))
    Gt = kt.to_general_qsm(torch.tensor(X1), torch.tensor(X2))
    assert Gt.shape == (X1.shape[0], N)
    assert Gt.idx[0] == -1 and Gt.idx[-1] == N - 1
    got = Gt @ torch.tensor(x)
    assert_allclose(got, want)
    assert_allclose(got, kt(torch.tensor(X1), torch.tensor(X2)) @ torch.tensor(x))
    assert_allclose(kt.matmul(torch.tensor(X1), torch.tensor(X2), torch.tensor(x[:, 0])), want[:, 0])


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_to_symm_qsm_matches_jax(name):
    X = np.sort(np.random.default_rng(7).uniform(0, 10, N))
    kj, kt = KERNELS[name](jq), KERNELS[name](tq)
    M = kt.to_symm_qsm(torch.tensor(X))
    Mj = kj.to_symm_qsm(jnp.asarray(X))
    assert_allclose(M.to_dense(), Mj.to_dense())
    assert_allclose(M.to_dense(), kt(torch.tensor(X), torch.tensor(X)))
    y = np.random.default_rng(8).normal(size=N)
    assert_allclose(kt.matmul(torch.tensor(X), y=torch.tensor(y)), kj.matmul(jnp.asarray(X), y=jnp.asarray(y)))


def test_qsm_from_tree_device_dtype_and_errors():
    tree = random_qsm_tree("SquareQSM", 20, 2, seed=1)
    M = qsm_from_tree(tree, device="cpu", dtype=torch.float32)
    assert isinstance(M, core.SquareQSM) and M.dtype == torch.float32
    assert M.device.type == "cpu" and M.lower.a.shape == (20, 2, 2)
    with pytest.raises(ValueError, match="no quasiseparable matrix"):
        qsm_from_tree({"class": "Block", "params": {}}, device="cpu")
    with pytest.raises(ValueError, match="no quasiseparable matrix"):
        random_qsm_tree("Block", 20, 2, seed=1)


@pytest.mark.parametrize("name", CLASSES)
def test_random_qsms_are_well_conditioned(name):
    M = qsm_from_tree(random_qsm_tree(name, 100, 3, seed=2), device="cpu").to_dense()
    if name.startswith("Strict"):
        assert torch.count_nonzero(torch.diagonal(M)) == 0
        return
    assert torch.linalg.cond(M) < 1e3
    if name in ("SymmQSM", "DiagQSM"):
        assert torch.linalg.eigvalsh(M).min() > 0.4
