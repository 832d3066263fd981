"""The scans' hand-written adjoints (``cuda_scan``'s ``autograd.Function`` s)
against the JAX package's, on the CPU.

The JAX package differentiates its parallel scans through ``custom_vjp``
rules (``tinygp_tpu/solvers/quasisep/scan.py``) and its coupling by
autodiff of ``lax.scan`` (``ops._coupling_scan``). The same numpy inputs go
through ``jax.value_and_grad`` of those and through the port's
``Function`` s, whose backwards are the code the card runs around kernel
B3. Mirrors ``tests/test_solvers/test_quasisep/test_scan_vjp.py`` (sizes,
seeds, grad-of-grad, ``vmap(grad)``), adds the coupling, ``gradcheck`` in
float64, a generic order, float32, and the launch counters. Tolerances
from ``tinygp_tpu_torch.test_utils`` (5e-7 float64, 5e-4 float32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinygp_tpu.solvers.quasisep import ops as jops
from tinygp_tpu.solvers.quasisep import scan as jscan
from tinygp_tpu_torch.solvers.quasisep import cuda_scan
from tinygp_tpu_torch.solvers.quasisep import ops as tops
from tinygp_tpu_torch.solvers.quasisep import scan as tscan
from tinygp_tpu_torch.test_utils import assert_allclose, random_qsm_operands

N, M, R = 213, 2, 3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small tensor operations a step: with several test workers on
    one host, intra-op threads only contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def rng():
    return np.random.default_rng(5091986)


def _rand_inputs(rng, m=M, r=R):
    # Transitions scaled below 1 so long products stay well-conditioned.
    A = 0.1 * rng.normal(size=(N, m, m)) + 0.85 * np.eye(m)
    B = rng.normal(size=(N, m, r))
    return A, B


def _leaves(*arrays, dtype=torch.float64):
    return [torch.tensor(a, dtype=dtype, requires_grad=True) for a in arrays]


def _torch_value_and_grad(f, *arrays, dtype=torch.float64):
    leaves = _leaves(*arrays, dtype=dtype)
    value = f(*leaves)
    return value, torch.autograd.grad(value, leaves)


def _check(torch_vg, jax_vg):
    (v_t, g_t), (v_j, g_j) = torch_vg, jax_vg
    assert_allclose(v_t, v_j)
    for gt, gj in zip(g_t, g_j):
        assert_allclose(gt, gj)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("exclusive", [False, True])
def test_affine_vjp(rng, reverse, exclusive):
    A, B = _rand_inputs(rng)
    ct = rng.normal(size=(N, M, R))

    def f_jax(A, B):
        e = jscan.affine_scan(A, B, reverse=reverse, exclusive=exclusive, parallel=True)
        return jnp.sum(e * ct)

    def f_torch(A, B):
        e = tscan.affine_scan(A, B, reverse=reverse, exclusive=exclusive)
        return torch.sum(e * torch.as_tensor(ct))

    _check(_torch_value_and_grad(f_torch, A, B),
           jax.jit(jax.value_and_grad(f_jax, argnums=(0, 1)))(A, B))


@pytest.mark.parametrize("reverse", [False, True])
def test_congruence_vjp(rng, reverse):
    A, _ = _rand_inputs(rng)
    Braw = rng.normal(size=(N, M, M))
    B = Braw + np.swapaxes(Braw, -1, -2)  # symmetric loads
    ct = rng.normal(size=(N, M, M))

    def f_jax(A, B):
        return jnp.sum(jscan.congruence_scan(A, B, reverse=reverse, parallel=True) * ct)

    def f_torch(A, B):
        return torch.sum(tscan.congruence_scan(A, B, reverse=reverse) * torch.as_tensor(ct))

    _check(_torch_value_and_grad(f_torch, A, B),
           jax.jit(jax.value_and_grad(f_jax, argnums=(0, 1)))(A, B))


def _riccati_inputs(rng):
    # An SPD quasiseparable system (exact 2-term celerite structure) keeps
    # c2 > 0 all along the flow.
    a_, b_, c_, d_ = 1.8, 0.9, 0.8, 0.3
    t = np.sort(rng.uniform(0, 10, N))
    dt = np.diff(t, prepend=t[0])
    cos, sin = np.cos(d_ * t), np.sin(d_ * t)
    p = np.stack([a_ * cos + b_ * sin, a_ * sin - b_ * cos], axis=-1)
    q = np.stack([cos, sin], axis=-1)
    rot = np.zeros((N, M, M))
    rot[:, 0, 0] = rot[:, 1, 1] = np.cos(d_ * dt)
    rot[:, 0, 1] = np.sin(d_ * dt)
    rot[:, 1, 0] = -np.sin(d_ * dt)
    a = np.exp(-c_ * dt)[:, None, None] * rot
    return np.full(N, a_ + 1.0), p, q, a


def _generic_riccati_inputs(m, seed):
    """A positive definite system of order ``m`` in the row-major layout."""
    d, ps, qs, as_, _ = random_qsm_operands(m, N, seed)
    return d, ps.T.copy(), qs.T.copy(), as_.T.reshape(N, m, m).copy()


@pytest.mark.parametrize("order", [2, 5])
def test_riccati_vjp(rng, order):
    """At m = 2 against the JAX ``custom_vjp``; at the generic order 5
    against autodiff of its sequential ``lax.scan`` (its parallel flow at
    m = 5 compiles for tens of seconds)."""
    d, p, q, a = _riccati_inputs(rng) if order == 2 else _generic_riccati_inputs(order, 3)
    ct = rng.normal(size=(N, order, order))

    def f_jax(d, p, q, a):
        return jnp.sum(jscan.riccati_scan(d, p, q, a, parallel=order == 2) * ct)

    def f_torch(d, p, q, a):
        return torch.sum(tscan.riccati_scan(d, p, q, a) * torch.as_tensor(ct))

    _check(_torch_value_and_grad(f_torch, d, p, q, a),
           jax.jit(jax.value_and_grad(f_jax, argnums=(0, 1, 2, 3)))(d, p, q, a))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("orders", [(2, 2), (2, 3), (6, 6)], ids=str)
def test_coupling_vjp(rng, orders, reverse):
    """The coupling's adjoint scan against ``jax.grad`` of the JAX
    package's sequential ``ops._coupling_scan``, equal and unequal orders."""
    m1, m2 = orders
    A = 0.1 * rng.normal(size=(N, m1, m1)) + 0.85 * np.eye(m1)
    Bt = 0.1 * rng.normal(size=(N, m2, m2)) + 0.85 * np.eye(m2)
    C = rng.normal(size=(N, m1, m2))
    ct = rng.normal(size=(N, m1, m2))

    def f_jax(A, Bt, C):
        return jnp.sum(jops._coupling_scan(A, Bt, C, reverse=reverse) * ct)

    def f_torch(A, Bt, C):
        return torch.sum(tops._coupling_scan(A, Bt, C, reverse=reverse) * torch.as_tensor(ct))

    _check(_torch_value_and_grad(f_torch, A, Bt, C),
           jax.jit(jax.value_and_grad(f_jax, argnums=(0, 1, 2)))(A, Bt, C))


@pytest.mark.parametrize("reverse", [False, True])
def test_coupling_inclusive_vjp(rng, reverse):
    """The inclusive coupling (its adjoint shifts the transitions as the
    affine one does) against ``jax.grad`` of the JAX sequential scan, whose
    inclusive states are the exclusive ones advanced by one step."""
    m1, m2 = 2, 3
    A = 0.1 * rng.normal(size=(N, m1, m1)) + 0.85 * np.eye(m1)
    Bt = 0.1 * rng.normal(size=(N, m2, m2)) + 0.85 * np.eye(m2)
    C = rng.normal(size=(N, m1, m2))
    ct = rng.normal(size=(N, m1, m2))

    def f_jax(A, Bt, C):
        e = jops._coupling_scan(A, Bt, C, reverse=reverse)
        g = jnp.einsum("nij,njk,nlk->nil", A, e, Bt) + C
        return jnp.sum(g * ct)

    def f_torch(A, Bt, C):
        g = cuda_scan.coupling(tscan._pack3(A), tscan._pack3(Bt), tscan._pack3(C), m1, m2,
                               reverse=reverse, exclusive=False)
        return torch.sum(tscan._unpack3(g, m1, m2) * torch.as_tensor(ct))

    _check(_torch_value_and_grad(f_torch, A, Bt, C),
           jax.jit(jax.value_and_grad(f_jax, argnums=(0, 1, 2)))(A, Bt, C))


def test_affine_vjp_float32(rng):
    """Float32 operands, at the table's 5e-4, against the JAX package in
    float32."""
    A, B = (x.astype(np.float32) for x in _rand_inputs(rng))
    ct = rng.normal(size=(N, M, R)).astype(np.float32)

    def f_jax(A, B):
        return jnp.sum(jscan.affine_scan(A, B, parallel=True) * ct)

    def f_torch(A, B):
        return torch.sum(tscan.affine_scan(A, B) * torch.as_tensor(ct))

    got = _torch_value_and_grad(f_torch, A, B, dtype=torch.float32)
    assert got[1][0].dtype == torch.float32
    _check(got, jax.jit(jax.value_and_grad(f_jax, argnums=(0, 1)))(jnp.asarray(A), jnp.asarray(B)))


GRADCHECK_N = 9


def _gradcheck_case(monoid, rng):
    """A small float64 case for ``torch.autograd.gradcheck``: the wrapper
    and its stacked operands."""
    n, m = GRADCHECK_N, 2

    def trans(k):
        return (0.1 * rng.normal(size=(k * k, n)) + 0.85 * np.eye(k).reshape(-1, 1))

    if monoid == "aff":
        return (lambda A, B: cuda_scan.affine(A, B, m, 2, reverse=True, exclusive=False),
                [trans(m), rng.normal(size=(2 * m, n))])
    if monoid == "cong":
        return (lambda A, B: cuda_scan.congruence(A, B, m, reverse=False),
                [trans(m), rng.normal(size=(m * m, n))])
    if monoid == "ric":
        return (lambda *x: cuda_scan.riccati(*x), list(random_qsm_operands(m, n, 4)[:4]))
    return (lambda A, B, C: cuda_scan.coupling(A, B, C, m, 3, reverse=True, exclusive=True),
            [trans(m), trans(3), rng.normal(size=(m * 3, n))])


@pytest.mark.parametrize("monoid", ["aff", "cong", "ric", "cpl"])
def test_gradcheck(rng, monoid):
    """Each ``Function``'s gradient against finite differences in float64
    (the congruence with loads that are not symmetric, which the Riccati
    adjoint feeds it)."""
    f, arrays = _gradcheck_case(monoid, rng)
    assert torch.autograd.gradcheck(f, _leaves(*arrays))


def test_affine_vjp_second_order(rng):
    """The backward is built from the same ``Function`` s, so grad-of-grad
    works and matches the JAX package's."""
    A, B = _rand_inputs(rng)
    ct = rng.normal(size=(N, M, R))

    def gnorm_jax(A, B):
        def loss(A, B):
            return jnp.sum(jnp.tanh(jscan.affine_scan(A, B, parallel=True)) * ct)

        gA, gB = jax.grad(loss, argnums=(0, 1))(A, B)
        return jnp.sum(gA**2) + jnp.sum(gB**2)

    def gnorm_torch(A, B):
        loss = torch.sum(torch.tanh(tscan.affine_scan(A, B)) * torch.as_tensor(ct))
        gA, gB = torch.autograd.grad(loss, (A, B), create_graph=True)
        return torch.sum(gA**2) + torch.sum(gB**2)

    leaves = _leaves(A, B)
    got = torch.autograd.grad(gnorm_torch(*leaves), leaves[0])[0]
    assert_allclose(got, jax.jit(jax.grad(gnorm_jax))(A, B))


def test_riccati_vjp_under_vmap(rng):
    """``vmap(grad)`` of the Riccati flow (one run a batch element) matches
    the JAX package's."""
    d, p, q, a = _riccati_inputs(rng)
    scales = np.asarray([0.5, 1.0, 2.0])

    def f_jax(s):
        F = jscan.riccati_scan(s * d, p, s * q, a, parallel=True)
        return jnp.sum(F**2)

    dt, pt, qt, at = (torch.as_tensor(x) for x in (d, p, q, a))

    def f_torch(s):
        return torch.sum(tscan.riccati_scan(s * dt, pt, s * qt, at) ** 2)

    got = torch.func.vmap(torch.func.grad(f_torch))(torch.as_tensor(scales))
    assert_allclose(got, jax.jit(jax.vmap(jax.grad(f_jax)))(scales))


def test_cpu_tensors_launch_nothing(rng):
    """Forward and backward of every monoid on CPU tensors run the plain
    versions: no launch is counted."""
    before = dict(cuda_scan.LAUNCHES), dict(cuda_scan.LAUNCHES_GENERIC)
    for monoid in ("aff", "cong", "ric", "cpl"):
        f, arrays = _gradcheck_case(monoid, rng)
        leaves = _leaves(*arrays)
        torch.autograd.grad(torch.sum(f(*leaves) ** 2), leaves)
    assert (cuda_scan.LAUNCHES, cuda_scan.LAUNCHES_GENERIC) == before
