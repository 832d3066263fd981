"""The port's scans against the JAX package: the row-major affine,
congruence and Riccati scans of ``scan.py`` with both strategies, the
coupling scan of the QSM product, and the stacked scans that are kernel
B3's plain versions. Float64 at the tolerance table's 5e-7; m = 1..4 at
N = 100 (one sequential level) and N = 700 (above ``_SEQ_CUTOFF``, the
blocked strategy). The CUDA kernel is held to these plain versions in
``test_torch_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinygp_tpu.solvers.quasisep import ops as jops
from tinygp_tpu.solvers.quasisep import scan as jscan
from tinygp_tpu_torch.solvers.quasisep import cuda_scan, scan
from tinygp_tpu_torch.test_utils import assert_allclose, random_qsm_operands

SIZES = [100, 700]


def row_major(m, n, seed):
    """Contracting transitions ``(n, m, m)`` and the generators of a
    positive definite matrix, row-major."""
    d, ps, qs, as_, _ = random_qsm_operands(m, n, seed)
    return d, ps.T.copy(), qs.T.copy(), as_.T.reshape(n, m, m).copy()


def loads(shape, seed):
    return np.random.default_rng(seed).normal(size=shape)


def t(x):
    return torch.tensor(np.asarray(x), dtype=torch.float64)


@pytest.mark.parametrize("exclusive", [True, False])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("m", [1, 2, 3, 4])
def test_affine_scan_matches_jax(m, n, reverse, exclusive):
    a = row_major(m, n, seed=m)[3]
    for B in (loads((n, m), 7), loads((n, m, 3), 8)):
        want = jscan.affine_scan(
            jnp.asarray(a), jnp.asarray(B), reverse=reverse, exclusive=exclusive,
            parallel=False,
        )
        for parallel in (True, False):
            got = scan.affine_scan(
                t(a), t(B), reverse=reverse, exclusive=exclusive, parallel=parallel
            )
            assert got.shape == B.shape and torch.isfinite(got).all()
            assert_allclose(got, want)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("m", [1, 2, 3, 4])
def test_congruence_scan_matches_jax(m, n, reverse):
    a = row_major(m, n, seed=m)[3]
    B = loads((n, m, m), 9)
    want = jscan.congruence_scan(
        jnp.asarray(a), jnp.asarray(B), reverse=reverse, parallel=False
    )
    for parallel in (True, False):
        got = scan.congruence_scan(t(a), t(B), reverse=reverse, parallel=parallel)
        assert torch.isfinite(got).all()
        assert_allclose(got, want)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("m", [1, 2, 3, 4])
def test_riccati_scan_matches_jax(m, n):
    ops = row_major(m, n, seed=m)
    want = jscan.riccati_scan(*map(jnp.asarray, ops), parallel=False)
    for parallel in (True, False):
        got = scan.riccati_scan(*map(t, ops), parallel=parallel)
        assert torch.isfinite(got).all()
        assert_allclose(got, want)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("orders", [(1, 1), (2, 2), (2, 3), (4, 4)], ids=str)
def test_coupling_scan_matches_jax(orders, n, reverse):
    m1, m2 = orders
    A = row_major(m1, n, seed=1)[3]
    Bt = row_major(m2, n, seed=2)[3]
    C = loads((n, m1, m2), 3)
    want = jops._coupling_scan(*map(jnp.asarray, (A, Bt, C)), reverse=reverse)
    from tinygp_tpu_torch.solvers.quasisep import ops

    got = ops._coupling_scan(t(A), t(Bt), t(C), reverse=reverse)
    assert got.shape == C.shape and torch.isfinite(got).all()
    assert_allclose(got, want)


@pytest.mark.parametrize("reverse", [False, True])
def test_inclusive_coupling_scan_is_the_recurrence(reverse):
    """The inclusive coupling scan (which ``qsm_mul`` does not use, and the
    JAX package has not) against a loop over the recurrence."""
    m1, m2, n = 2, 3, 700
    A = row_major(m1, n, seed=1)[3]
    Bt = row_major(m2, n, seed=2)[3]
    C = loads((n, m1, m2), 3)
    got = cuda_scan.coupling(
        *(scan._pack3(t(x)) for x in (A, Bt, C)), m1, m2, reverse=reverse, exclusive=False
    )
    g = np.zeros((m1, m2))
    want = np.empty_like(C)
    for k in range(n - 1, -1, -1) if reverse else range(n):
        g = A[k] @ g @ Bt[k].T + C[k]
        want[k] = g
    assert_allclose(scan._unpack3(got, m1, m2), want)


# ---------------------------------------------------------------------------
# The stacked scans, kernel B3's plain versions, against the JAX package's
# blocked monoid scan without Pallas: what its interpret-mode B3 tests
# (test_pallas_scan.py) hold B3 to.
# ---------------------------------------------------------------------------


def jax_coupling_combine(m1, m2, reverse):
    def combine(earlier, later):
        if reverse:
            earlier, later = later, earlier
        A_e, B_e, C_e = earlier
        A_l, B_l, C_l = later
        return (
            jscan._smm(A_l, A_e, m1, m1, m1),
            jscan._smm(B_l, B_e, m2, m2, m2),
            jscan._smm_t(jscan._smm(A_l, C_e, m1, m1, m2), B_l, m1, m2, m2) + C_l,
        )

    return combine


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("m", [1, 2, 3, 4])
def test_stacked_scans_match_jax_monoid_scan(m, reverse):
    """The congruence and coupling scans' plain versions. (The affine and
    Riccati ones are held to the JAX package in test_torch_loglik.py.)"""
    n = 300
    as_ = random_qsm_operands(m, n, seed=m)[3]
    as2 = random_qsm_operands(m, n, seed=m + 10)[3]
    Cs = loads((m * m, n), 5)

    # The JAX package's stacked congruence scan takes the blocked strategy
    # on the CPU: monoid_scan without Pallas.
    want = jscan._congruence_scan_s(jnp.asarray(as_), jnp.asarray(Cs), m, reverse=reverse)
    assert_allclose(cuda_scan.congruence(t(as_), t(Cs), m, reverse=reverse), want)

    identity = (
        np.eye(m).reshape(m * m, 1), np.eye(m).reshape(m * m, 1), np.zeros((m * m, 1))
    )
    _, _, want = jscan.monoid_scan(
        jax_coupling_combine(m, m, reverse),
        identity,
        tuple(map(jnp.asarray, (as_, as2, Cs))),
        reverse=reverse,
        pallas_ok=False,
    )
    got = cuda_scan.coupling(t(as_), t(as2), t(Cs), m, m, reverse=reverse)
    assert_allclose(got, want)


def test_cpu_tensors_never_launch():
    before = dict(cuda_scan.LAUNCHES)
    a = row_major(2, 300, seed=1)[3]
    scan.affine_scan(t(a), t(loads((300, 2), 1)))
    assert cuda_scan.LAUNCHES == before


def test_pack3_roundtrip():
    x = t(loads((50, 2, 3), 1))
    s = scan._pack3(x)
    assert s.shape == (6, 50) and s.is_contiguous()
    assert torch.equal(scan._unpack3(s, 2, 3), x)
    assert torch.equal(s[1 * 3 + 2], x[:, 1, 2])

