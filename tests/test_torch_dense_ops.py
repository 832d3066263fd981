"""The blocked dense Cholesky and its kernels' plain versions against the
JAX package.

Kernels B4, B5 and B6 run here as their plain versions (the tensors lie on
the CPU), held to ``tinygp_tpu.ops.pallas_dense`` in interpret mode and to
a float64 product: the JAX kernels' split-bf16 contract is about 2^-16
per operand for ``terms=2`` and 2^-24 for ``terms=3``; the float32 plain
versions meet the 3-term one for both. Then every test of
``tests/test_ops_dense.py`` is mirrored on the same inputs at
``block=256, min_size=0``: the port against the float64 oracle with the
JAX test's own tolerance, and against the JAX function's result where the
JAX function is not already held to that oracle there (its run in
interpret mode is most of these tests' time).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinygp_tpu.ops import dense as jdense
from tinygp_tpu.ops import pallas_dense
from tinygp_tpu_torch.ops import cuda_dense
from tinygp_tpu_torch.ops import dense as tdense

# Per output, of its largest magnitude: the split contracts with room for
# the sum over b terms (b <= 32 here).
CONTRACT = {2: 2.0**-16 * 8, 3: 2.0**-24 * 64}


def t32(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float32)


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


# ---------------------------------------------------------------------------
# The kernels' plain versions against pallas_dense in interpret mode.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("terms", [2, 3])
@pytest.mark.parametrize("m,tile,b,at,rows", [(64, 16, 16, (16, 16), 48), (128, 32, 32, (32, 32), 64)])
def test_panel_plain_matches_pallas(m, tile, b, at, rows, terms):
    rng = np.random.default_rng(m + terms)
    A = rng.normal(size=(m, m)).astype(np.float32)
    W = rng.normal(size=(b, b)).astype(np.float32)
    want = A.astype(np.float64)[at[0] : at[0] + rows, at[1] : at[1] + b] @ W.astype(np.float64)
    jax_out = pallas_dense.split_panel_matmul(
        jnp.asarray(A), jnp.asarray(W), tile=tile, terms=terms, at=at, rows=rows
    )
    got = cuda_dense.split_panel_matmul(t32(A), t32(W), tile=tile, terms=terms, at=at, rows=rows)
    assert got.shape == (rows, b) and got.dtype == torch.float32
    assert rel(jax_out, want) < CONTRACT[terms]
    assert rel(got, want) < CONTRACT[3]
    assert rel(got, jax_out) < CONTRACT[terms] + CONTRACT[3]
    # Without `at`, the whole of A is the panel.
    whole = cuda_dense.split_panel_matmul(t32(A[:, :b]), t32(W), tile=tile, terms=terms)
    assert rel(whole, A[:, :b].astype(np.float64) @ W) < CONTRACT[3]


@pytest.mark.parametrize("terms", [2, 3])
@pytest.mark.parametrize("extras", [False, True])
@pytest.mark.parametrize("m,tile,b,offset", [(64, 16, 16, 16), (128, 32, 32, 32)])
def test_syrk_inplace_plain_matches_pallas(m, tile, b, offset, extras, terms):
    rng = np.random.default_rng(m + offset + terms)
    S = rng.normal(size=(m, m))
    T = (S + S.T).astype(np.float32)
    L = rng.normal(size=(m - offset, b)).astype(np.float32)
    ak = rng.normal(size=b).astype(np.float32)
    L64 = L.astype(np.float64)
    want = T.astype(np.float64)[offset:, offset:] - L64 @ L64.T
    lower = np.tril_indices(m - offset)
    kw = dict(offset=offset, tile=tile, terms=terms)
    jax_out = pallas_dense.syrk_sub_inplace(
        jnp.asarray(T), jnp.asarray(L), ak=jnp.asarray(ak) if extras else None, **kw
    )
    Tt = t32(T)
    got = cuda_dense.syrk_sub_inplace(Tt, t32(L), ak=t32(ak) if extras else None, **kw)
    if extras:
        (jax_out, jax_sq, jax_su), (got, sq, su) = jax_out, got
        want_sq, want_su = np.sum(L64 * L64, axis=1), L64 @ ak.astype(np.float64)
        assert rel(sq, want_sq) < CONTRACT[3] and rel(jax_sq, want_sq) < CONTRACT[3]
        assert rel(su, want_su) < CONTRACT[3] and rel(jax_su, want_su) < CONTRACT[3]
    assert got is Tt  # in place
    got = got.numpy()
    jax_out = np.asarray(jax_out)
    # The leading rows and columns are untouched; the trailing lower
    # triangle is T - L L^T (the upper one is left undefined).
    np.testing.assert_array_equal(got[:offset], T[:offset])
    np.testing.assert_array_equal(got[:, :offset], T[:, :offset])
    assert rel(got[offset:, offset:][lower], want[lower]) < CONTRACT[3]
    assert rel(jax_out[offset:, offset:][lower], want[lower]) < CONTRACT[terms]


@pytest.mark.parametrize("terms", [2, 3])
@pytest.mark.parametrize("lower_only", [False, True])
def test_syrk_plain_matches_pallas(lower_only, terms):
    m, tile, b = 96, 32, 16
    rng = np.random.default_rng(7 + terms)
    T = rng.normal(size=(m, m)).astype(np.float32)
    L = rng.normal(size=(m, b)).astype(np.float32)
    want = T.astype(np.float64) - L.astype(np.float64) @ L.astype(np.float64).T
    if lower_only:
        blocks = np.arange(m) // tile
        want[blocks[None, :] > blocks[:, None]] = 0.0
    kw = dict(tile=tile, terms=terms, lower_only=lower_only)
    jax_out = np.asarray(pallas_dense.syrk_sub(jnp.asarray(T), jnp.asarray(L), **kw))
    got = cuda_dense.syrk_sub(t32(T), t32(L), **kw).numpy()
    assert rel(got, want) < CONTRACT[3] and rel(jax_out, want) < CONTRACT[terms]
    if lower_only:  # the zero tiles are exactly zero in both
        blocks = np.arange(m) // tile
        above = blocks[None, :] > blocks[:, None]
        assert np.all(got[above] == 0) and np.all(jax_out[above] == 0)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    T = torch.zeros(64, 64)
    with pytest.raises(ValueError, match="terms"):
        cuda_dense.syrk_sub(T, torch.zeros(64, 16), tile=16, terms=4)
    with pytest.raises(ValueError, match="float32"):
        cuda_dense.syrk_sub(T.double(), torch.zeros(64, 16).double(), tile=16)
    with pytest.raises(ValueError, match="offset"):
        cuda_dense.syrk_sub_inplace(T, torch.zeros(40, 16), offset=24, tile=16)
    with pytest.raises(ValueError, match="multiples"):
        cuda_dense.split_panel_matmul(T, torch.zeros(16, 16), tile=16, at=(8, 16), rows=48)
    with pytest.raises(ValueError, match="contiguous rows"):
        cuda_dense.split_panel_matmul(torch.zeros(16, 64).T, torch.zeros(16, 16), tile=16)


# ---------------------------------------------------------------------------
# tests/test_ops_dense.py, mirrored.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("transpose_y", [False, True])
def test_split_matmul_accuracy(transpose_y):
    """``tests/test_ops_dense.py:24-40`` on the same inputs: within 1e-6 of
    the float64 product, and within 1e-6 of the JAX function's result, both
    relative to the largest entry."""
    rng = np.random.default_rng(1 if transpose_y else 0)
    if transpose_y:
        X, Y = rng.normal(size=(64, 128)), rng.normal(size=(96, 128))
    else:
        X, Y = rng.normal(size=(256, 128)), rng.normal(size=(128, 192))
    X, Y = X.astype(np.float32), Y.astype(np.float32)
    exact = X.astype(np.float64) @ (Y.T if transpose_y else Y).astype(np.float64)
    got = tdense.split_matmul(t32(X), t32(Y), transpose_y=transpose_y)
    want = jdense.split_matmul(jnp.asarray(X), jnp.asarray(Y), transpose_y=transpose_y)
    assert got.dtype == torch.float32 and got.shape == exact.shape
    assert rel(got, exact) < 1e-6 and rel(want, exact) < 1e-6 and rel(got, want) < 1e-6


def test_split_matmul_other_dtypes_take_a_plain_product():
    rng = np.random.default_rng(3)
    X, Y = rng.normal(size=(20, 30)), rng.normal(size=(40, 30))
    got = tdense.split_matmul(torch.tensor(X), torch.tensor(Y), transpose_y=True)
    np.testing.assert_allclose(got.numpy(), X @ Y.T, rtol=1e-12, atol=1e-12)


def test_split_syrk_accuracy():
    rng = np.random.default_rng(2)
    L = rng.normal(size=(384, 256)).astype(np.float32)
    exact = L.astype(np.float64) @ L.astype(np.float64).T
    got = tdense.split_syrk(t32(L)).numpy()
    assert rel(got, exact) < 1e-6 and rel(jdense.split_syrk(jnp.asarray(L)), exact) < 1e-6
    np.testing.assert_array_equal(got, got.T)


def spd(seed, n, diag=1.0):
    """``A A^T / n + diag I`` in float32, as the JAX tests build it."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, n)).astype(np.float32) / np.sqrt(n)
    return np.asarray(jnp.matmul(jnp.asarray(A), jnp.asarray(A).T, precision="highest")
                      + diag * jnp.eye(n), np.float32)


def f64_chol(K):
    return np.linalg.cholesky(np.asarray(K, np.float64))


def test_blocked_cholesky_well_conditioned():
    K = spd(3, 1100)
    Lx = f64_chol(K)
    L = tdense.blocked_cholesky(t32(K), block=256, min_size=0)
    Lj = jdense.blocked_cholesky(jnp.asarray(K), block=256, min_size=0)
    assert rel(L, Lx) < 1e-5 and rel(Lj, Lx) < 1e-5 and rel(L, Lj) < 2e-5
    assert float(torch.max(torch.abs(torch.triu(L, 1)))) == 0.0


def test_blocked_cholesky_ill_conditioned_gp_covariance():
    x = np.linspace(0.0, 10.0, 1024)
    K64 = np.exp(-0.5 * (x[:, None] - x[None, :]) ** 2) + 3e-4 * np.eye(x.size)
    logdet64 = 2.0 * float(np.sum(np.log(np.diag(np.linalg.cholesky(K64)))))
    L = tdense.blocked_cholesky(t32(K64), block=256, min_size=0).numpy()
    assert np.all(np.isfinite(L))
    logdet = 2.0 * float(np.sum(np.log(np.diag(L))))
    assert abs(logdet - logdet64) < 1e-2 * abs(logdet64) + 1e-2
    resid = L.astype(np.float64) @ L.astype(np.float64).T - K64
    assert np.max(np.abs(resid)) < 1e-4


def test_adaptive_split_order_both_branches():
    K = spd(11, 768)
    Lx = f64_chol(K)
    for floor in (0.5, 1e-4):
        L = tdense.cholesky_with_fallback(
            t32(K), block=256, min_size=0, rel_floor=torch.tensor(floor, dtype=torch.float32)
        )
        assert rel(L, Lx) < 1e-4, floor
    x = np.linspace(0.0, 10.0, 768)
    K64 = np.exp(-0.5 * (x[:, None] - x[None, :]) ** 2) + 3e-4 * np.eye(768)
    L = tdense.cholesky_with_fallback(
        t32(K64), block=256, min_size=0, rel_floor=torch.tensor(3e-4, dtype=torch.float32)
    )
    assert torch.isfinite(torch.diagonal(L)).all()


def test_cholesky_with_fallback_matches_blocked_when_pd():
    K = t32(spd(4, 512))
    before = tdense.NATIVE_REFACTORS
    L = tdense.cholesky_with_fallback(K, block=256, min_size=0)
    assert torch.equal(L, tdense.blocked_cholesky(K, block=256, min_size=0))
    assert tdense.NATIVE_REFACTORS == before


def test_cholesky_with_fallback_rescues_borderline_matrix():
    rng = np.random.default_rng(5)
    v = rng.normal(size=(512, 1)).astype(np.float32)
    K = v @ v.T - 1e-3 * np.eye(512, dtype=np.float32)
    before = tdense.NATIVE_REFACTORS
    L = tdense.cholesky_with_fallback(t32(K), block=256, min_size=0)
    assert tdense.NATIVE_REFACTORS == before + 1
    # Exactly the native factor: all NaN here, as the JAX native kernel's.
    np.testing.assert_array_equal(L.numpy(), tdense._native_cholesky(t32(K)).numpy())
    Lj = jdense.cholesky_with_fallback(jnp.asarray(K), block=256, min_size=0)
    np.testing.assert_array_equal(np.isnan(L.numpy()), np.isnan(np.asarray(Lj)))


def test_blocked_cholesky_custom_vjp_matches_native():
    rng = np.random.default_rng(8)
    A = rng.normal(size=(512, 512)).astype(np.float32) / np.sqrt(512)
    base = A @ A.T + np.eye(512, dtype=np.float32)

    def loss(s, chol):
        L = chol(s * torch.as_tensor(base))
        return torch.sum(torch.log(torch.diagonal(L))) + 1e-3 * torch.sum(L)

    def grad(chol):
        s = torch.tensor(1.3, requires_grad=True)
        return float(torch.autograd.grad(loss(s, chol), s)[0])

    g_blocked = grad(lambda K: tdense.blocked_cholesky(K, block=256, min_size=0))
    g_native = grad(tdense._native_cholesky)
    g_jax = float(jax.grad(lambda s: jnp.sum(jnp.log(jnp.diag(
        jdense.blocked_cholesky(s * jnp.asarray(base), block=256, min_size=0)
    ))) + 1e-3 * jnp.sum(jdense.blocked_cholesky(s * jnp.asarray(base), block=256, min_size=0)))(
        jnp.float32(1.3)))
    np.testing.assert_allclose(g_blocked, g_native, rtol=5e-5)
    np.testing.assert_allclose(g_blocked, g_jax, rtol=5e-5)


def test_blocked_cholesky_small_fallback():
    rng = np.random.default_rng(6)
    A = rng.normal(size=(64, 64)).astype(np.float32)
    K = t32(A @ A.T + 64 * np.eye(64, dtype=np.float32))
    assert torch.equal(tdense.blocked_cholesky(K), torch.linalg.cholesky(K))


def test_fallback_catches_silently_inaccurate_factor(monkeypatch):
    K = t32(spd(17, 512))
    real = tdense.blocked_cholesky
    monkeypatch.setattr(tdense, "blocked_cholesky", lambda K, **kw: real(K, **kw) * 1.01)
    before = tdense.NATIVE_REFACTORS
    L = tdense.cholesky_with_fallback(K, block=256, min_size=0)
    assert tdense.NATIVE_REFACTORS == before + 1
    assert torch.equal(L, tdense._native_cholesky(K))


def test_fallback_passes_healthy_factor_through():
    K = t32(spd(18, 512))
    before = tdense.NATIVE_REFACTORS
    L = tdense.cholesky_with_fallback(K, block=256, min_size=0)
    assert tdense.NATIVE_REFACTORS == before
    assert torch.equal(L, tdense.blocked_cholesky(K, block=256, min_size=0))


def loglik_fixture(seed, n, diag=0.5):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, n)).astype(np.float32) / np.sqrt(n)
    K = (A @ A.T + diag * np.eye(n)).astype(np.float32)
    return K, rng.normal(size=n).astype(np.float32)


def native_terms_f64(K, r):
    L = np.linalg.cholesky(np.asarray(K, np.float64))
    a = np.linalg.solve(L, np.asarray(r, np.float64))
    return float(a @ a), float(np.sum(np.log(np.diag(L))))


def close_terms(got, want):
    (quad, hld), (q0, h0) = [float(x) for x in got], want
    return abs(quad - q0) / abs(q0) < 5e-4 and abs(hld - h0) < 5e-3 * abs(h0) + 1e-2


@pytest.mark.parametrize("terms", [2, 3])
@pytest.mark.parametrize("n", [768, 1100])
def test_fused_loglik_matches_f64_oracle(n, terms):
    K, r = loglik_fixture(11, n)
    want = native_terms_f64(K, r)
    got = tdense.blocked_loglik_terms(t32(K), t32(r), block=256, min_size=0, terms=terms)
    assert close_terms(got, want)


def test_fused_loglik_rel_floor_dispatch():
    K, r = loglik_fixture(12, 512)
    want = native_terms_f64(K, r)
    for floor in (0.5, 1e-6):
        got = tdense.blocked_loglik_terms(
            t32(K), t32(r), block=256, min_size=0, rel_floor=torch.tensor(floor)
        )
        assert close_terms(got, want), floor


def test_fused_loglik_breakdown_falls_back():
    rng = np.random.default_rng(13)
    K = rng.normal(size=(512, 512)).astype(np.float32)
    K = 0.5 * (K + K.T)
    r = rng.normal(size=512).astype(np.float32)
    before = tdense.NATIVE_REFACTORS
    quad, hld = tdense.blocked_loglik_terms(t32(K), t32(r), block=256, min_size=0, terms=2)
    assert tdense.NATIVE_REFACTORS == before + 1
    assert not np.isfinite(float(quad)) or not np.isfinite(float(hld))
    jq, jh = jax.jit(lambda K, r: jdense.blocked_loglik_terms(
        K, r, block=256, min_size=0, terms=2))(jnp.asarray(K), jnp.asarray(r))
    assert not np.isfinite(float(jq)) or not np.isfinite(float(jh))


def test_fused_loglik_gradients_match_native():
    K, r = loglik_fixture(14, 512)

    def grads(fn):
        Kt, rt = t32(K).requires_grad_(True), t32(r).requires_grad_(True)
        q, h = fn(Kt, rt)
        return torch.autograd.grad(-0.5 * q - h, [Kt, rt])

    gK, gr = grads(lambda K, r: tdense.blocked_loglik_terms(K, r, block=256, min_size=0, terms=3))
    gK0, gr0 = grads(tdense._native_loglik_terms)
    assert float(torch.max(torch.abs(gK - gK0))) < 5e-4 * float(torch.max(torch.abs(gK0)))
    assert float(torch.max(torch.abs(gr - gr0))) < 5e-4 * float(torch.max(torch.abs(gr0)))

    def fused(K, r):
        q, h = jdense.blocked_loglik_terms(K, r, block=256, min_size=0, terms=3)
        return -0.5 * q - h

    jK, jr = jax.jit(jax.grad(fused, argnums=(0, 1)))(jnp.asarray(K), jnp.asarray(r))
    assert float(np.max(np.abs(gK.numpy() - jK))) < 1e-3 * float(np.max(np.abs(jK)))
    assert float(np.max(np.abs(gr.numpy() - jr))) < 1e-3 * float(np.max(np.abs(jr)))


def test_fused_loglik_backward_forms_the_inverse_in_float64():
    """The backward forms T^-1 from the float32 factor in float64 and
    returns float32 cotangents: the gradient lies within 1e-6 of the
    float64 one on the same float32 values (a float32 inverse about
    doubles the error here; at N = 1e4 on the card it decided the dense
    gradient check, PERF.md)."""
    K, r = loglik_fixture(14, 512)
    Kt, rt = t32(K).requires_grad_(True), t32(r).requires_grad_(True)
    q, h = tdense.blocked_loglik_terms(Kt, rt, block=256, min_size=0, terms=3)
    gK, gr = torch.autograd.grad(-0.5 * q - h, [Kt, rt])
    assert gK.dtype == gr.dtype == torch.float32
    K64, r64 = (t32(a).double().requires_grad_(True) for a in (K, r))
    q64, h64 = tdense._native_loglik_terms(K64, r64)
    wK, wr = torch.autograd.grad(-0.5 * q64 - h64, [K64, r64])
    assert float((gK.double() - wK).abs().max()) < 1e-6 * float(wK.abs().max())
    assert float((gr.double() - wr).abs().max()) < 1e-6 * float(wr.abs().max())


def test_direct_solver_fused_loglik_dispatch(monkeypatch):
    from tinygp_tpu_torch import GaussianProcess, kernels

    rng = np.random.default_rng(15)
    X = t32(np.sort(rng.uniform(0, 10, 600)))
    y = t32(rng.normal(size=600))
    kernel = lambda: 1.5 * kernels.Matern32(scale=2.5)  # noqa: E731
    lp_generic = float(GaussianProcess(kernel(), X, diag=0.1, device="cpu").log_probability(y))
    monkeypatch.setattr(tdense, "_MIN_BLOCKED", 256)
    calls = []
    real = tdense.kernel_loglik_terms
    monkeypatch.setattr(tdense, "kernel_loglik_terms", lambda *a, **k: calls.append(1) or real(*a, **k))
    lp_fused = float(GaussianProcess(kernel(), X, diag=0.1, device="cpu").log_probability(y))
    assert calls == [1]
    assert abs(lp_fused - lp_generic) < 5e-4 * abs(lp_generic) + 1e-3


def strip_model(n, seed):
    from tinygp_tpu import kernels as jk

    from tinygp_tpu_torch import kernels as tk

    rng = np.random.default_rng(seed)
    X = np.sort(rng.uniform(0, 10, n)).astype(np.float32)
    r = rng.normal(size=n).astype(np.float32)
    noise = np.full(n, 0.1, np.float32)

    def jax_kernel(amp=1.5, scale=2.5):
        return jk.Constant(jnp.float32(amp)) * jk.Matern32(scale=jnp.float32(scale))

    def torch_kernel(amp=torch.tensor(1.5), scale=torch.tensor(2.5)):
        return tk.Constant(amp) * tk.Matern32(scale=scale)

    return X, r, noise, jax_kernel, torch_kernel


def test_kernel_strip_loglik_matches_f64_oracle():
    X, r, noise, jax_kernel, torch_kernel = strip_model(1100, 21)
    K = np.asarray(jax_kernel()(X, X)) + np.diag(noise)
    want = native_terms_f64(K.astype(np.float32), r)
    for floor in (0.5, 1e-6):
        got = tdense.kernel_loglik_terms(
            torch_kernel(), t32(X), t32(noise), t32(r), block=256, rel_floor=torch.tensor(floor)
        )
        assert close_terms(got, want), floor


def test_kernel_strip_loglik_grad_matches_native():
    X, r, noise, jax_kernel, torch_kernel = strip_model(512, 22)

    def port(fused):
        amp, scale = (torch.tensor(v, requires_grad=True) for v in (1.5, 2.5))
        kernel = torch_kernel(amp, scale)
        Xt, nt, rt = t32(X), t32(noise), t32(r)
        if fused:
            q, h = tdense.kernel_loglik_terms(kernel, Xt, nt, rt, block=256, terms=3)
        else:
            q, h = tdense._native_loglik_terms(kernel(Xt, Xt) + torch.diag(nt), rt)
        v = -0.5 * q - h
        return v.item(), [float(g) for g in torch.autograd.grad(v, [amp, scale])]

    def jax_fused(p):
        q, h = jdense.kernel_loglik_terms(
            jax_kernel(p["amp"], p["scale"]), jnp.asarray(X), jnp.asarray(noise),
            jnp.asarray(r), block=256, terms=3,
        )
        return -0.5 * q - h

    v1, g1 = port(True)
    v0, g0 = port(False)
    vj, gj = jax.jit(jax.value_and_grad(jax_fused))({"amp": jnp.float32(1.5), "scale": jnp.float32(2.5)})
    assert abs(v1 - v0) < 5e-4 * abs(v0) + 1e-3 and abs(v1 - float(vj)) < 5e-4 * abs(v0) + 1e-3
    for g, w, j in zip(g1, g0, (gj["amp"], gj["scale"])):
        # The JAX test's tolerance (tests/test_ops_dense.py:382).
        assert abs(g - w) < 2e-3 * abs(w) + 1e-3
        assert abs(g - float(j)) < 2e-3 * abs(float(j)) + 1e-3
