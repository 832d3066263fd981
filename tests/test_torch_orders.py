"""Quasiseparable orders above 4 on the O(N) path, against the JAX package.

- the m = 5 sum ``1.2 * SHO(1.5, 3.0) + 1.5 * Matern52(2.5)``: its log
  probability and its gradient in four hyperparameters, in float64 at the
  tolerance table's 5e-7 and in float32 at 5e-4; the same with the 2-term
  celerite added (m = 9, where B2 runs its tensor-core kernel on the
  card), its gradient in six;
- the posterior process at the training points (order 4m: 8 for SHO, 12
  for Matern52, 16 for the 2-term celerite): its ``log_probability`` and
  ``sample`` against a dense numpy posterior built from the JAX package's
  kernel matrix and its ``condition`` mean (the JAX package's own order-4m
  process takes minutes to compile);
- the order-20 asteroseismic model (two granulation terms and a comb of
  eight modes, ten SHOs; B1r and B2 above m = 16 on the card): its value
  and gradient in six hyperparameters, as the m = 5 sum's;
- the m = 5 and m = 9 sums conditioned (``condition(y)``: its log
  probability, the posterior's mean and variance; couplings of order 5, 9,
  10 and 18) in float64 against the JAX package at 5e-7, and the m = 5
  sum's posterior process (order 20) given ``diag=1e-3``: its
  ``log_probability`` against the JAX package's sequential solver and a
  dense Cholesky;
- products of QSMs of unequal orders, (2, 4) and (3, 6), whose coupling
  scans pair two orders, against the dense product;
- the wrappers of kernels B1, B1r, B2 and B3 at m = 5 and 8 on CPU tensors:
  they run their plain versions and launch nothing; the plain versions are
  held to a dense Cholesky, to autograd and to the sequential recurrences
  (JAX's own programs at m = 8 take minutes to compile).

The card's kernels at these orders are held to the same plain versions in
``test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinygp_tpu import GaussianProcess as JaxGP
from tinygp_tpu import noise as jnoise
from tinygp_tpu.kernels import quasisep as jq
from tinygp_tpu.solvers.quasisep.solver import QuasisepSolver as JaxQuasisepSolver
from tinygp_tpu_torch import GaussianProcess
from tinygp_tpu_torch.convert import qsm_from_tree
from tinygp_tpu_torch.kernels import quasisep as tq
from tinygp_tpu_torch.solvers.quasisep import cuda_loglik, cuda_scan, scan
from tinygp_tpu_torch.solvers.quasisep.core import SymmQSM
from tinygp_tpu_torch.test_utils import (
    assert_allclose,
    random_qsm_operands,
    random_qsm_tree,
)


def data(n, seed):
    rng = np.random.default_rng(seed)
    X = np.sort(rng.uniform(0, 10, n))
    return X, np.sin(2.0 * X) + 0.3 * rng.normal(size=n)


# ---------------------------------------------------------------------------
# The m = 5 sum: value and gradient.
# ---------------------------------------------------------------------------

N_SUM = 128
SUM_PARAMS = {"amp1": 1.2, "omega": 1.5, "amp2": 1.5, "scale": 2.5}


def sum_kernel(q, p):
    return p["amp1"] * q.SHO(omega=p["omega"], quality=3.0) + p["amp2"] * q.Matern52(
        scale=p["scale"]
    )


@functools.cache
def jax_sum_value_and_grad():
    def logprob(params, X, y):
        gp = JaxGP(sum_kernel(jq, params), X, diag=0.1, assume_sorted=True, parallel=False)
        return gp.log_probability(y)

    return jax.jit(jax.value_and_grad(logprob))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_sum_of_order_5_value_and_gradient_match_jax(dtype):
    X, y = (a.astype(dtype) for a in data(N_SUM, seed=5))
    params = {k: jnp.asarray(v, dtype) for k, v in SUM_PARAMS.items()}
    want_value, want_grad = jax_sum_value_and_grad()(params, jnp.asarray(X), jnp.asarray(y))

    tdtype = getattr(torch, dtype)
    leaves = {k: torch.tensor(v, dtype=tdtype, requires_grad=True) for k, v in SUM_PARAMS.items()}
    kernel = sum_kernel(tq, leaves)
    gp = GaussianProcess(kernel, torch.as_tensor(X), diag=0.1, assume_sorted=True, device="cpu")
    assert gp.solver.ssm[1].shape == (5, N_SUM)
    value = gp.log_probability(torch.as_tensor(y))
    grads = torch.autograd.grad(value, list(leaves.values()))
    assert value.dtype == tdtype and torch.isfinite(value)
    assert_allclose(value.detach(), want_value)
    for name, g in zip(leaves, grads):
        assert torch.isfinite(g), name
        assert_allclose(g, want_grad[name])


SUM9_PARAMS = {**SUM_PARAMS, "a1": 1.0, "a2": 0.5}


def sum9_kernel(q, p):
    """The m = 5 sum plus ``bench.py:331-345``'s 2-term celerite with its
    two amplitudes free: order 2 + 3 + 4 = 9."""
    return (sum_kernel(q, p) + q.Celerite(a=p["a1"], b=0.1, c=0.5, d=1.0)
            + q.Celerite(a=p["a2"], b=0.05, c=1.5, d=3.0))


@functools.cache
def jax_sum9_value_and_grad():
    def logprob(params, X, y):
        gp = JaxGP(sum9_kernel(jq, params), X, diag=0.1, assume_sorted=True, parallel=False)
        return gp.log_probability(y)

    return jax.jit(jax.value_and_grad(logprob))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_sum_of_order_9_value_and_gradient_match_jax(dtype):
    X, y = (a.astype(dtype) for a in data(N_SUM, seed=9))
    params = {k: jnp.asarray(v, dtype) for k, v in SUM9_PARAMS.items()}
    want_value, want_grad = jax_sum9_value_and_grad()(params, jnp.asarray(X), jnp.asarray(y))

    tdtype = getattr(torch, dtype)
    leaves = {k: torch.tensor(v, dtype=tdtype, requires_grad=True) for k, v in SUM9_PARAMS.items()}
    gp = GaussianProcess(sum9_kernel(tq, leaves), torch.as_tensor(X), diag=0.1,
                         assume_sorted=True, device="cpu")
    assert gp.solver.ssm[1].shape == (9, N_SUM)
    value = gp.log_probability(torch.as_tensor(y))
    grads = torch.autograd.grad(value, list(leaves.values()))
    assert value.dtype == tdtype and torch.isfinite(value)
    assert_allclose(value.detach(), want_value)
    for name, g in zip(leaves, grads):
        assert torch.isfinite(g), name
        assert_allclose(g, want_grad[name])


SUM20_PARAMS = {"gran_amp": 0.8, "gran_omega": 1.2, "height": 0.6, "omega0": 12.0,
                "domega": 1.4, "quality": 15.0}


def sum20_kernel(q, p):
    """The asteroseismic background-plus-modes model of the celerite paper
    (Foreman-Mackey et al. 2017, AJ 154, 220): two granulation terms
    ``SHO(quality=1/sqrt(2))``, the second at three times the first's
    frequency and half its amplitude, and a comb of eight oscillation modes,
    ``SHO(omega0 + k domega, Q)`` for k = 0..7, their amplitudes under a
    Gaussian envelope of height ``height`` over the comb (two modes wide):
    order 2 x 10 = 20, six hyperparameters."""
    gran = 1.0 / np.sqrt(2.0)
    kernel = (p["gran_amp"] * q.SHO(omega=p["gran_omega"], quality=gran)
              + (0.5 * p["gran_amp"]) * q.SHO(omega=3.0 * p["gran_omega"], quality=gran))
    for k in range(8):
        envelope = float(np.exp(-0.5 * ((k - 3.5) / 2.0) ** 2))
        kernel = kernel + (p["height"] * envelope) * q.SHO(
            omega=p["omega0"] + k * p["domega"], quality=p["quality"])
    return kernel


@functools.cache
def jax_sum20_value_and_grad():
    def logprob(params, X, y):
        gp = JaxGP(sum20_kernel(jq, params), X, diag=0.1, assume_sorted=True, parallel=False)
        return gp.log_probability(y)

    return jax.jit(jax.value_and_grad(logprob))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_sum_of_order_20_value_and_gradient_match_jax(dtype):
    """The order-20 model (B1r and B2 above m = 16 on the card): value and
    gradient in its six hyperparameters at N = 128, at the tolerance
    table's limits for the dtype."""
    X, y = (a.astype(dtype) for a in data(N_SUM, seed=21))
    params = {k: jnp.asarray(v, dtype) for k, v in SUM20_PARAMS.items()}
    want_value, want_grad = jax_sum20_value_and_grad()(params, jnp.asarray(X), jnp.asarray(y))

    tdtype = getattr(torch, dtype)
    leaves = {k: torch.tensor(v, dtype=tdtype, requires_grad=True) for k, v in SUM20_PARAMS.items()}
    gp = GaussianProcess(sum20_kernel(tq, leaves), torch.as_tensor(X), diag=0.1,
                         assume_sorted=True, device="cpu")
    assert gp.solver.ssm[1].shape == (20, N_SUM)
    value = gp.log_probability(torch.as_tensor(y))
    grads = torch.autograd.grad(value, list(leaves.values()))
    assert value.dtype == tdtype and torch.isfinite(value)
    assert_allclose(value.detach(), want_value)
    for name, g in zip(leaves, grads):
        assert torch.isfinite(g), name
        assert_allclose(g, want_grad[name])


# ---------------------------------------------------------------------------
# The sums conditioned, and the m = 5 sum's posterior process (order 20).
# ---------------------------------------------------------------------------

SUMS = {"sum5": (sum_kernel, SUM_PARAMS), "sum9": (sum9_kernel, SUM9_PARAMS)}


@functools.cache
def jax_sum_condition(name):
    """The JAX package's ``condition(y)`` of a sum, where its ``condition``
    takes them: the log probability and mean of ``_condition``, the
    variance as the diagonal of ``solver.condition`` with the posterior's
    default jitter; sequential scans."""
    kernel_of, params = SUMS[name]

    @jax.jit
    def run(X, y):
        gp = JaxGP(kernel_of(jq, params), X, diag=0.1, assume_sorted=True, parallel=False)
        _, log_prob, loc = gp._condition(y, None, True)
        noise = jnoise.Diagonal(diag=jnp.full(X.shape, jnp.sqrt(jnp.finfo(X.dtype).eps)))
        return log_prob, loc, gp.solver.condition(gp.kernel, None, noise).diag.d

    X, y = data(N_SUM, seed=20)
    return X, y, [np.asarray(a) for a in run(jnp.asarray(X), jnp.asarray(y))]


@pytest.mark.parametrize("name", sorted(SUMS))
def test_sum_condition_matches_jax(name):
    """The couplings of order m and 2m (5 and 10, 9 and 18) under the
    posterior's mean and variance, float64, at the tolerance table's 5e-7."""
    X, y, want = jax_sum_condition(name)
    kernel_of, params = SUMS[name]
    gp = GaussianProcess(kernel_of(tq, params), torch.as_tensor(X), diag=0.1,
                         assume_sorted=True, device="cpu")
    log_prob, post = gp.condition(torch.as_tensor(y))
    for got, ref in zip((log_prob, post.loc, post.variance), want):
        assert got.dtype == torch.float64 and torch.isfinite(got).all()
        assert_allclose(got, ref)


def test_order_20_posterior_log_probability_matches_jax_and_dense():
    """The m = 5 sum's posterior process given ``diag=1e-3`` (order 20):
    its ``log_probability`` against the JAX package's, built as its
    ``condition`` builds it with a sequential solver, at 5e-7, and against
    a dense Cholesky of the same posterior at 1e-8."""
    X, y = data(N_SUM, seed=21)
    Xj, yj = jnp.asarray(X), jnp.asarray(y)

    @jax.jit
    def jax_log_prob(X, y):
        gp = JaxGP(sum_kernel(jq, SUM_PARAMS), X, diag=0.1, assume_sorted=True, parallel=False)
        _, _, loc = gp._condition(y, None, True)
        noise = jnoise.Diagonal(diag=jnp.full(X.shape, 1e-3))
        cov = gp.solver.condition(gp.kernel, None, noise)
        post = JaxQuasisepSolver(None, X, noise, covariance=cov, parallel=False)
        return post.log_likelihood(y - loc)

    gp = GaussianProcess(sum_kernel(tq, SUM_PARAMS), torch.as_tensor(X), diag=0.1,
                         assume_sorted=True, device="cpu")
    post = gp.condition(torch.as_tensor(y), diag=1e-3)[1]
    assert post.solver.matrix.lower.p.shape == (N_SUM, 20)
    got = post.log_probability(torch.as_tensor(y))
    assert torch.isfinite(got)
    assert_allclose(got, jax_log_prob(Xj, yj))
    L = torch.linalg.cholesky(post.solver.matrix.to_dense())
    z = torch.linalg.solve_triangular(L, (torch.as_tensor(y) - post.loc)[:, None], upper=False)
    dense = (-0.5 * torch.sum(z * z) - torch.sum(torch.log(torch.diagonal(L)))
             - 0.5 * N_SUM * np.log(2 * np.pi))
    np.testing.assert_allclose(float(got), float(dense), rtol=1e-8)


# ---------------------------------------------------------------------------
# The posterior process (order 4m) against a dense posterior.
# ---------------------------------------------------------------------------

N_POST = 50
POSTERIOR_MODELS = {
    "sho": lambda q: 1.2 * q.SHO(omega=1.5, quality=3.0),
    "matern52": lambda q: 1.5 * q.Matern52(scale=2.5),
    "celerite2": lambda q: q.Celerite(a=1.0, b=0.1, c=0.5, d=1.0)
    + q.Celerite(a=0.5, b=0.05, c=1.5, d=3.0),
}


@functools.cache
def dense_posterior(name, post_diag):
    """The posterior at the training points from the JAX package's kernel
    matrix K and ``condition`` mean: covariance ``K - K (K + D)^-1 K``, with
    D = 0.1 I, plus the posterior's noise, written ``V diag(s) V^T`` from
    the eigendecomposition of K (s = 0.1 lam / (lam + 0.1) + noise), which
    avoids the cancellation of the direct difference. Returns the data,
    the mean, V and s."""
    X, y = data(N_POST, seed=11)

    @jax.jit
    def reference(X, y):
        gp = JaxGP(POSTERIOR_MODELS[name](jq), X, diag=0.1, parallel=False)
        _, _, loc = gp._condition(y, None, True)
        return POSTERIOR_MODELS[name](jq)(X, X), loc

    K, loc = (np.asarray(a) for a in reference(jnp.asarray(X), jnp.asarray(y)))
    noise = np.sqrt(np.finfo(np.float64).eps) if post_diag is None else post_diag
    lam, V = np.linalg.eigh(K)
    return X, y, loc, V, 0.1 * lam / (lam + 0.1) + noise


def port_posterior(name, post_diag):
    X, y = data(N_POST, seed=11)
    gp = GaussianProcess(POSTERIOR_MODELS[name](tq), torch.as_tensor(X), diag=0.1, device="cpu")
    _, post = gp.condition(torch.as_tensor(y), diag=post_diag)
    return post


def posterior_rtol(s):
    """The tolerance from the conditioning of the posterior covariance.

    With its default noise (the 1.49e-8 jitter) the posterior is nearly
    singular: its smallest eigenvalue is the jitter and its condition number
    kappa reaches 7e6 for Matern52. The O(N) factor's Riccati recursion then
    divides by pivots as small as the jitter, and a float64 answer is good
    to about kappa^2 eps: on these inputs the JAX package's own O(N)
    posterior log probability deviates from this oracle by 2.0e-4 (SHO) and
    5.0e-2 (Matern52), the port's by 1.5e-4 and 3.4e-2, while the dense form
    of the port's own posterior matrix matches it to 1e-8. So: 10 kappa^2
    eps, and never below 1e-8, which holds the well-conditioned cases
    (celerite2, whose kappa is 56, and every posterior given diag=1e-3).
    """
    kappa = s.max() / s.min()
    return max(1e-8, 10 * kappa**2 * np.finfo(np.float64).eps)


CASES = [(name, post_diag) for name in POSTERIOR_MODELS for post_diag in (None, 1e-3)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1] or 'jitter'}")
def test_posterior_log_probability_matches_dense(case):
    name, post_diag = case
    X, y, loc, V, s = dense_posterior(*case)
    z = V.T @ (y - loc)
    want = -0.5 * np.sum(z * z / s) - 0.5 * np.sum(np.log(s)) - 0.5 * N_POST * np.log(2 * np.pi)
    post = port_posterior(*case)
    assert post.solver.matrix.diag.d.shape == (N_POST,)
    got = post.log_probability(torch.as_tensor(y))
    assert torch.isfinite(got)
    np.testing.assert_allclose(float(got), want, rtol=posterior_rtol(s))
    assert_allclose(post.loc, loc)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1] or 'jitter'}")
def test_posterior_sample_matches_dense(case):
    X, y, loc, V, s = dense_posterior(*case)
    post = port_posterior(*case)
    draws = post.sample(torch.Generator().manual_seed(3), (4,))
    # The same white noise the process draws, through the dense factor.
    eps = torch.randn((N_POST, 4), generator=torch.Generator().manual_seed(3), dtype=torch.float64)
    S = (V * s) @ V.T
    want = loc + (np.linalg.cholesky(0.5 * (S + S.T)) @ eps.numpy()).T
    assert draws.shape == (4, N_POST) and torch.isfinite(draws).all()
    err = float(np.max(np.abs(draws.numpy() - want)) / np.max(np.abs(want)))
    assert err <= posterior_rtol(s)


# ---------------------------------------------------------------------------
# Products of QSMs of unequal orders.
# ---------------------------------------------------------------------------

PRODUCTS = [
    (a, b, orders)
    for a, b in [("SquareQSM", "SquareQSM"), ("LowerTriQSM", "UpperTriQSM"), ("SymmQSM", "SymmQSM")]
    for orders in [(2, 4), (3, 6)]
]


@pytest.mark.parametrize("case", PRODUCTS, ids=lambda c: f"{c[0]}@{c[1]}-{c[2][0]}x{c[2][1]}")
def test_qsm_mul_of_unequal_orders_matches_dense(case, monkeypatch):
    a_name, b_name, (m1, m2) = case
    A = qsm_from_tree(random_qsm_tree(a_name, 60, m1, seed=1), device="cpu")
    B = qsm_from_tree(random_qsm_tree(b_name, 60, m2, seed=2), device="cpu")
    pairs = []
    coupling = cuda_scan.coupling

    def recording(As, Bs, Cs, m1, m2, **kwargs):
        pairs.append((m1, m2))
        return coupling(As, Bs, Cs, m1, m2, **kwargs)

    monkeypatch.setattr(cuda_scan, "coupling", recording)
    got = A @ B
    assert (m1, m2) in pairs and all(p[0] != p[1] for p in pairs)
    assert_allclose(got.to_dense(), A.to_dense() @ B.to_dense())


# ---------------------------------------------------------------------------
# The wrappers on CPU tensors at m = 5 and 8.
# ---------------------------------------------------------------------------

N_WRAP = 300


def tensors(arrays):
    return [torch.as_tensor(np.asarray(x)) for x in arrays]


@pytest.mark.parametrize("m", [5, 8])
def test_loglik_wrappers_at_high_order_match_plain(m):
    """B1, B1r and B2's wrappers are their plain versions on the CPU and
    launch nothing. The plain versions are held to a dense Cholesky of the
    same K (B1) and to autograd through the plain forward (B2)."""
    arrays = random_qsm_operands(m, N_WRAP, seed=m)
    qbar, lbar = tensors(np.random.default_rng(m).normal(size=2))
    before = (cuda_loglik.LAUNCHES, cuda_loglik.LAUNCHES_RES, cuda_loglik.LAUNCHES_BWD,
              dict(cuda_loglik.LAUNCHES_GENERIC))

    args = tensors(arrays)
    value = cuda_loglik.fused_loglik_terms(*args)
    res = cuda_loglik.fused_loglik_res(*args)
    plain = cuda_loglik.plain_loglik_terms_res(*args)
    assert [float(x) for x in value] == [float(x) for x in plain[:2]]
    assert all(torch.equal(g, w) for g, w in zip(res, plain))
    bwd_args = (*args[1:], *res[2:], qbar, lbar)
    bars = cuda_loglik.fused_loglik_bwd(*bwd_args)
    assert all(torch.equal(g, w) for g, w in zip(bars, cuda_loglik.plain_loglik_bwd(*bwd_args)))
    after = (cuda_loglik.LAUNCHES, cuda_loglik.LAUNCHES_RES, cuda_loglik.LAUNCHES_BWD,
             dict(cuda_loglik.LAUNCHES_GENERIC))
    assert after == before

    d, ps, qs, as_, y = args
    K = SymmQSM.from_stacked(d, ps, qs, as_).to_dense()
    L = torch.linalg.cholesky(K)
    alpha = torch.linalg.solve_triangular(L, y[:, None], upper=False)[:, 0]
    assert_allclose(value[0], torch.sum(alpha * alpha))
    assert_allclose(value[1], torch.sum(torch.log(torch.diagonal(L))))

    leaves = [x.clone().requires_grad_(True) for x in args]
    quad, logdet = cuda_loglik.plain_loglik_terms(*leaves)
    want = torch.autograd.grad(qbar * quad + lbar * logdet, leaves)
    for g, w in zip(bars, want):
        assert g.shape == w.shape and torch.isfinite(g).all()
        assert_allclose(g, w)


def sequential_coupling(As, Bs, Cs, m1, m2):
    """The exclusive prefix of g' = A g B^T + C, one element at a time."""
    A, B, C = (x.reshape(a, b, -1).permute(2, 0, 1)
               for x, a, b in ((As, m1, m1), (Bs, m2, m2), (Cs, m1, m2)))
    g = torch.zeros(m1, m2, dtype=As.dtype)
    out = []
    for k in range(As.shape[-1]):
        out.append(g)
        g = A[k] @ g @ B[k].T + C[k]
    return torch.stack(out, dim=-1).reshape(m1 * m2, -1)


@pytest.mark.parametrize("m", [5, 8])
@pytest.mark.parametrize("monoid", ["aff", "cong", "ric", "cpl"])
def test_scan_wrappers_at_high_order_match_plain(monoid, m):
    """B3's wrappers are the plain stacked scans on the CPU and launch
    nothing; those are held to the sequential recurrences (scan.py's
    ``parallel=False`` oracle, and a loop for the coupling of orders m and
    m - 3)."""
    d, ps, qs, as_, _ = random_qsm_operands(m, N_WRAP, seed=10 * m)
    rng = np.random.default_rng(m)
    before = (dict(cuda_scan.LAUNCHES), dict(cuda_scan.LAUNCHES_GENERIC))
    rows = scan._unpack3
    if monoid == "aff":
        As, Bs = tensors([as_, rng.normal(size=(m * 3, N_WRAP))])
        got = cuda_scan.affine(As, Bs, m, 3, reverse=True, exclusive=False)
        plain = scan._affine_scan_s(As, Bs, m, 3, reverse=True, exclusive=False)
        want = scan._pack3(scan.affine_scan(rows(As, m, m), rows(Bs, m, 3), reverse=True,
                                            parallel=False, exclusive=False))
    elif monoid == "cong":
        As, Bs = tensors([as_, rng.normal(size=(m * m, N_WRAP))])
        got = cuda_scan.congruence(As, Bs, m, reverse=True)
        plain = scan._congruence_scan_s(As, Bs, m, reverse=True)
        want = scan._pack3(scan.congruence_scan(rows(As, m, m), rows(Bs, m, m), reverse=True,
                                                parallel=False))
    elif monoid == "ric":
        d, ps, qs, As = tensors([d, ps, qs, as_])
        got = cuda_scan.riccati(d, ps, qs, As)
        plain = scan._riccati_scan_s(d, ps, qs, As, m)
        want = scan._pack3(scan.riccati_scan(d, ps.T, qs.T, rows(As, m, m), parallel=False))
    else:
        m2 = m - 3
        As, Bs, Cs = tensors([as_, random_qsm_operands(m2, N_WRAP, seed=m)[3],
                              rng.normal(size=(m * m2, N_WRAP))])
        got = cuda_scan.coupling(As, Bs, Cs, m, m2, reverse=False)
        plain = scan._coupling_scan_s(As, Bs, Cs, m, m2, reverse=False, exclusive=True)
        want = sequential_coupling(As, Bs, Cs, m, m2)
    assert torch.equal(got, plain) and torch.isfinite(got).all()
    assert_allclose(got, want)
    assert (dict(cuda_scan.LAUNCHES), dict(cuda_scan.LAUNCHES_GENERIC)) == before
