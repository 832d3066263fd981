"""Gradients of the port's log-likelihood against the JAX package: the
hand-written adjoints of ``scan.py``, the plain versions of kernels B1r and
B2, the ``torch.autograd.Function`` around them, and ``GaussianProcess``
gradients. Float64 at the tolerance table's 5e-7 unless noted. The CUDA
kernels are held to these plain versions in ``test_torch_cuda.py``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinygp_tpu import GaussianProcess as JaxGP
from tinygp_tpu.kernels import quasisep as jq
from tinygp_tpu.solvers.quasisep import ops as jops
from tinygp_tpu.solvers.quasisep import scan as jscan
from tinygp_tpu_torch import GaussianProcess
from tinygp_tpu_torch.kernels import quasisep as tq
from tinygp_tpu_torch.solvers.quasisep import cuda_loglik, ops, scan
from tinygp_tpu_torch.test_utils import assert_allclose, random_qsm_operands

N_LONG = 2 * 8192 + 777


def tensors(arrays, dtype=torch.float64, requires_grad=False):
    return [
        torch.tensor(np.asarray(x), dtype=dtype, requires_grad=requires_grad)
        for x in arrays
    ]


def scan_operands(m, n, k, seed):
    """Contracting transitions (m*m, n) and loads (m*k, n)."""
    rng = np.random.default_rng(seed)
    As = 0.2 * rng.normal(size=(m * m, n)) + 0.5 * np.eye(m).reshape(-1, 1)
    return As, rng.normal(size=(m * k, n))


# ---------------------------------------------------------------------------
# The hand-written adjoints of scan.py.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reverse", [False, True])
def test_congruence_scan_matches_jax(reverse):
    As, Bs = scan_operands(2, 300, 2, seed=1)
    want = jscan._congruence_scan_s(jnp.asarray(As), jnp.asarray(Bs), 2, reverse=reverse)
    got = scan._congruence_scan_s(*tensors([As, Bs]), 2, reverse=reverse)
    assert torch.isfinite(got).all()
    assert_allclose(got, want)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("exclusive", [False, True])
def test_affine_bwd_matches_jax(reverse, exclusive):
    m, r, n = 2, 3, 300
    As, Bs = scan_operands(m, n, r, seed=2)
    ebar = np.random.default_rng(3).normal(size=(m * r, n))
    kw = dict(reverse=reverse, exclusive=exclusive)
    es = np.asarray(jscan._affine_scan_s(jnp.asarray(As), jnp.asarray(Bs), m, r, **kw))
    want = jscan._affine_bwd_s(*map(jnp.asarray, (As, es, ebar)), m, r, **kw)
    got = scan._affine_bwd_s(*tensors([As, es, ebar]), m, r, **kw)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert_allclose(g, w)


def test_riccati_bwd_matches_jax():
    m, n = 2, 300
    d, ps, qs, as_, _ = random_qsm_operands(m, n, seed=4)
    Fs = np.asarray(jscan._riccati_scan_s(*map(jnp.asarray, (d, ps, qs, as_)), m))
    Ybar = np.random.default_rng(5).normal(size=(m * m, n))
    res = (d, ps, qs, as_, Fs)
    want = jscan._riccati_bwd_s(tuple(map(jnp.asarray, res)), jnp.asarray(Ybar))
    got = scan._riccati_bwd_s(tuple(tensors(res)), tensors([Ybar])[0])
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert_allclose(g, w)


# ---------------------------------------------------------------------------
# The plain versions of B1r and B2.
# ---------------------------------------------------------------------------


def cotangents(seed, dtype=np.float64):
    return np.random.default_rng(seed).normal(size=2).astype(dtype)


@jax.jit
def _jax_reference(d, ps, qs, as_, y, qbar, lbar):
    """``jax.vjp`` of ``stacked_loglik_terms`` at ``(qbar, lbar)``, and F, e
    and 1/c from the JAX package's Riccati scan and emissions (one program,
    so that each shape compiles once)."""
    m = ps.shape[0]
    _, vjp = jax.vjp(jops.stacked_loglik_terms, d, ps, qs, as_, y)
    Fs = jscan._riccati_scan_s(d, ps, qs, as_, m)
    Fp = jscan._smv(Fs, ps, m, m)
    ic = 1.0 / jnp.sqrt(d - jnp.sum(ps * Fp, axis=0))
    wd = (qs - jscan._smv(as_, Fp, m, m)) * ic * ic
    e = jscan.affine_scan_stacked(as_ - jscan._souter(wd, ps), wd * y, m, 1)
    return vjp((qbar, lbar)), (Fs, e, ic)


def jax_reference(arrays, qbar, lbar):
    return _jax_reference(*map(jnp.asarray, arrays), jnp.asarray(qbar), jnp.asarray(lbar))


@pytest.mark.parametrize("m", [1, 2, 3, 4])
def test_residuals_match_jax(m):
    arrays = random_qsm_operands(m, 300, seed=m)
    got = cuda_loglik.plain_loglik_terms_res(*tensors(arrays))
    value = cuda_loglik.plain_loglik_terms(*tensors(arrays))
    assert [float(x) for x in got[:2]] == [float(x) for x in value]
    shapes = [(m * m, 300), (m, 300), (300,)]
    _, want = jax_reference(arrays, *cotangents(m))
    for g, w, shape in zip(got[2:], want, shapes):
        assert g.shape == shape and g.is_contiguous()
        assert_allclose(g, w)


def plain_bwd(arrays, qbar, lbar, dtype=torch.float64):
    d, ps, qs, as_, y = tensors(arrays, dtype)
    _, _, Fs, e, ic = cuda_loglik.plain_loglik_terms_res(d, ps, qs, as_, y)
    qbar, lbar = tensors([qbar, lbar], dtype)
    return cuda_loglik.plain_loglik_bwd(ps, qs, as_, y, Fs, e, ic, qbar, lbar)


@pytest.mark.parametrize(
    "m,n", [(1, 300), (2, 300), (3, 300), (4, 300), (2, N_LONG)]
)
def test_plain_bwd_matches_jax_vjp(m, n):
    arrays = random_qsm_operands(m, n, seed=10 + m)
    qbar, lbar = cotangents(m)
    want, _ = jax_reference(arrays, qbar, lbar)
    got = plain_bwd(arrays, qbar, lbar)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.isfinite(g).all()
        assert_allclose(g, w)


def test_plain_bwd_float32_matches_jax_vjp():
    arrays = [x.astype(np.float32) for x in random_qsm_operands(2, N_LONG, seed=12)]
    qbar, lbar = cotangents(2, np.float32)
    want, _ = jax_reference(arrays, qbar, lbar)
    got = plain_bwd(arrays, qbar, lbar, torch.float32)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and w.dtype == jnp.float32
        assert_allclose(g, w)


@pytest.mark.parametrize("m", [1, 2, 3, 4])
def test_plain_bwd_matches_autograd(m):
    """Against autograd through the plain forward: an oracle without JAX."""
    arrays = random_qsm_operands(m, 300, seed=20 + m)
    qbar, lbar = cotangents(m)
    leaves = tensors(arrays, requires_grad=True)
    quad, logdet = cuda_loglik.plain_loglik_terms(*leaves)
    want = torch.autograd.grad(qbar * quad + lbar * logdet, leaves)
    got = plain_bwd(arrays, qbar, lbar)
    for g, w in zip(got, want):
        assert_allclose(g, w)


@pytest.mark.slow
def test_plain_bwd_matches_pallas_interpret(monkeypatch):
    """Against the TPU backward kernel itself, run in interpret mode as the
    JAX package's own test runs it (tiny tiles, two chunks and a ragged
    tail), on the same float32 residuals."""
    from tinygp_tpu.solvers.quasisep import pallas_loglik, pallas_scan

    monkeypatch.setattr(pallas_scan, "INTERPRET", True)
    monkeypatch.setenv("TINYGP_TPU_PALLAS_LLK_BLOCK", "8")
    monkeypatch.setenv("TINYGP_TPU_PALLAS_SCAN", "0")
    d, ps, qs, as_, y = tensors(random_qsm_operands(2, N_LONG, seed=321), torch.float32)
    _, _, Fs, e, ic = cuda_loglik.plain_loglik_terms_res(d, ps, qs, as_, y)
    qbar, lbar = tensors(cotangents(30, np.float32), torch.float32)
    res = (ps, qs, as_, y, Fs, e, ic, qbar, lbar)
    want = pallas_loglik._call_bwd_kernel(*(jnp.asarray(x.numpy()) for x in res))
    got = cuda_loglik.plain_loglik_bwd(*res)
    # float32 reverse scans in two association orders: each stream within
    # the tolerance table's 5e-4 of its largest magnitude.
    for g, w in zip(got, want):
        w = np.asarray(w, np.float64)
        assert np.isfinite(w).all() and torch.isfinite(g).all()
        err = np.abs(g.double().numpy() - w).max() / np.abs(w).max()
        assert err <= 5e-4


# ---------------------------------------------------------------------------
# The autograd Function.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m", [1, 2, 3])
def test_gradcheck_through_the_function(m):
    leaves = tensors(random_qsm_operands(m, 40, seed=m), requires_grad=True)
    # fast_mode: finite differences along random directions; each plain
    # forward on the CPU is a Python loop, and the full Jacobian at m = 3
    # takes minutes. The card's test runs the full Jacobian.
    assert torch.autograd.gradcheck(ops.stacked_loglik_terms, leaves, fast_mode=True)


def test_cpu_gradient_goes_through_the_function_and_launches_nothing():
    leaves = tensors(random_qsm_operands(2, 300, seed=1), requires_grad=True)
    counts = (cuda_loglik.LAUNCHES, cuda_loglik.LAUNCHES_RES, cuda_loglik.LAUNCHES_BWD)
    quad, logdet = ops.stacked_loglik_terms(*leaves)
    assert type(quad.grad_fn).__name__ == "FusedLoglikBackward"
    (quad + logdet).backward()
    with torch.no_grad():
        quad, _ = ops.stacked_loglik_terms(*leaves)
    assert quad.grad_fn is None
    after = (cuda_loglik.LAUNCHES, cuda_loglik.LAUNCHES_RES, cuda_loglik.LAUNCHES_BWD)
    assert after == counts
    assert all(x.grad is not None and torch.isfinite(x.grad).all() for x in leaves)


def test_double_backward_raises():
    leaves = tensors(random_qsm_operands(2, 100, seed=2), requires_grad=True)
    quad, logdet = ops.stacked_loglik_terms(*leaves)
    with pytest.raises(RuntimeError, match="once differentiable"):
        torch.autograd.grad(quad + logdet, leaves, create_graph=True)


# ---------------------------------------------------------------------------
# GaussianProcess gradients.
# ---------------------------------------------------------------------------

# The models of test_torch_gp.py, with their hyperparameters as arguments
# and the N each is held against jax.grad at. The m = 4 sum and the other
# kernels take N = 128, where the JAX package's scan is one sequential pass:
# its blocked program at m = 4 takes about 25 s to compile on the CPU, and
# the port's blocked scans are held to JAX's above at N = 300 and 17,161.
N_GP = 2000
N_SMALL = 128
MODELS = {
    "matern32": (
        lambda q, p: p["amp"] * q.Matern32(scale=p["scale"]),
        {"amp": 1.5, "scale": 2.5},
        N_GP,
    ),
    "sho": (
        lambda q, p: p["amp"] * q.SHO(omega=p["omega"], quality=p["quality"]),
        {"amp": 1.2, "omega": 1.5, "quality": 3.0},
        N_GP,
    ),
    "celerite2": (
        lambda q, p: q.Celerite(a=p["a1"], b=p["b1"], c=p["c1"], d=p["d1"])
        + q.Celerite(a=p["a2"], b=p["b2"], c=p["c2"], d=p["d2"]),
        {"a1": 1.0, "b1": 0.1, "c1": 0.5, "d1": 1.0,
         "a2": 0.5, "b2": 0.05, "c2": 1.5, "d2": 3.0},
        N_SMALL,
    ),
}
OTHER_KERNELS = {
    "matern52": (
        lambda q, p: q.Matern52(scale=p["scale"], sigma=p["sigma"]),
        {"scale": 1.5, "sigma": 0.8},
        N_SMALL,
    ),
    "exp": (
        lambda q, p: q.Exp(scale=p["scale"], sigma=p["sigma"]),
        {"scale": 0.7, "sigma": 1.1},
        N_SMALL,
    ),
    "cosine": (
        lambda q, p: q.Cosine(scale=p["scale"], sigma=p["sigma"]),
        {"scale": 3.0, "sigma": 0.9},
        N_SMALL,
    ),
}
ALL_MODELS = {**MODELS, **OTHER_KERNELS}


def gp_data(n, seed=42):
    rng = np.random.default_rng(seed)
    return np.sort(rng.uniform(0, 10, n)), rng.normal(size=n)


@functools.cache
def jax_value_and_grad(name):
    """One jitted ``jax.value_and_grad`` per model, shared by the tests."""
    build = ALL_MODELS[name][0]

    def logprob(params, diag, mean, y, X):
        gp = JaxGP(build(jq, params), X, diag=diag, mean=mean, assume_sorted=True)
        return gp.log_probability(y)

    return jax.jit(jax.value_and_grad(logprob, argnums=(0, 1, 2, 3)))


def jax_grads(name, X, y, diag, mean):
    params = {k: jnp.asarray(v) for k, v in ALL_MODELS[name][1].items()}
    args = (jnp.asarray(diag), jnp.asarray(mean), jnp.asarray(y), jnp.asarray(X))
    return jax_value_and_grad(name)(params, *args)


def torch_grads(name, X, y, diag, mean):
    build, params, _ = ALL_MODELS[name]
    leaves = {k: torch.tensor(v, dtype=torch.float64, requires_grad=True) for k, v in params.items()}
    diag_t, mean_t, y_t = tensors([diag, mean, y], requires_grad=True)
    gp = GaussianProcess(build(tq, leaves), torch.as_tensor(X), diag=diag_t, mean=mean_t,
                         assume_sorted=True, device="cpu")
    value = gp.log_probability(y_t)
    names = list(leaves)
    grads = torch.autograd.grad(value, [leaves[k] for k in names] + [diag_t, mean_t, y_t])
    return value, dict(zip(names, grads[: len(names)])), grads[len(names):]


def check_gp_gradient(name):
    X, y = gp_data(ALL_MODELS[name][2])
    want_value, (want_p, want_diag, want_mean, want_y) = jax_grads(name, X, y, 0.1, 0.3)
    value, got_p, (got_diag, got_mean, got_y) = torch_grads(name, X, y, 0.1, 0.3)
    assert_allclose(value.detach(), want_value)
    assert set(got_p) == set(want_p)
    for key, g in got_p.items():
        assert torch.isfinite(g), key
        assert_allclose(g, want_p[key])
    assert_allclose(got_diag, want_diag)
    assert_allclose(got_mean, want_mean)
    assert_allclose(got_y, want_y)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_gp_gradient_matches_jax(name):
    check_gp_gradient(name)


@pytest.mark.parametrize("name", sorted(OTHER_KERNELS))
def test_gp_gradient_reaches_every_hyperparameter(name):
    """A hyperparameter tensor that requires grad survives ``register_buffer``
    and the process's ``kernel.to(device, dtype)``: its gradient, and those
    of ``diag``, the mean and ``y``, match ``jax.grad`` of the JAX process."""
    check_gp_gradient(name)


def test_gradient_at_an_indefinite_covariance_matches_jax():
    """diag = -10 makes K indefinite: log_probability is -inf and jax.grad
    gives NaN for every input; the port gives the same."""
    X, y = gp_data(N_GP)
    want_value, want = jax_grads("matern32", X, y, -10.0, 0.0)
    value, got_p, got_rest = torch_grads("matern32", X, y, -10.0, 0.0)
    assert float(want_value) == value.item() == -np.inf
    want_flat = [want[0][k] for k in got_p] + list(want[1:])
    for g, w in zip(list(got_p.values()) + list(got_rest), want_flat):
        np.testing.assert_array_equal(np.isnan(g.numpy()), np.isnan(np.asarray(w)))
        assert_allclose(g, w)
