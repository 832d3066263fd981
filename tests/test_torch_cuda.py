"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA device and skips without one. This file
imports no JAX, so it also runs where only PyTorch is installed:
``python -m pytest -o addopts="" --noconftest -q tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from tinygp_tpu_torch import GaussianProcess
from tinygp_tpu_torch.kernels import quasisep
from tinygp_tpu_torch.solvers.quasisep import cuda_loglik
from tinygp_tpu_torch.test_utils import random_qsm_operands

N = 2 * 8192 + 777


def operands(m, n, dtype, device, seed=321):
    arrays = random_qsm_operands(m, n, seed)
    return [torch.as_tensor(x, dtype=dtype, device=device) for x in arrays]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# m = 1..4: the templated kernels; above, the generic-order sources.
LOGLIK_ORDERS = [1, 2, 3, 4, 5, 8]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("m", LOGLIK_ORDERS)
def test_kernel_matches_plain(cuda_device, m, dtype):
    args = operands(m, N, dtype, cuda_device, seed=m)
    before = cuda_loglik.LAUNCHES, cuda_loglik.LAUNCHES_GENERIC["b1"]
    got = cuda_loglik.fused_loglik_terms(*args)
    torch.cuda.synchronize()
    assert cuda_loglik.LAUNCHES == before[0] + 1
    assert cuda_loglik.LAUNCHES_GENERIC["b1"] == before[1] + (m > 4)
    want = cuda_loglik.plain_loglik_terms(*args)
    # float64: the kernel's sequential in-chunk recurrence against the
    # plain blocked Moebius scan differ only by rounding; float32 is the
    # tolerance table's.
    rtol = 1e-8 if dtype == torch.float64 else 5e-4
    for g, w in zip(got, want):
        assert np.isfinite(float(g))
        np.testing.assert_allclose(float(g), float(w), rtol=rtol)


@pytest.mark.cuda
def test_gp_on_the_card_matches_cpu(cuda_device):
    rng = np.random.default_rng(42)
    X = np.sort(rng.uniform(0, 10, 5000))
    y = rng.normal(size=5000)

    def logprob(device):
        kernel = quasisep.Celerite(a=1.0, b=0.1, c=0.5, d=1.0) + quasisep.Celerite(
            a=0.5, b=0.05, c=1.5, d=3.0
        )
        gp = GaussianProcess(
            kernel, torch.as_tensor(X), diag=0.1, assume_sorted=True, device=device
        )
        return gp.log_probability(y).item()

    before = cuda_loglik.LAUNCHES
    on_card = logprob(None)
    assert cuda_loglik.LAUNCHES == before + 1
    assert np.isfinite(on_card)
    np.testing.assert_allclose(on_card, logprob("cpu"), rtol=1e-9)


@pytest.mark.cuda
def test_kernel_refuses_what_it_cannot_do(cuda_device):
    with pytest.raises(NotImplementedError, match="N10"):
        cuda_loglik.fused_loglik_terms(*operands(33, 300, torch.float64, cuda_device))
    args = operands(2, 300, torch.float64, cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_loglik.fused_loglik_terms(args[0], args[1], args[2], args[3].t().contiguous().t(), args[4])


def stream_err(got, want):
    """Largest error relative to the stream's largest magnitude."""
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-300))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("m", LOGLIK_ORDERS)
def test_res_and_bwd_kernels_match_plain(cuda_device, m, dtype):
    args = operands(m, N, dtype, cuda_device, seed=m)
    rtol = 1e-8 if dtype == torch.float64 else 5e-4
    before = (cuda_loglik.LAUNCHES, cuda_loglik.LAUNCHES_RES, cuda_loglik.LAUNCHES_BWD)
    got = cuda_loglik.fused_loglik_res(*args)
    b1 = cuda_loglik.fused_loglik_terms(*args)
    want = cuda_loglik.plain_loglik_terms_res(*args)
    # B1r runs B1's code, so its two sums are B1's exactly.
    assert [float(x) for x in got[:2]] == [float(x) for x in b1]
    for g, w in zip(got, want):
        assert torch.isfinite(g).all() and stream_err(g, w) <= rtol

    rng = np.random.default_rng(m)
    qbar, lbar = (torch.tensor(v, dtype=dtype, device=cuda_device) for v in rng.normal(size=2))
    res = tuple(args[1:]) + tuple(want[2:])
    got = cuda_loglik.fused_loglik_bwd(*res, qbar, lbar)
    torch.cuda.synchronize()
    want = cuda_loglik.plain_loglik_bwd(*res, qbar, lbar)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all() and stream_err(g, w) <= rtol
    after = (cuda_loglik.LAUNCHES, cuda_loglik.LAUNCHES_RES, cuda_loglik.LAUNCHES_BWD)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 2, 3])
def test_gradcheck_on_the_card(cuda_device, m):
    from tinygp_tpu_torch.solvers.quasisep.ops import stacked_loglik_terms

    args = [x.requires_grad_(True) for x in operands(m, 40, torch.float64, cuda_device)]
    before = cuda_loglik.LAUNCHES_BWD
    assert torch.autograd.gradcheck(stacked_loglik_terms, args)
    assert cuda_loglik.LAUNCHES_BWD > before


@pytest.mark.cuda
def test_gp_gradient_on_the_card_matches_cpu(cuda_device):
    rng = np.random.default_rng(7)
    X = np.sort(rng.uniform(0, 10, 3000))
    y = rng.normal(size=3000)

    def grads(device):
        leaves = [torch.tensor(v, dtype=torch.float64, device=device, requires_grad=True)
                  for v in (1.0, 0.5, 0.7, 0.1, 0.3)]
        a, c, amp, diag, mean = leaves
        kernel = quasisep.Celerite(a=a, b=0.1, c=c, d=1.0) + amp * quasisep.Matern32(scale=2.5)
        yt = torch.tensor(y, device=device, requires_grad=True)
        gp = GaussianProcess(kernel, torch.as_tensor(X), diag=diag, mean=mean,
                             assume_sorted=True, device=device)
        lp = gp.log_probability(yt)
        return [lp] + list(torch.autograd.grad(lp, leaves + [yt]))

    counts = (cuda_loglik.LAUNCHES, cuda_loglik.LAUNCHES_RES, cuda_loglik.LAUNCHES_BWD)
    on_card = grads(None)
    torch.cuda.synchronize()
    after = (cuda_loglik.LAUNCHES, cuda_loglik.LAUNCHES_RES, cuda_loglik.LAUNCHES_BWD)
    assert [a - b for a, b in zip(after, counts)] == [0, 1, 1]
    for g, w in zip(on_card, grads("cpu")):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.detach().cpu().numpy(), w.detach().numpy(), rtol=1e-9, atol=1e-12)


@pytest.mark.cuda
def test_fit_map_on_the_card_from_numpy_starts(cuda_device):
    """Numpy starts go to the card by default; every step runs B1r and B2
    once, and the trace matches the same fit on the CPU."""
    from tinygp_tpu_torch import fit_map

    rng = np.random.default_rng(3)
    X = np.sort(rng.uniform(0, 10, 2000))
    y = rng.normal(size=2000)

    def fit(device):
        Xt, yt = (torch.as_tensor(a, device=device or cuda_device) for a in (X, y))

        def loss_fn(p):
            kernel = torch.exp(p["log_amp"]) * quasisep.Matern32(scale=torch.exp(p["log_scale"]))
            gp = GaussianProcess(kernel, Xt, diag=0.1, assume_sorted=True, device=device)
            return -gp.log_probability(yt)

        init = {"log_amp": np.float64(np.log(1.5)), "log_scale": np.log(np.array(2.5))}
        return fit_map(loss_fn, init, num_steps=5, device=device)

    counts = (cuda_loglik.LAUNCHES, cuda_loglik.LAUNCHES_RES, cuda_loglik.LAUNCHES_BWD)
    on_card = fit(None)
    torch.cuda.synchronize()
    after = (cuda_loglik.LAUNCHES, cuda_loglik.LAUNCHES_RES, cuda_loglik.LAUNCHES_BWD)
    assert [a - b for a, b in zip(after, counts)] == [0, 5, 5]
    assert on_card.losses.device.type == "cuda"
    assert all(v.device.type == "cuda" and v.dtype == torch.float64 for v in on_card.params.values())
    assert torch.isfinite(on_card.losses).all() and float(on_card.loss) < float(on_card.losses[0])
    on_cpu = fit("cpu")
    np.testing.assert_allclose(on_card.losses.cpu().numpy(), on_cpu.losses.numpy(), rtol=1e-9)


# ---------------------------------------------------------------------------
# Kernel B3, the generic monoid scan.
# ---------------------------------------------------------------------------

# (monoid, reverse, exclusive, columns)
SCANS = [
    ("aff", False, True, 1),
    ("aff", True, True, 1),
    ("aff", False, False, 8),
    ("aff", True, False, 8),
    ("aff", True, False, 1),
    ("cong", False, True, 1),
    ("cong", True, True, 1),
    ("ric", False, True, 1),
    ("cpl", False, True, 1),
    ("cpl", True, True, 1),
]


def scan_case(monoid, m, n, r, dtype, device, seed, m2=None):
    """The wrapper's operands for one monoid: contracting transitions from
    ``random_qsm_operands`` and normal loads (the coupling's second order
    is ``m2``, ``m`` if not given)."""
    m2 = m if m2 is None else m2
    d, ps, qs, as_, _ = random_qsm_operands(m, n, seed)
    rng = np.random.default_rng(seed + 1)

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype, device=device)

    if monoid == "aff":
        return (t(as_), t(rng.normal(size=(m * r, n)))), m, r
    if monoid == "cong":
        return (t(as_), t(rng.normal(size=(m * m, n)))), m, 1
    if monoid == "ric":
        return (t(d), t(ps), t(qs), t(as_)), m, 1
    as2 = random_qsm_operands(m2, n, seed + 2)[3]
    return (t(as_), t(as2), t(rng.normal(size=(m * m2, n)))), m, 1


def run_scan(monoid, operands, m, r, reverse, exclusive, m2=None):
    from tinygp_tpu_torch.solvers.quasisep import cuda_scan

    if monoid == "aff":
        return cuda_scan.affine(*operands, m, r, reverse=reverse, exclusive=exclusive)
    if monoid == "cong":
        return cuda_scan.congruence(*operands, m, reverse=reverse)
    if monoid == "ric":
        return cuda_scan.riccati(*operands)
    m2 = m if m2 is None else m2
    return cuda_scan.coupling(*operands, m, m2, reverse=reverse, exclusive=exclusive)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 8, 16])
@pytest.mark.parametrize("case", SCANS, ids=lambda c: "-".join(map(str, c)))
def test_scan_kernel_matches_plain(cuda_device, case, m, dtype):
    from tinygp_tpu_torch.solvers.quasisep import cuda_scan

    monoid, reverse, exclusive, r = case
    operands, m, r = scan_case(monoid, m, N, r, dtype, cuda_device, seed=10 * m)
    before = dict(cuda_scan.LAUNCHES), dict(cuda_scan.LAUNCHES_GENERIC)
    got = run_scan(monoid, operands, m, r, reverse, exclusive)
    torch.cuda.synchronize()
    assert cuda_scan.LAUNCHES[monoid] == before[0][monoid] + 1
    assert cuda_scan.LAUNCHES_GENERIC[monoid] == before[1][monoid] + (m > 4)
    # The plain version: the same wrapper on the CPU.
    want = run_scan(monoid, [x.cpu() for x in operands], m, r, reverse, exclusive)
    rtol = 1e-8 if dtype == torch.float64 else 5e-4
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert stream_err(got, want) <= rtol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("orders", [(2, 4), (4, 8), (3, 6), (8, 2)], ids=lambda o: f"{o[0]}x{o[1]}")
@pytest.mark.parametrize("reverse", [False, True])
def test_scan_kernel_couples_unequal_orders(cuda_device, orders, reverse, dtype):
    from tinygp_tpu_torch.solvers.quasisep import cuda_scan

    m1, m2 = orders
    operands, _, _ = scan_case("cpl", m1, N, 1, dtype, cuda_device, seed=m1 + m2, m2=m2)
    before = cuda_scan.LAUNCHES_GENERIC["cpl"]
    got = run_scan("cpl", operands, m1, 1, reverse, True, m2=m2)
    torch.cuda.synchronize()
    assert cuda_scan.LAUNCHES_GENERIC["cpl"] == before + 1
    want = run_scan("cpl", [x.cpu() for x in operands], m1, 1, reverse, True, m2=m2)
    rtol = 1e-8 if dtype == torch.float64 else 5e-4
    assert got.shape == (m1 * m2, N) and torch.isfinite(got).all()
    assert stream_err(got, want) <= rtol


@pytest.mark.cuda
def test_scan_kernel_refuses_what_it_cannot_do(cuda_device):
    from tinygp_tpu_torch.solvers.quasisep import cuda_scan

    operands, m, r = scan_case("aff", 33, 300, 1, torch.float64, cuda_device, seed=1)
    with pytest.raises(NotImplementedError, match="N10"):
        cuda_scan.affine(*operands, m, r, reverse=False, exclusive=True)
    operands, m, r = scan_case("aff", 2, 300, 1, torch.float64, cuda_device, seed=1)
    with pytest.raises(NotImplementedError, match="backward"):
        cuda_scan.affine(operands[0].requires_grad_(), operands[1], m, r,
                         reverse=False, exclusive=True)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_scan.affine(operands[0].detach().t().contiguous().t(), operands[1], m, r,
                         reverse=False, exclusive=True)


# ---------------------------------------------------------------------------
# Conditioning on the card, through B3, against the CPU's plain versions.
# ---------------------------------------------------------------------------


def condition_outputs(device, n=3000):
    from tinygp_tpu_torch.solvers.quasisep import cuda_scan

    rng = np.random.default_rng(9)
    X = np.sort(rng.uniform(0, 10, n))
    y = np.sin(2.0 * X) + 0.3 * rng.normal(size=n)
    X_test = np.linspace(-0.5, 10.5, 200)
    eps = rng.normal(size=(n, 4))
    kernel = 1.5 * quasisep.Matern32(scale=2.5)
    gp = GaussianProcess(kernel, torch.as_tensor(X), diag=0.1, assume_sorted=True, device=device)
    before = dict(cuda_scan.LAUNCHES)
    log_prob, post = gp.condition(y)
    out = [log_prob, post.loc, post.variance, gp.predict(y, X_test),
           gp.solver.dot_triangular(torch.as_tensor(eps, device=gp.device))]
    launched = {k: cuda_scan.LAUNCHES[k] - before[k] for k in before}
    return out, launched, post


@pytest.mark.cuda
def test_condition_on_the_card_matches_cpu(cuda_device):
    on_card, launched, _ = condition_outputs(None)
    torch.cuda.synchronize()
    # One Riccati flow (the factor), two solves for condition and two more
    # for predict plus its two rectangular scans and dot_triangular's one,
    # and the three couplings of the posterior covariance.
    assert launched == {"aff": 7, "cong": 0, "ric": 1, "cpl": 3}
    on_cpu, launched_cpu, _ = condition_outputs("cpu")
    assert launched_cpu == {"aff": 0, "cong": 0, "ric": 0, "cpl": 0}
    for g, w in zip(on_card, on_cpu):
        assert g.is_cuda and torch.isfinite(g).all()
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=1e-9, atol=1e-12)


@pytest.mark.cuda
def test_sample_on_the_card(cuda_device):
    from tinygp_tpu_torch.solvers.quasisep import cuda_scan

    X = np.linspace(0, 10, 2000)
    gp = GaussianProcess(1.5 * quasisep.Matern32(scale=2.5), torch.as_tensor(X), diag=0.1)
    before = dict(cuda_scan.LAUNCHES)
    draw = gp.sample(torch.Generator(device="cuda").manual_seed(1), (16,))
    assert draw.shape == (16, 2000) and draw.is_cuda and torch.isfinite(draw).all()
    assert cuda_scan.LAUNCHES["ric"] == before["ric"] + 1
    assert cuda_scan.LAUNCHES["aff"] == before["aff"] + 1
    again = gp.sample(torch.Generator(device="cuda").manual_seed(1), (16,))
    assert torch.equal(draw, again)


# Conditioning at orders above 4, on the card against the CPU: Matern52's
# condition couples order 6, the 2-term celerite's order 8; their posterior
# processes have order 12 and 16, the m = 2 kernels' order 8.
HIGH_ORDER_MODELS = {
    "matern32": lambda: 1.5 * quasisep.Matern32(scale=2.5),
    "matern52": lambda: 1.5 * quasisep.Matern52(scale=2.5),
    "celerite2": lambda: quasisep.Celerite(a=1.0, b=0.1, c=0.5, d=1.0)
    + quasisep.Celerite(a=0.5, b=0.05, c=1.5, d=3.0),
}


def posterior_outputs(name, device, n=500):
    from tinygp_tpu_torch.solvers.quasisep import cuda_scan

    rng = np.random.default_rng(4)
    X = np.sort(rng.uniform(0, 10, n))
    y = torch.as_tensor(np.sin(2.0 * X) + 0.3 * rng.normal(size=n), device=device or "cuda")
    gp = GaussianProcess(HIGH_ORDER_MODELS[name](), torch.as_tensor(X), diag=0.1,
                         assume_sorted=True, device=device)
    before = dict(cuda_scan.LAUNCHES_GENERIC)
    log_prob, post = gp.condition(y)
    # The posterior process given diag=1e-3, whose covariance is well
    # conditioned (the default jitter's is not; see test_torch_orders.py).
    post = gp.condition(y, diag=1e-3)[1]
    noise = torch.as_tensor(rng.normal(size=(n, 4)), device=gp.device)
    conditioned = [log_prob, post.loc, post.variance]
    posterior = [post.log_probability(y), post.solver.dot_triangular(noise)]
    draws = post.sample(torch.Generator(device=gp.device).manual_seed(2), (4,))
    assert draws.shape == (4, n) and torch.isfinite(draws).all()
    # The same from a dense Cholesky of the posterior matrix.
    L = torch.linalg.cholesky(post.solver.matrix.to_dense())
    z = torch.linalg.solve_triangular(L, (y - post.loc)[:, None], upper=False)[:, 0]
    dense = [-0.5 * torch.sum(z * z) - torch.sum(torch.log(torch.diagonal(L)))
             - 0.5 * n * np.log(2 * np.pi), L @ noise]
    generic = {k: cuda_scan.LAUNCHES_GENERIC[k] - before[k] for k in before}
    return conditioned, posterior, dense, generic


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(HIGH_ORDER_MODELS))
def test_posterior_factor_on_the_card_matches_cpu(cuda_device, name):
    """The posterior's own factor (order 4m) and the couplings of orders
    above 4 run the generic engine on the card. Conditioning matches the
    CPU; the posterior's log probability and factor are held to a dense
    Cholesky of the same matrix no further than ten times the CPU's plain
    version (whose parallel composition of the order-4m maps loses digits
    too: about 1e-6 here), and never looser than 1e-8."""
    conditioned, posterior, dense, generic = posterior_outputs(name, None)
    torch.cuda.synchronize()
    assert generic["ric"] >= 1 and generic["aff"] >= 1
    conditioned_cpu, posterior_cpu, dense_cpu, generic_cpu = posterior_outputs(name, "cpu")
    assert not any(generic_cpu.values())
    # Per output stream, relative to its largest magnitude (PERF.md §2).
    for g, w in zip(conditioned, conditioned_cpu):
        assert g.is_cuda and torch.isfinite(g).all()
        assert stream_err(g, w) <= 1e-8
    for g, w, d in zip(posterior, posterior_cpu, dense_cpu):
        assert g.is_cuda and torch.isfinite(g).all()
        assert stream_err(g, d) <= max(1e-8, 10 * stream_err(w, d))


@pytest.mark.cuda
def test_sum_of_order_5_on_the_card_matches_cpu(cuda_device):
    """1.2 * SHO + 1.5 * Matern52 (m = 5): B1, then B1r and B2 for the
    gradient, above m = 4."""
    rng = np.random.default_rng(5)
    X = np.sort(rng.uniform(0, 10, 3000))
    y = rng.normal(size=3000)

    def value_and_grad(device):
        p = [torch.tensor(v, dtype=torch.float64, device=device, requires_grad=True)
             for v in (1.2, 1.5, 1.5, 2.5)]
        kernel = p[0] * quasisep.SHO(omega=p[1], quality=3.0) + p[2] * quasisep.Matern52(scale=p[3])
        gp = GaussianProcess(kernel, torch.as_tensor(X), diag=0.1, assume_sorted=True, device=device)
        with torch.no_grad():
            value = gp.log_probability(torch.as_tensor(y))
        lp = gp.log_probability(torch.as_tensor(y))
        return value, torch.autograd.grad(lp, p)

    before = dict(cuda_loglik.LAUNCHES_GENERIC)
    value, grads = value_and_grad(None)
    torch.cuda.synchronize()
    assert {k: cuda_loglik.LAUNCHES_GENERIC[k] - before[k] for k in before} == {
        "b1": 1, "b1r": 1, "b2": 1}
    want_value, want_grads = value_and_grad("cpu")
    np.testing.assert_allclose(value.item(), want_value.item(), rtol=1e-9)
    for g, w in zip(grads, want_grads):
        np.testing.assert_allclose(g.item(), w.item(), rtol=1e-8)


# ---------------------------------------------------------------------------
# Kernels B4, B5 and B6 (the blocked dense Cholesky's products) and the
# dense path on the card.
# ---------------------------------------------------------------------------

# (m, tile, b, offset, rows): ragged against the kernels' 128 x 128 tiles,
# B4's 8-deep steps and B5's and B6's 64-wide k-chunks (b = 20, 16, 520;
# rows 60, 48 and 1060, no multiple of 64), offsets, a main-path panel
# width, and caller tiles below the kernels' 128 (B6's lower_only zeros).
DENSE_SHAPES = [
    (100, 20, 20, 20, 60),
    (96, 16, 16, 32, 48),
    (1280, 256, 512, 256, 768),
    (1100, 20, 520, 20, 1060),
]


def dense_err(got, want):
    """Largest error relative to the float64 reference's largest magnitude."""
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", DENSE_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_dense_kernels_match_plain(cuda_device, shape):
    from tinygp_tpu_torch.ops import cuda_dense

    m, tile, b, off, rows = shape
    rng = np.random.default_rng(m + b)

    def card(*size):
        return torch.as_tensor(rng.normal(size=size), dtype=torch.float32, device=cuda_device)

    S = card(m, m)
    T, A, W, L, Lf, ak = S + S.T, card(m, m), card(b, b), card(m - off, b), card(m, b), card(b)
    before = dict(cuda_dense.LAUNCHES)
    before_split, before_f64 = cuda_dense.LAUNCHES_SPLIT, cuda_dense.LAUNCHES_F64

    # B5 at an offset, and reading the whole operand.
    c0 = b if m >= 2 * b else 0
    got = cuda_dense.split_panel_matmul(A, W, tile=tile, at=(off, c0), rows=rows)
    want = cuda_dense.plain_panel_matmul(A.double(), W.double(), off, c0, rows)
    assert got.shape == (rows, b) and dense_err(got, want) <= 1e-5
    got = cuda_dense.split_panel_matmul(A[:, :b].contiguous(), W, tile=tile, terms=2)
    assert dense_err(got, A[:, :b].double() @ W.double()) <= 1e-5

    # B4 without and with the row side products: the leading rows and
    # columns and the strictly upper 128 x 128 tiles untouched, the
    # trailing lower triangle T - L L^T, the side products bit for bit
    # plain_row_sums (the split pass's order).
    lower = torch.tril(torch.ones(m - off, m - off, dtype=torch.bool, device=cuda_device))
    blocks = torch.arange(m - off, device=cuda_device) // cuda_dense.KERNEL_TILE
    upper = blocks[None, :] > blocks[:, None]
    want = cuda_dense.plain_syrk_sub_inplace(T.double().clone(), L.double(), off)
    for ak_ in (None, ak):
        Tc = T.clone()
        out = cuda_dense.syrk_sub_inplace(Tc, L, offset=off, tile=tile, ak=ak_)
        if ak_ is not None:
            out, rowsq, rsu = out
            assert dense_err(rowsq, (L.double() ** 2).sum(1)) <= 1e-5
            assert dense_err(rsu, L.double() @ ak.double()) <= 1e-5
            sq, su = cuda_dense.plain_row_sums(L, ak)
            assert torch.equal(rowsq, sq) and torch.equal(rsu, su)
        assert out is Tc
        assert torch.equal(Tc[:off], T[:off]) and torch.equal(Tc[:, :off], T[:, :off])
        assert torch.equal(Tc[off:, off:][upper], T[off:, off:][upper])
        assert dense_err(Tc[off:, off:][lower], want[off:, off:][lower]) <= 1e-5

    # B6 with and without the zero tiles.
    for lower_only in (False, True):
        got = cuda_dense.syrk_sub(T, Lf, tile=tile, lower_only=lower_only)
        want = cuda_dense.plain_syrk_sub(T.double(), Lf.double(), tile, lower_only)
        assert dense_err(got, want) <= 1e-5 and torch.equal(got == 0, want == 0)
    torch.cuda.synchronize()
    launched = {k: cuda_dense.LAUNCHES[k] - before[k] for k in before}
    assert launched == {"panel": 2, "syrk_inplace": 1, "syrk_inplace_extras": 1, "syrk": 2}
    # A split pass for B5 at 2 terms, each B4 and each B6; the first B5
    # (3 terms by default) sums in float64.
    assert cuda_dense.LAUNCHES_SPLIT - before_split == 5
    assert cuda_dense.LAUNCHES_F64 - before_f64 == 1


@pytest.mark.cuda
@pytest.mark.parametrize("tile,offsets", [(512, range(512, 4608, 512)), (32, (160, 4000))],
                         ids=["every_trailing_size", "ragged_tile32"])
def test_dense_b4_tensor_cores_at_every_trailing_size(cuda_device, tile, offsets):
    """B4 on the tensor cores at m = 4608, b = 512: every trailing size a
    factorization at block 512 gives it (512 to 4096), and at a caller tile
    of 32 trailing sizes that are no multiple of 128 (4448, 608). The lower
    triangle within 1e-5 of float64 and 1e-6 of ``plain_split_dots`` (the
    3-term products, summed in float64), T outside the trailing lower
    128 x 128 tiles unchanged bit for bit, the side products within 1e-5
    of float64 and bit for bit ``plain_row_sums``, one launch and one
    split pass each."""
    from tinygp_tpu_torch.ops import cuda_dense

    m, b = 4608, 512
    rng = np.random.default_rng(tile)

    def card(*size, scale=1.0):
        return torch.as_tensor(rng.normal(size=size) * scale, dtype=torch.float32,
                               device=cuda_device)

    S = card(m, m)
    T, ak = (S + S.T) * 2**-0.5, card(b)
    for off in offsets:
        t = m - off
        L = card(t, b, scale=b**-0.5)
        L64 = L.double()
        lower = torch.tril(torch.ones(t, t, dtype=torch.bool, device=cuda_device))
        blocks = torch.arange(t, device=cuda_device) // cuda_dense.KERNEL_TILE
        upper = blocks[None, :] > blocks[:, None]
        want = (T[off:, off:].double() - L64 @ L64.T)[lower]
        dots = (T[off:, off:].double() - cuda_dense.plain_split_dots(L, L, 3, nt=True))[lower]
        for ak_ in (None, ak):
            Tc = T.clone()
            before = dict(cuda_dense.LAUNCHES), cuda_dense.LAUNCHES_SPLIT
            out = cuda_dense.syrk_sub_inplace(Tc, L, offset=off, tile=tile, ak=ak_)
            torch.cuda.synchronize()
            name = "syrk_inplace" if ak_ is None else "syrk_inplace_extras"
            assert cuda_dense.LAUNCHES[name] == before[0][name] + 1
            assert cuda_dense.LAUNCHES_SPLIT == before[1] + 1
            if ak_ is not None:
                out, rowsq, rsu = out
                assert dense_err(rowsq, (L64**2).sum(1)) <= 1e-5
                assert dense_err(rsu, L64 @ ak.double()) <= 1e-5
                sq, su = cuda_dense.plain_row_sums(L, ak)
                assert torch.equal(rowsq, sq) and torch.equal(rsu, su)
            assert out is Tc
            assert torch.equal(Tc[:off], T[:off]) and torch.equal(Tc[:, :off], T[:, :off])
            assert torch.equal(Tc[off:, off:][upper], T[off:, off:][upper])
            got = Tc[off:, off:][lower]
            assert dense_err(got, want) <= 1e-5 and dense_err(got, dots) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("terms", [2, 3])
@pytest.mark.parametrize("rows,b", [(300, 20), (1100, 520)])
def test_dense_split_and_tensor_core_sums_on_the_card(cuda_device, rows, b, terms):
    """B5's and B6's split pass equals ``split_pieces`` bit for bit (with
    values just above the smallest normal, whose residuals flush); the
    tensor-core kernels (B6, and B5 at 2 terms), which compute the 3-term
    products for either order, are within 1e-6 of ``plain_split_dots`` at
    3 terms on the same pieces, so only the accumulation rounds (operands
    scaled as the factorization's, rows of L of about unit norm); B5 at
    3 terms (float64 sums) within 1e-6 of the float64 product; B5 reads a
    transposed W through its strides; B6's lower_only at a caller tile of
    64, below the kernel's."""
    from tinygp_tpu_torch.ops import cuda_dense

    rng = np.random.default_rng(rows + b + terms)

    def card(*size):
        return torch.as_tensor(rng.normal(size=size), dtype=torch.float32, device=cuda_device)

    A, Wt, L = card(rows, b), card(b, b) * b**-0.5, card(rows, b) * b**-0.5
    tiny = torch.finfo(torch.float32).tiny
    A[0] = tiny * (1 + torch.rand(b, device=cuda_device) * 2**-5)
    S = card(rows, rows)
    T = S + S.T
    before = dict(cuda_dense.LAUNCHES)

    # B4 at either order: the tensor cores' 3-term products.
    Tc = T.clone()
    cuda_dense.syrk_sub_inplace(Tc, L, offset=0, tile=20, terms=terms)
    want = T.double().cpu() - cuda_dense.plain_split_dots(L.cpu(), L.cpu(), 3, nt=True)
    lower = torch.tril(torch.ones(rows, rows, dtype=torch.bool))
    assert dense_err(Tc.cpu()[lower], want[lower]) <= 1e-6

    pieces = cuda_dense.split_pass(A)
    torch.cuda.synchronize()
    want = cuda_dense.split_pass(A.cpu())
    assert torch.equal(pieces.cpu().view(torch.int16), want.view(torch.int16))

    # B5 at 2 terms runs the tensor cores; at 3 it sums the float32
    # products in float64.
    W = Wt.T
    got = cuda_dense.split_panel_matmul(A, W, tile=20, terms=terms)
    if terms == 2:
        want = cuda_dense.plain_split_dots(A.cpu(), W.cpu(), 3)
    else:
        want = A.double().cpu() @ W.double().cpu()
    assert dense_err(got.cpu(), want) <= 1e-6
    got = cuda_dense.syrk_sub(T, L, tile=20, terms=terms)
    want = T.double().cpu() - cuda_dense.plain_split_dots(L.cpu(), L.cpu(), 3, nt=True)
    assert dense_err(got.cpu(), want) <= 1e-6
    m = rows // 64 * 64  # T read through its row stride
    got = cuda_dense.syrk_sub(T[:m, :m], L[:m], tile=64, terms=terms, lower_only=True)
    want = cuda_dense.plain_syrk_by_tiles(T[:m, :m].double().cpu(), L[:m].double().cpu(), 64,
                                          lower_only=True)
    assert dense_err(got.cpu(), want) <= 1e-5 and torch.equal(got.cpu() == 0, want == 0)
    torch.cuda.synchronize()
    launched = {k: cuda_dense.LAUNCHES[k] - before[k] for k in before}
    assert launched == {"panel": 1, "syrk_inplace": 1, "syrk_inplace_extras": 0, "syrk": 2}


@pytest.mark.cuda
def test_dense_kernels_refuse_what_they_cannot_do(cuda_device):
    """A CUDA tensor of a type the kernels do not take raises; it never
    runs the plain version."""
    from tinygp_tpu_torch.ops import cuda_dense

    T = torch.zeros(64, 64, dtype=torch.float64, device=cuda_device)
    L = torch.zeros(64, 16, dtype=torch.float64, device=cuda_device)
    before = dict(cuda_dense.LAUNCHES)
    with pytest.raises(ValueError, match="float32"):
        cuda_dense.syrk_sub(T, L, tile=16)
    with pytest.raises(ValueError, match="float32"):
        cuda_dense.syrk_sub_inplace(T, L[16:], offset=16, tile=16)
    with pytest.raises(ValueError, match="float32"):
        cuda_dense.split_panel_matmul(T, L[:16], tile=16, at=(16, 16), rows=48)
    with pytest.raises(ValueError, match="one device"):
        cuda_dense.syrk_sub(T.float(), L.float().cpu(), tile=16)
    with pytest.raises(NotImplementedError, match="backward"):
        cuda_dense.syrk_sub(T.float().requires_grad_(), L.float(), tile=16)
    assert cuda_dense.LAUNCHES == before


@pytest.mark.cuda
def test_dense_gp_on_the_card_matches_cpu(cuda_device):
    """The dense path at N = 4500 in float32 (blocked: B5 and B4 eight times
    each) against float64 on the CPU."""
    from tinygp_tpu_torch import kernels
    from tinygp_tpu_torch.ops import cuda_dense, dense

    rng = np.random.default_rng(12)
    n = 4500
    X = np.sort(rng.uniform(0, 10, n))
    y = rng.normal(size=n)
    X_test = np.linspace(0, 10, 100)

    def run(device, dtype):
        amp, scale = (torch.tensor(v, dtype=dtype, device=device or cuda_device, requires_grad=True)
                      for v in (1.5, 2.5))
        gp = GaussianProcess(amp * kernels.Matern32(scale=scale), torch.as_tensor(X, dtype=dtype),
                             diag=0.1, device=device)
        lp = gp.log_probability(y)
        grads = torch.autograd.grad(lp, [amp, scale])
        with torch.no_grad():
            mu, var = gp.predict(y, X_test, return_var=True)
        return [lp.detach(), *grads, mu, var]

    before = dict(cuda_dense.LAUNCHES)
    before_split = cuda_dense.LAUNCHES_SPLIT
    refactors = dense.NATIVE_REFACTORS
    on_card = run(None, torch.float32)
    torch.cuda.synchronize()
    launched = {k: cuda_dense.LAUNCHES[k] - before[k] for k in before}
    # log_probability (fused: B5 and B4 with extras) and the factor for
    # predict (B5 and B4 without); the posterior downdate is a plain product.
    assert launched == {"panel": 16, "syrk_inplace": 8, "syrk_inplace_extras": 8, "syrk": 0}
    # Well conditioned: 2 terms, a split pass before each B5 and each B4.
    assert cuda_dense.LAUNCHES_SPLIT - before_split == 32
    assert dense.NATIVE_REFACTORS == refactors
    want = run("cpu", torch.float64)
    lp, ga, gs, mu, var = (x.double().cpu() for x in on_card)
    assert all(torch.isfinite(x).all() for x in (lp, ga, gs, mu, var))
    np.testing.assert_allclose(float(lp), float(want[0]), rtol=5e-4)
    for g, w in zip((ga, gs), want[1:3]):
        assert abs(float(g) - float(w)) < 2e-3 * abs(float(w)) + 1e-3
    assert float((mu - want[3]).abs().max()) <= 5e-3 * float(want[3].abs().max())
    assert float((var - want[4]).abs().max()) <= 1e-3 * 1.6


@pytest.mark.cuda
def test_quasisep_variance_at_new_points_on_the_card(cuda_device):
    """The O(N) process's dense posterior at new points: B3 whitens the
    cross-covariance (one column per point); the downdate is a plain
    product, so no dense kernel runs."""
    from tinygp_tpu_torch.ops import cuda_dense

    rng = np.random.default_rng(4)
    X = np.sort(rng.uniform(0, 10, 3000))
    y = rng.normal(size=3000)
    X_test = np.linspace(-0.5, 10.5, 200)

    def run(device, dtype):
        gp = GaussianProcess(1.5 * quasisep.Matern32(scale=2.5), torch.as_tensor(X, dtype=dtype),
                             diag=0.1, assume_sorted=True, device=device)
        return gp.predict(y, X_test, return_var=True)

    want = run("cpu", torch.float64)
    got = run(None, torch.float64)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=1e-9, atol=1e-12)
    before = dict(cuda_dense.LAUNCHES)
    mu, var = run(None, torch.float32)
    torch.cuda.synchronize()
    assert cuda_dense.LAUNCHES == before
    assert torch.isfinite(mu).all() and torch.isfinite(var).all()
    assert float((mu.double().cpu() - want[0]).abs().max()) <= 5e-3 * float(want[0].abs().max())
    assert float((var.double().cpu() - want[1]).abs().max()) <= 1e-3 * 1.5


def gram_kernels(d):
    """Kernel B7's set: every leaf with either metric, a tree of sums and
    products and, on points of 3 features, each root transform."""
    from tinygp_tpu_torch import kernels, transforms

    extra = {"ExpSineSquared": dict(gamma=0.9), "RationalQuadratic": dict(alpha=1.1)}
    out = {
        f"{name}-{metric}": getattr(kernels, name)(
            scale=1.7, distance=getattr(kernels, metric)(), **extra.get(name, {})
        )
        for name in ("Exp", "ExpSquared", "Matern32", "Matern52", "Cosine", "ExpSineSquared",
                     "RationalQuadratic")
        for metric in ("L1Distance", "L2Distance")
    }
    out["tree"] = (1.3 * kernels.Matern32(scale=1.7) + kernels.Exp(scale=0.9)) * (
        kernels.ExpSquared(scale=1.1) + 0.5 * kernels.Cosine(scale=2.0)
    )
    if d == 3:
        out["linear"] = transforms.Linear(torch.tensor([2.0, 0.5, 1.3]), kernels.ExpSquared())
        out["cholesky"] = transforms.Cholesky.from_parameters(
            torch.tensor([1.5, 0.7, 2.0]), torch.tensor([0.3, -0.2, 0.4]), kernels.Matern52()
        )
        out["subspace"] = transforms.Subspace(np.array([0, 2]), kernels.Matern32(scale=0.8))
    return out


def gram_f64(kernel, X1, X2):
    """The kernel's matrix in float64 on the float32 values B7 reads: the
    float32 inputs and the hyperparameters rounded to float32."""
    params = {n: b.float().double() for n, b in kernel.named_buffers()}
    return torch.func.functional_call(kernel, params, (X1.double(), X2.double()))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 3], ids=["N", "Nx3"])
def test_gram_kernel_matches_plain(cuda_device, d):
    """B7 on ragged shapes no further from float64 than twice the float32
    plain version plus 1e-6 of the largest entry, and the diagonal exactly
    the plain version's."""
    from tinygp_tpu_torch.ops import gram

    rng = np.random.default_rng(21 + d)
    shape = () if d == 1 else (d,)
    X1, X2 = (torch.as_tensor(rng.uniform(0, 10, (n, *shape)), dtype=torch.float32,
                              device=cuda_device) for n in (1037, 515))
    kernels = gram_kernels(d)
    before = gram.LAUNCHES["gram"]
    for name, kernel in kernels.items():
        kernel = kernel.to(cuda_device)
        got = gram.gram_tiled(kernel, X1, X2)
        want = gram_f64(kernel, X1, X2)
        err = float((got.double() - want).abs().max())
        plain = float((gram.plain_gram(kernel, X1, X2).double() - want).abs().max())
        assert got.shape == (1037, 515) and torch.isfinite(got).all(), name
        assert err <= 2 * plain + 1e-6 * float(want.abs().max()), (name, err, plain)
        diag = gram.gram_tiled(kernel, X1, X1).diagonal()
        assert torch.equal(diag, gram.plain_gram(kernel, X1, X1).diagonal()), name
    torch.cuda.synchronize()
    assert gram.LAUNCHES["gram"] == before + 2 * len(kernels)


@pytest.mark.cuda
def test_gram_gradient_on_the_card_matches_cpu(cuda_device):
    """d/d(amp, scale, X1) of sum(sin(K) w) through B7 against float64
    autograd on the CPU, rtol 1e-4 per parameter."""
    from tinygp_tpu_torch import kernels
    from tinygp_tpu_torch.ops import gram

    rng = np.random.default_rng(31)
    X = rng.uniform(0, 5, 300)

    def grads(device, dtype, build):
        amp, scale = (torch.tensor(v, dtype=dtype, device=device, requires_grad=True)
                      for v in (1.5, 1.4))
        x = torch.as_tensor(X, dtype=dtype, device=device).requires_grad_(True)
        K = build(kernels.Constant(amp) * kernels.Matern32(scale=scale), x, x.detach())
        w = torch.arange(300, dtype=dtype, device=device)
        return torch.autograd.grad((torch.sin(K) * w).sum(), (amp, scale, x))

    before = gram.LAUNCHES["gram"]
    got = grads(cuda_device, torch.float32, gram.gram_tiled)
    torch.cuda.synchronize()
    assert gram.LAUNCHES["gram"] == before + 1
    want = grads("cpu", torch.float64, lambda k, a, b: k(a, b))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert float((g.cpu().double() - w).abs().max()) <= 1e-4 * float(w.abs().max())


@pytest.mark.cuda
def test_gram_kernel_refuses_what_it_cannot_do(cuda_device):
    """On the card the gate's refusals raise; nothing runs the plain version."""
    from tinygp_tpu_torch import kernels
    from tinygp_tpu_torch.ops import gram

    X = torch.linspace(0, 1, 50, device=cuda_device)
    before = gram.LAUNCHES["gram"]
    with pytest.raises(ValueError, match="float32"):
        gram.gram_tiled(kernels.Matern32(), X.double(), X.double())
    with pytest.raises(ValueError, match="DotProduct"):
        gram.gram_tiled(kernels.DotProduct(), X, X)
    with pytest.raises(ValueError, match="two devices"):
        gram.gram_tiled(kernels.Matern32(), X, X.cpu())
    assert gram.LAUNCHES["gram"] == before
    assert gram.gram_tiled(kernels.Matern32(), X[:0], X).shape == (0, 50)


# ---------------------------------------------------------------------------
# B5's 3-term order on the float64 tensor cores, and the generic-order
# B1/B1r and B3 Riccati flow through the rank-one chunk fold.
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_panel_f64_on_the_card_at_every_panel_size(cuda_device):
    """B5 at 3 terms at each of the 19 panel shapes of N = 1e4 at block 512
    (W passed as the transposed view the factorization gives it, and
    contiguous: the 16-byte loads along either axis of W), on
    ragged shapes (row counts, panel widths and offsets that leave the
    16-byte loads for the 4-byte ones), within 1e-5 of float64 and within
    a float32 rounding of the plain version in the kernel's order; a
    repeated launch is bit-identical (the split contractions' partial sums
    are added in a fixed order)."""
    import ctypes

    from tinygp_tpu_torch import cuda_build
    from tinygp_tpu_torch.ops import cuda_dense

    order = cuda_build.library("dense_syrk").dsk_panel_f64_order
    order.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 3
    order.restype = None

    def check(A, W, at, rows, tile):
        got = cuda_dense.split_panel_matmul(A, W, tile=tile, terms=3, at=at, rows=rows)
        b = W.shape[0]
        want = A[at[0] : at[0] + rows, at[1] : at[1] + b].double() @ W.double()
        assert dense_err(got, want) <= 1e-5
        plain = cuda_dense.plain_panel_matmul_f64(A, W, *at, rows)
        assert float((got.double() - plain.double()).abs().max()) <= 2.0**-23 * float(
            plain.abs().max())
        again = cuda_dense.split_panel_matmul(A, W, tile=tile, terms=3, at=at, rows=rows)
        assert torch.equal(got, again)
        splits, k_step, mma_k = (ctypes.c_int() for _ in range(3))
        order(rows, b, splits, k_step, mma_k)
        assert splits.value == cuda_dense.panel_splits(rows, b)
        assert (k_step.value, mma_k.value) == (32, 8)

    gen = torch.Generator(device=cuda_device).manual_seed(9)
    m, b = 10240, 512
    A = torch.randn(m, m, generator=gen, device=cuda_device)
    Wt = (torch.randn(b, b, generator=gen, device=cuda_device) * b**-0.5).T
    before = cuda_dense.LAUNCHES_F64
    for j in range(1, m // b):
        t = j * b
        check(A, Wt, (m - t, m - t - b), t, 256)
        check(A, Wt.T, (m - t, m - t - b), t, 256)
    assert cuda_dense.LAUNCHES_F64 - before == 4 * 19
    for m2, b2, at, rows, tile in ((1100, 40, (8, 40), 1000, 8), (300, 37, (16, 37), 232, 8),
                                   (2000, 512, (32, 512), 1920, 32)):
        A2 = torch.randn(m2, m2, generator=gen, device=cuda_device)
        W2 = torch.randn(b2, b2, generator=gen, device=cuda_device) / b2**0.5
        check(A2, W2, at, rows, tile)
        check(A2, W2.T, at, rows, tile)


GENERIC_RIC_ORDERS = [5, 8, 16, 32]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("m", GENERIC_RIC_ORDERS)
def test_generic_riccati_fold_on_the_card(cuda_device, m, dtype):
    """The generic-order B1, B1r and B3 Riccati flow, whose chunk pass folds
    each element with the rank-one step, against their plain versions in
    float64 (rtol 1e-8 in float64, 5e-4 in float32, per output relative to
    its largest magnitude); every launch repeated is bit-identical."""
    from tinygp_tpu_torch.solvers.quasisep import cuda_scan, scan

    rtol = 1e-8 if dtype == torch.float64 else 5e-4
    for n in (N, 33):
        args = operands(m, n, dtype, cuda_device, seed=m + n)
        want = cuda_loglik.plain_loglik_terms_res(*(x.double() for x in args))
        value = cuda_loglik.fused_loglik_terms(*args)
        res = cuda_loglik.fused_loglik_res(*args)
        flow = cuda_scan.riccati(*args[:4])
        for got, ref in ((value, want[:2]), (res, want), ((flow,), want[2:3])):
            for g, w in zip(got, ref):
                g, w = g.double(), w.double()
                assert torch.isfinite(g).all()
                assert float((g - w).abs().max()) <= rtol * float(w.abs().max())
        assert all(torch.equal(a, b) for a, b in zip(value, cuda_loglik.fused_loglik_terms(*args)))
        assert all(torch.equal(a, b) for a, b in zip(res, cuda_loglik.fused_loglik_res(*args)))
        assert torch.equal(flow, cuda_scan.riccati(*args[:4]))
        # The engine's flow against the sequential recurrence's in float64.
        if n == 33:
            seq = scan.riccati_scan(*(x.double() for x in (
                args[0], args[1].T, args[2].T, args[3].T.reshape(n, m, m))), parallel=False)
            got = flow.double().T.reshape(n, m, m)
            assert float((got - seq).abs().max()) <= rtol * float(seq.abs().max())


# ---------------------------------------------------------------------------
# Kernel B2 in one launch: tiles by a ticket and a deterministic look-back.
# ---------------------------------------------------------------------------

B2_ORDERS = [1, 2, 3, 4, 5, 6, 7, 8]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("m", B2_ORDERS)
def test_b2_one_launch_matches_plain_and_repeats(cuda_device, m, dtype):
    """B2 at N of one tile, a ragged many-tile N and 1e6, against its plain
    version (rtol 1e-8 in float64; 5e-4 against float64 in float32, per
    output relative to its largest magnitude); a second launch on the same
    inputs gives the same bits; one launch counted per call; the library's
    schedule is the plain tiled version's."""
    import ctypes

    tile, sub = cuda_loglik.b2_schedule(m, dtype)
    lib = cuda_loglik._bwd_library() if m <= 4 else cuda_loglik._generic_library()
    t, s = ctypes.c_int(), ctypes.c_int()
    nbytes = torch.empty((), dtype=dtype).element_size()
    assert lib.qsl_bwd_schedule(m, nbytes, ctypes.byref(t), ctypes.byref(s)) == 0
    assert (t.value, s.value) == (tile, sub)
    rtol = 1e-8 if dtype == torch.float64 else 5e-4
    for n in (tile, N, 1_000_000):
        args = operands(m, n, dtype, cuda_device, seed=m + n)
        res = cuda_loglik.fused_loglik_res(*args)
        qbar, lbar = (torch.tensor(v, dtype=dtype, device=cuda_device) for v in (0.8, -1.1))
        bwd_args = (*args[1:], *res[2:], qbar, lbar)
        before = cuda_loglik.LAUNCHES_BWD
        got = cuda_loglik.fused_loglik_bwd(*bwd_args)
        again = cuda_loglik.fused_loglik_bwd(*bwd_args)
        torch.cuda.synchronize()
        assert cuda_loglik.LAUNCHES_BWD == before + 2
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        want = cuda_loglik.plain_loglik_bwd(*(x.double() for x in bwd_args))
        for g, w in zip(got, want):
            assert g.dtype == dtype and torch.isfinite(g).all()
            assert stream_err(g, w) <= rtol, (n, stream_err(g, w))
        del args, res, bwd_args, got, again, want
