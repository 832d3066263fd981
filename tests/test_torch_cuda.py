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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("m", [1, 2, 3, 4])
def test_kernel_matches_plain(cuda_device, m, dtype):
    args = operands(m, N, dtype, cuda_device, seed=m)
    before = cuda_loglik.LAUNCHES
    got = cuda_loglik.fused_loglik_terms(*args)
    torch.cuda.synchronize()
    assert cuda_loglik.LAUNCHES == before + 1
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
    with pytest.raises(NotImplementedError, match="m > 4"):
        cuda_loglik.fused_loglik_terms(*operands(5, 300, torch.float64, cuda_device))
    args = operands(2, 300, torch.float64, cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_loglik.fused_loglik_terms(args[0], args[1], args[2], args[3].t().contiguous().t(), args[4])


def stream_err(got, want):
    """Largest error relative to the stream's largest magnitude."""
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-300))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("m", [1, 2, 3, 4])
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
