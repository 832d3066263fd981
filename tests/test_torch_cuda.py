"""The port's CUDA kernel on the card, against its plain version.

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
    args[0].requires_grad_(True)
    with pytest.raises(NotImplementedError, match="backward"):
        cuda_loglik.fused_loglik_terms(*args)
    args = operands(2, 300, torch.float64, cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_loglik.fused_loglik_terms(args[0], args[1], args[2], args[3].t().contiguous().t(), args[4])
