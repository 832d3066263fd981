"""The port's plain float32 paths above PyTorch's parallel grain.

On some CPU hosts the first multithreaded float32 ``torch.exp`` of a process
returns one thread's chunk about 1.5e-4 off (plain PyTorch, no port code:
``torch.exp(torch.linspace(-30, 5, 4_000_000))`` in a fresh process with 8
threads, 9 of 40 processes on a torch 2.13.0+cpu host). Importing
``tinygp_tpu_torch`` makes one small call first, which avoids it. These
tests probe that first call in fresh processes, and hold the plain float32
log-likelihood to the JAX package at sizes whose elementwise passes run
multithreaded (PyTorch's grain is 32,768 elements).
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinygp_tpu import GaussianProcess as JaxGP
from tinygp_tpu.kernels import quasisep as jq
from tinygp_tpu_torch import GaussianProcess
from tinygp_tpu_torch.kernels import quasisep as tq
from tinygp_tpu_torch.test_utils import assert_allclose

PROBE = """
import torch, tinygp_tpu_torch
torch.set_num_threads(8)
x = torch.linspace(-30.0, 5.0, 4_000_000, dtype=torch.float32)
got = torch.exp(x)  # the first multithreaded exp after the import
want = torch.exp(x.double())
print(float(((got.double() - want).abs() / want).max()))
"""


@pytest.mark.parametrize("process", range(4))
def test_first_multithreaded_float32_exp_after_import_is_accurate(process):
    out = subprocess.run([sys.executable, "-c", PROBE], capture_output=True, text=True,
                         check=True, timeout=120)
    # float32 rounding of exp: a few ulp, 6.2e-8 on that host.
    assert float(out.stdout.strip().splitlines()[-1]) <= 1e-6


N_GRAIN = 40_000
MODELS = {
    "matern32": lambda q: 1.5 * q.Matern32(scale=2.5),
    "celerite2": lambda q: q.Celerite(a=1.0, b=0.1, c=0.5, d=1.0)
    + q.Celerite(a=0.5, b=0.05, c=1.5, d=3.0),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_plain_float32_above_the_parallel_grain_matches_jax(name):
    rng = np.random.default_rng(21)
    X = np.sort(rng.uniform(0, 10, N_GRAIN)).astype(np.float32)
    y = rng.normal(size=N_GRAIN).astype(np.float32)
    want = JaxGP(MODELS[name](jq), jnp.asarray(X), diag=0.1, assume_sorted=True,
                 parallel=False).log_probability(jnp.asarray(y))
    gp = GaussianProcess(MODELS[name](tq), torch.as_tensor(X), diag=0.1, assume_sorted=True,
                         device="cpu")
    got = gp.log_probability(torch.as_tensor(y))
    assert got.dtype == torch.float32 and torch.isfinite(got)
    assert_allclose(got, want)
