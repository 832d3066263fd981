"""The fused log-likelihood module: the plain version against the JAX
package's oracle, and the wrapper's contract on the CPU. The CUDA kernel
is held to the plain version in ``test_torch_cuda.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinygp_tpu.solvers.quasisep import ops as jops
from tinygp_tpu.solvers.quasisep import scan as jscan
from tinygp_tpu_torch.solvers.quasisep import cuda_loglik, ops, scan
from tinygp_tpu_torch.test_utils import assert_allclose, random_qsm_operands

# Spans two blocked levels with a ragged tail; 100 takes the sequential
# branch (_SEQ_CUTOFF).
N_LONG = 2 * 8192 + 777


def operands(m, n, seed=321):
    return random_qsm_operands(m, n, seed)


def torch_ops(arrays, dtype=torch.float64, device="cpu"):
    return [torch.as_tensor(x, dtype=dtype, device=device) for x in arrays]


@pytest.mark.parametrize("n", [100, N_LONG])
@pytest.mark.parametrize("m", [1, 2, 3, 4])
def test_plain_matches_jax(m, n):
    arrays = operands(m, n, seed=m)
    want = jax.jit(jops.stacked_loglik_terms)(*map(jnp.asarray, arrays))
    got = ops.stacked_loglik_terms(*torch_ops(arrays))
    for g, w in zip(got, want):
        assert g.dtype == torch.float64 and torch.isfinite(g)
        assert_allclose(g, w)


def test_plain_float32_matches_jax():
    arrays = operands(2, N_LONG)
    want = jax.jit(jops.stacked_loglik_terms)(*map(jnp.asarray, arrays))
    got = ops.stacked_loglik_terms(*torch_ops(arrays, torch.float32))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and torch.isfinite(g)
        assert_allclose(g, w)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("exclusive", [False, True])
def test_affine_scan_matches_jax(reverse, exclusive):
    rng = np.random.default_rng(5)
    m, r, n = 2, 3, 300
    As = 0.2 * rng.normal(size=(m * m, n)) + 0.5 * np.eye(m).reshape(-1, 1)
    Bs = rng.normal(size=(m * r, n))
    kw = dict(reverse=reverse, exclusive=exclusive)
    want = jscan._affine_scan_s(jnp.asarray(As), jnp.asarray(Bs), m, r, **kw)
    got = scan._affine_scan_s(*torch_ops([As, Bs]), m, r, **kw)
    assert torch.isfinite(got).all()
    assert_allclose(got, want)


@pytest.mark.slow
def test_plain_matches_pallas_interpret(monkeypatch):
    """Against the TPU kernel itself, run in interpret mode as the JAX
    package's own test runs it (tiny tiles, two chunks and a ragged tail)."""
    from tinygp_tpu.solvers.quasisep import pallas_loglik, pallas_scan

    monkeypatch.setattr(pallas_scan, "INTERPRET", True)
    monkeypatch.setenv("TINYGP_TPU_PALLAS_LLK_BLOCK", "8")
    monkeypatch.setenv("TINYGP_TPU_PALLAS_SCAN", "0")
    arrays = operands(2, N_LONG)
    want = pallas_loglik.fused_loglik_terms(
        *(jnp.asarray(x, jnp.float32) for x in arrays)
    )
    got = ops.stacked_loglik_terms(*torch_ops(arrays, torch.float32))
    # Different association orders in float32 over O(N) totals, as the
    # JAX package's test of this kernel allows.
    for g, w in zip(got, want):
        assert np.isfinite(float(g))
        np.testing.assert_allclose(float(g), float(w), rtol=3e-4)


def test_cpu_tensors_never_launch():
    before = cuda_loglik.LAUNCHES
    ops.stacked_loglik_terms(*torch_ops(operands(2, 500)))
    assert cuda_loglik.LAUNCHES == before


def test_m5_runs_the_plain_version_on_cpu():
    """m > 4 has no kernel; on the CPU the plain version takes it through
    the general solve, and agrees with the JAX package."""
    arrays = operands(5, 100)
    want = jax.jit(jops.stacked_loglik_terms)(*map(jnp.asarray, arrays))
    got = cuda_loglik.fused_loglik_terms(*torch_ops(arrays))
    for g, w in zip(got, want):
        assert torch.isfinite(g)
        assert_allclose(g, w)
