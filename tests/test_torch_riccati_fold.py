"""The rank-one Riccati fold and the plain versions of the generic-order
B1/B1r and of B5's 3-term order, against the JAX package.

- ``scan.riccati_fold_rank_one`` (the plain version of the one-launch
  kernels' team fold, ``csrc/quasisep_tc.cuh``: ``RicOp``) over chunks of
  1-64 elements at m = 5, 8, 16 and 32 on positive definite operands,
  against the port's full Möbius merge (``scan._riccati_combine``) applied
  one element at a time, against the merge of separately folded chunks
  (the kernels' in-tile scan and look-back), and its running states
  against the JAX package's ``riccati_scan``;
- the wrappers of B1 and B1r at m = 5 and 8 on CPU tensors (their plain
  versions) against the JAX package's ``stacked_loglik_terms``;
- ``cuda_dense.plain_panel_matmul_f64``, the 3-term panel product summed in
  float64 in the kernel's order, against
  ``pallas_dense.split_panel_matmul(terms=3)`` in interpret mode on ragged
  row counts and ``at=`` offsets.

The card's kernels are held to the same plain versions in
``test_torch_cuda.py`` and ``chip_smoke.py``. Tolerances: the table's
5e-7 for float64 (``test_utils``); the fold against the merge, both in
float64 on the same operands, 1e-12 of each output's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinygp_tpu.ops import pallas_dense
from tinygp_tpu.solvers.quasisep import ops as jops
from tinygp_tpu.solvers.quasisep import scan as jscan
from tinygp_tpu_torch.ops import cuda_dense
from tinygp_tpu_torch.solvers.quasisep import cuda_loglik, scan
from tinygp_tpu_torch.test_utils import assert_allclose, random_qsm_operands


def operands(m, n, seed):
    return [torch.as_tensor(x) for x in random_qsm_operands(m, n, seed)]


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def identity(m):
    zeros = torch.zeros(m * m, 1, dtype=torch.float64)
    return torch.eye(m, dtype=torch.float64).reshape(m * m, 1), zeros, zeros


def merged(m, d, ps, qs, as_, init=None):
    """The chunk's elements merged one at a time after ``init`` with the
    full Möbius merge."""
    combine = scan._riccati_combine(m)
    value = identity(m) if init is None else init
    elements = scan._riccati_elements(d, ps, qs, as_)
    for k in range(d.shape[-1]):
        value = combine(value, tuple(x[:, k : k + 1] for x in elements))
    return value


@pytest.mark.parametrize("m", [5, 8, 16, 32])
@pytest.mark.parametrize("length", [1, 2, 7, 64])
def test_rank_one_fold_matches_the_full_merge(m, length):
    d, ps, qs, as_, _ = operands(m, length, seed=m + length)
    got = scan.riccati_fold_rank_one(d, ps, qs, as_, m)
    want = merged(m, d, ps, qs, as_)
    for g, w in zip(got, want):
        assert g.shape == (m * m, 1) and torch.isfinite(g).all()
        assert rel(g, w) <= 1e-12
    # Folded into a running value rather than the identity: the chunk after
    # a first one, as the finish pass's prefix carries it.
    first = merged(m, *(x[..., :3] for x in operands(m, 3, seed=m)[:4]))
    got = scan.riccati_fold_rank_one(d, ps, qs, as_, m, init=first)
    for g, w in zip(got, merged(m, d, ps, qs, as_, init=first)):
        assert rel(g, w) <= 1e-12


@pytest.mark.parametrize("m", [5, 8, 16, 32])
def test_folded_chunks_merge_to_the_scan(m):
    """Chunks folded on their own and merged with the full merge (the
    kernels' team folds and their merges) give the flow's state at each chunk
    boundary: the JAX package's riccati_scan there, to 5e-7."""
    n, chunks = 64, (1, 2, 5, 8, 16, 32)
    d, ps, qs, as_, _ = operands(m, n, seed=7 * m)
    want = np.asarray(jscan.riccati_scan(
        jnp.asarray(d.numpy()), jnp.asarray(ps.numpy().T), jnp.asarray(qs.numpy().T),
        jnp.asarray(as_.numpy().T.reshape(n, m, m)), parallel=False))
    combine = scan._riccati_combine(m)
    value, lo = identity(m), 0
    for size in chunks:
        hi = lo + size
        total = scan.riccati_fold_rank_one(d[lo:hi], ps[:, lo:hi], qs[:, lo:hi],
                                           as_[:, lo:hi], m)
        value = combine(value, total)
        lo = hi
        # The flow starts at 0, so the state before element hi is the leaf F.
        if hi < n:
            assert_allclose(value[1][:, 0].reshape(m, m), want[hi])
    assert lo == sum(chunks)


@pytest.mark.parametrize("m", [5, 8, 16, 32])
def test_fold_states_match_jax_riccati_scan(m):
    """Folding one element at a time, the running F is the exclusive
    Riccati state of the next element: the JAX package's riccati_scan."""
    n = 48
    d, ps, qs, as_, _ = operands(m, n, seed=11 * m)
    want = np.asarray(jscan.riccati_scan(
        jnp.asarray(d.numpy()), jnp.asarray(ps.numpy().T), jnp.asarray(qs.numpy().T),
        jnp.asarray(as_.numpy().T.reshape(n, m, m)), parallel=False))
    value = None
    for k in range(n):
        got = np.zeros((m, m)) if value is None else value[1][:, 0].reshape(m, m).numpy()
        assert_allclose(got, want[k])
        value = scan.riccati_fold_rank_one(d[k : k + 1], ps[:, k : k + 1], qs[:, k : k + 1],
                                           as_[:, k : k + 1], m, init=value)


@pytest.mark.parametrize("m", [5, 8])
def test_generic_loglik_plain_route_matches_jax(m):
    """B1 and B1r's wrappers at the generic orders on CPU tensors (their
    plain versions) against the JAX package's stacked log-likelihood, at
    the table's 5e-7; the residuals' F against its Riccati scan."""
    n = 100
    arrays = random_qsm_operands(m, n, seed=3 * m)
    want = jax.jit(jops.stacked_loglik_terms)(*map(jnp.asarray, arrays))
    args = [torch.as_tensor(x) for x in arrays]
    value = cuda_loglik.fused_loglik_terms(*args)
    quad, logdet, Fs, e, ic = cuda_loglik.fused_loglik_res(*args)
    for g, w in zip(value, want):
        assert torch.isfinite(g)
        assert_allclose(g, w)
    assert_allclose(quad, want[0])
    assert_allclose(logdet, want[1])
    d, ps, qs, as_, _ = arrays
    F_jax = np.asarray(jscan.riccati_scan(
        jnp.asarray(d), jnp.asarray(ps.T), jnp.asarray(qs.T),
        jnp.asarray(as_.T.reshape(n, m, m)), parallel=False))
    assert_allclose(Fs.T.reshape(n, m, m), F_jax)


@pytest.mark.parametrize(
    "m,tile,b,at,rows",
    [(64, 16, 16, (16, 16), 48), (128, 32, 32, (32, 32), 64), (160, 16, 48, (48, 96), 96),
     (200, 8, 40, (40, 80), 152)],
)
def test_panel_f64_plain_matches_pallas(m, tile, b, at, rows):
    """The 3-term order's plain version in the kernel's order (float64 sums
    of the exact float32 products) against the JAX 3-term kernel in
    interpret mode (split bf16, about 2^-24 per operand) and a float64
    product, on row counts that are no multiple of the kernel's 128-row
    tile and panels read at offsets."""
    rng = np.random.default_rng(m + b)
    A = rng.normal(size=(m, m)).astype(np.float32)
    W = rng.normal(size=(b, b)).astype(np.float32)
    want = A.astype(np.float64)[at[0] : at[0] + rows, at[1] : at[1] + b] @ W.astype(np.float64)
    jax_out = pallas_dense.split_panel_matmul(
        jnp.asarray(A), jnp.asarray(W), tile=tile, terms=3, at=at, rows=rows, interpret=True)
    got = cuda_dense.plain_panel_matmul_f64(torch.as_tensor(A), torch.as_tensor(W), *at, rows)
    assert got.shape == (rows, b) and got.dtype == torch.float32
    # Float64 sums rounded once: within half an ulp of float32 of the
    # float64 product, elementwise.
    np.testing.assert_allclose(got.numpy(), want, rtol=2.0**-24, atol=2.0**-24 * np.abs(want).max())
    assert rel(jax_out, want) < 2.0**-24 * 64
    assert rel(got, jax_out) < 2.0**-24 * 65
    # W as the transposed view the factorization passes: the same values.
    Wt = torch.as_tensor(np.ascontiguousarray(W.T)).T
    assert torch.equal(cuda_dense.plain_panel_matmul_f64(torch.as_tensor(A), Wt, *at, rows), got)


@pytest.mark.parametrize("rows,b,splits", [(512, 512, 8), (1024, 512, 4), (2048, 512, 2),
                                           (4096, 512, 1), (9728, 512, 1), (100, 40, 1),
                                           (130, 256, 4)])
def test_panel_splits_follow_the_kernel_rule(rows, b, splits):
    """The contraction's split, as the kernel picks it: at most 132 blocks
    of 128 x 128 tiles, at least two steps of 32 a split."""
    assert cuda_dense.panel_splits(rows, b) == splits
    A = torch.randn(rows, b, dtype=torch.float32)
    W = torch.randn(b, b, dtype=torch.float32)
    got = cuda_dense.plain_panel_matmul_f64(A, W, 0, 0, rows)
    want = A.double() @ W.double()
    assert rel(got, want.numpy()) <= 2.0**-24
