"""Kernel B2's association on the card, in plain PyTorch
(``cuda_loglik.plain_loglik_bwd_tiled``): mirrored tiles cut into teams,
each team's sequential folds, the in-tile scan and the tiles' aggregates
applied one at a time (above m = 8, the tensor-core kernel's look-back in
groups of 16 tiles folded in runs of 4, and its congruence adjoint scanning
Gbar + Gbar^T). Held against the JAX package's backward (the TPU
kernel in interpret mode at m = 1..3, as its own test runs it; the VJP of
``stacked_loglik_terms`` above, where the JAX package hands the order to
XLA) and against the port's plain B2 to 1e-12 of each output's largest
magnitude. The card tests hold the kernel to the plain versions
(``test_torch_cuda.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinygp_tpu.solvers.quasisep import ops as jops
from tinygp_tpu_torch.solvers.quasisep import cuda_loglik
from tinygp_tpu_torch.test_utils import assert_allclose, random_qsm_operands

N_LONG = 2 * 8192 + 777


@jax.jit
def _jax_vjp(d, ps, qs, as_, y, qbar, lbar):
    return jax.vjp(jops.stacked_loglik_terms, d, ps, qs, as_, y)[1]((qbar, lbar))


@jax.jit
def _jax_vjp_sequential(d, ps, qs, as_, y, qbar, lbar):
    """The VJP of the JAX package's factor-then-whiten pair with sequential
    scans (``symm_cholesky``, ``lower_triangular_solve``, the terms
    ``stacked_loglik_terms`` fuses), which compiles in seconds where the
    stacked form's VJP takes minutes above m = 8."""

    def terms(d, ps, qs, as_, y):
        n, m = d.shape[0], ps.shape[0]
        p, q, a = ps.T, qs.T, as_.T.reshape(n, m, m)
        c, w = jops.symm_cholesky(d, p, q, a, parallel=False)
        alpha = jops.lower_triangular_solve(c, p, w, a, y[:, None], parallel=False)
        return jnp.sum(alpha * alpha), jnp.sum(jnp.log(c))

    return jax.vjp(terms, d, ps, qs, as_, y)[1]((qbar, lbar))


def residuals(m, n, seed, dtype=torch.float64):
    """The operands, B1r's residuals (plain) and two cotangents."""
    arrays = random_qsm_operands(m, n, seed)
    d, ps, qs, as_, y = (torch.tensor(x, dtype=dtype) for x in arrays)
    _, _, Fs, e, ic = cuda_loglik.plain_loglik_terms_res(d, ps, qs, as_, y)
    qbar, lbar = (torch.tensor(v, dtype=dtype)
                  for v in np.random.default_rng(seed).normal(size=2))
    return arrays, (ps, qs, as_, y, Fs, e, ic, qbar, lbar)


def tiled(res, m, dtype=torch.float64):
    return cuda_loglik.plain_loglik_bwd_tiled(*res, *cuda_loglik.b2_schedule(m, dtype))


def assert_matches_plain(got, res):
    """Each output within 1e-12 of its largest magnitude of plain B2's."""
    for g, w in zip(got, cuda_loglik.plain_loglik_bwd(*res)):
        assert g.shape == w.shape and g.dtype == w.dtype and torch.isfinite(g).all()
        assert float((g - w).abs().max()) <= 1e-12 * float(w.abs().max())


def assert_matches_jax(got, arrays, res, vjp=_jax_vjp):
    want = vjp(*map(jnp.asarray, arrays), *(jnp.asarray(float(x)) for x in res[-2:]))
    for g, w in zip(got, want):
        assert_allclose(g, w)


@pytest.mark.parametrize("m", [1, 2, 3])
def test_tiled_matches_pallas_interpret(monkeypatch, m):
    """Against the TPU backward kernel in interpret mode (tiny tiles, a
    ragged tail), on the same float32 residuals: two association orders of
    float32 scans, so each stream within 5e-4 of its largest magnitude."""
    from tinygp_tpu.solvers.quasisep import pallas_loglik, pallas_scan

    monkeypatch.setattr(pallas_scan, "INTERPRET", True)
    monkeypatch.setenv("TINYGP_TPU_PALLAS_LLK_BLOCK", "8")
    monkeypatch.setenv("TINYGP_TPU_PALLAS_SCAN", "0")
    _, res = residuals(m, 300, seed=30 + m, dtype=torch.float32)
    want = pallas_loglik._call_bwd_kernel(*(jnp.asarray(x.numpy()) for x in res))
    got = tiled(res, m, torch.float32)
    for g, w in zip(got, want):
        w = np.asarray(w, np.float64)
        assert g.dtype == torch.float32 and torch.isfinite(g).all()
        assert np.abs(g.double().numpy() - w).max() <= 5e-4 * np.abs(w).max()


@pytest.mark.parametrize("m", [4, 5, 6, 7, 8, 9])
def test_tiled_matches_jax_vjp_and_plain(m):
    """m = 4..9, where the JAX package's backward is the VJP through XLA
    (at m = 9 of its sequential factor-then-whiten pair): float64 at the
    tolerance table's 5e-7, and plain B2 to 1e-12."""
    arrays, res = residuals(m, 300, seed=40 + m)
    got = tiled(res, m)
    assert_matches_jax(got, arrays, res, _jax_vjp if m <= 8 else _jax_vjp_sequential)
    assert_matches_plain(got, res)


@pytest.mark.parametrize("m", [2, 5])
@pytest.mark.parametrize("size", ["one", "tile-1", "tile+1", "long"])
def test_tiled_at_the_edges_of_tiles(m, size):
    """N = 1, one tile less one, one tile and one, and N_LONG (many tiles,
    a ragged last one) at the card's float64 schedule: against plain B2,
    and at m = 2 against JAX's VJP at 5e-7 (its trace at m = 5 takes about
    15 s a size; m = 5 meets JAX above)."""
    tile = cuda_loglik.b2_schedule(m, torch.float64)[0]
    n = {"one": 1, "tile-1": tile - 1, "tile+1": tile + 1, "long": N_LONG}[size]
    arrays, res = residuals(m, n, seed=50 + m + n)
    got = tiled(res, m)
    if m <= 4:
        assert_matches_jax(got, arrays, res)
    assert_matches_plain(got, res)


@pytest.mark.parametrize("m", [9, 12, 16])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["float64", "float32"])
def test_tiled_tensor_core_orders_match_plain(m, dtype):
    """m = 9, 12 and 16 (the tensor-core kernel) at N = 300 and at N of one
    tile less one, one tile and one more, and across two look-back groups
    of 16 tiles with a ragged last tile: against plain B2 on the same
    values (1e-12 in float64; 5e-4 in float32, where the plain version
    computes in float32)."""
    tile = cuda_loglik.b2_schedule(m, dtype)[0]
    for n in (300, tile - 1, tile, tile + 1, 33 * tile + 5):
        _, res = residuals(m, n, seed=70 + m + n, dtype=dtype)
        got = tiled(res, m, dtype)
        for g, w in zip(got, cuda_loglik.plain_loglik_bwd(*res)):
            assert g.shape == w.shape and g.dtype == dtype and torch.isfinite(g).all()
            tol = 1e-12 if dtype == torch.float64 else 5e-4
            assert float((g - w).abs().max()) <= tol * float(w.abs().max()), n


@pytest.mark.parametrize("tile,sub", [(8, 2), (12, 3), (96, 1), (64, 32)])
def test_tiled_any_schedule_is_b2(tile, sub):
    """Other shapes of the association: teams of one element, one warp's
    run of teams and several runs (96 teams of 1), one team a tile."""
    _, res = residuals(3, 777, seed=60 + tile)
    assert_matches_plain(cuda_loglik.plain_loglik_bwd_tiled(*res, tile, sub), res)


def test_schedule_covers_the_one_launch_orders():
    """Every order up to 32 has a schedule in both storage types, a whole
    number of teams a tile (24 elements at m = 16 in float64, 44 in
    float32; above 16 one team of 32); none above 32."""
    for m in range(1, 33):
        for dtype in (torch.float32, torch.float64):
            tile, sub = cuda_loglik.b2_schedule(m, dtype)
            assert tile % sub == 0 and tile // sub in ((64,) if m <= 4 else (4,) if m <= 16 else (1,))
    assert cuda_loglik.b2_schedule(9, torch.float32) == (112, 28)
    assert cuda_loglik.b2_schedule(16, torch.float64) == (24, 6)
    assert cuda_loglik.b2_schedule(16, torch.float32) == (44, 11)
    assert cuda_loglik.b2_schedule(17, torch.float32) == (32, 32)
    assert cuda_loglik.b2_schedule(33, torch.float32) is None
