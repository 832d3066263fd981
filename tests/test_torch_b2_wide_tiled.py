"""Kernel B2's association above m = 16 on the card, in plain PyTorch
(``cuda_loglik.plain_loglik_bwd_tiled`` at ``b2_schedule``'s tiles of 32
mirrored positions, one team a tile): the block-a-team kernel of
``csrc/quasisep_loglik_wide.cu`` folds each tile's affine and congruence
adjoints in order, its look-back composes groups of 16 tiles in runs of 4,
and its congruence adjoint scans Gbar + Gbar^T. Held at m = 20 against the
port's plain B2 (itself held to the JAX package's VJP in
``test_torch_b2_tiled.py``) to 1e-12 of each output's largest magnitude.
The card tests hold the kernel to the plain versions
(``test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from tinygp_tpu_torch.solvers.quasisep import cuda_loglik
from tinygp_tpu_torch.test_utils import random_qsm_operands

M = 20


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one thread: with several test workers, intra-op threads
    made these loops of small products several times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def residuals(m, n, seed, dtype=torch.float64):
    """The operands' B1r residuals (plain) and two cotangents."""
    d, ps, qs, as_, y = (torch.tensor(x, dtype=dtype) for x in random_qsm_operands(m, n, seed))
    _, _, Fs, e, ic = cuda_loglik.plain_loglik_terms_res(d, ps, qs, as_, y)
    qbar, lbar = (torch.tensor(v, dtype=dtype) for v in np.random.default_rng(seed).normal(size=2))
    return ps, qs, as_, y, Fs, e, ic, qbar, lbar


def assert_matches_plain(res, tol=1e-12):
    got = cuda_loglik.plain_loglik_bwd_tiled(*res, *cuda_loglik.b2_schedule(M, res[0].dtype))
    for g, w in zip(got, cuda_loglik.plain_loglik_bwd(*(x.double() for x in res))):
        assert g.shape == w.shape and g.dtype == res[0].dtype and torch.isfinite(g).all()
        assert float((g.double() - w).abs().max()) <= tol * float(w.abs().max())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["float64", "float32"])
def test_wide_b2_across_look_back_groups_matches_plain(dtype):
    """17 tiles and a ragged one (across a look-back group of 16): 1e-12 in
    float64; in float32 5e-4, the residuals and plain B2 being float32
    scans."""
    assert cuda_loglik.b2_schedule(M, dtype) == (32, 32)
    assert_matches_plain(residuals(M, 17 * 32 + 7, seed=220, dtype=dtype),
                         1e-12 if dtype == torch.float64 else 5e-4)


@pytest.mark.parametrize("n", [1, 19, 32, 33])
def test_wide_b2_at_the_edges_of_tiles(n):
    """One element, below one tile, one tile and one tile and one."""
    assert_matches_plain(residuals(M, n, seed=230 + n))
