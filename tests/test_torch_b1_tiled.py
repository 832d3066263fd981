"""Kernels B1 and B1r's association on the card, in plain PyTorch
(``cuda_loglik.plain_loglik_terms_res_tiled``): tiles cut into teams, each
team's rank-one Riccati fold and sequential whitening fold, the in-tile
scans and the look-back over groups of tiles. Held against the JAX
package's forward (the TPU kernel in interpret mode at m = 1 and 2, as its
own test runs it; ``stacked_loglik_terms`` through XLA at every order) and
against the port's plain B1 and B1r (itself held to the JAX package in
``test_torch_loglik.py``). Only forwards run here, never a VJP.
The card tests hold the kernel to the plain versions
(``test_torch_cuda.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinygp_tpu.solvers.quasisep import ops as jops
from tinygp_tpu_torch.solvers.quasisep import cuda_loglik
from tinygp_tpu_torch.test_utils import assert_allclose, random_qsm_operands

ORDERS = [1, 2, 3, 4]
DTYPES = [torch.float64, torch.float32]
_jax_sums = jax.jit(jops.stacked_loglik_terms)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one thread: with several test workers, intra-op threads
    made these loops of small products several times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def operands(m, n, seed, dtype=torch.float64):
    arrays = random_qsm_operands(m, n, seed)
    return arrays, [torch.tensor(x, dtype=dtype) for x in arrays]


def tiled(args, m, schedule=None):
    tile, sub = schedule or cuda_loglik.b1_schedule(m, args[0].dtype)
    return cuda_loglik.plain_loglik_terms_res_tiled(*args, tile, sub)


def stream_errs(got, want):
    """Per output stream, the largest error relative to its largest
    magnitude, in float64."""
    out = []
    for g, w in zip(got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        out.append(float(np.max(np.abs(g - w)) / max(np.max(np.abs(w)), 1e-300)))
    return out


def assert_matches_plain(got, args, tol):
    """(quad, logdet, Fs, e, ic) against the port's plain B1r on the same
    values in float64, per stream; B1's plain sums are B1r's."""
    f64 = [x.double() for x in args]
    want = cuda_loglik.plain_loglik_terms_res(*f64)
    assert all(torch.equal(a, b) for a, b in zip(cuda_loglik.plain_loglik_terms(*f64), want[:2]))
    for g, w in zip(got, want):
        assert g.dtype == args[0].dtype and g.shape == w.shape and torch.isfinite(g).all()
    assert max(stream_errs(got, want)) <= tol, stream_errs(got, want)


@pytest.mark.parametrize("m", [1, 2])
def test_tiled_matches_pallas_interpret(monkeypatch, m):
    """Against the TPU kernel in interpret mode (small tiles, a ragged
    tail), ``_fused_fwd``'s call with residuals and, at m = 1,
    ``fused_loglik_terms``, on the same float32 operands: two association
    orders of float32 scans, so each stream within 5e-4 of its largest
    magnitude."""
    from tinygp_tpu.solvers.quasisep import pallas_loglik, pallas_scan

    monkeypatch.setattr(pallas_scan, "INTERPRET", True)
    monkeypatch.setenv("TINYGP_TPU_PALLAS_LLK_BLOCK", "8")
    monkeypatch.setenv("TINYGP_TPU_PALLAS_SCAN", "0")
    arrays, args = operands(m, 300, seed=10 + m, dtype=torch.float32)
    jargs = [jnp.asarray(x, jnp.float32) for x in arrays]
    got = tiled(args, m)
    want = pallas_loglik._fused_fwd(*jargs)
    assert max(stream_errs(got[:2], want[0])) <= 5e-4
    assert max(stream_errs(got[2:], want[1][5:])) <= 5e-4
    if m == 1:
        assert max(stream_errs(got[:2], pallas_loglik.fused_loglik_terms(*jargs))) <= 5e-4


@pytest.mark.parametrize("dtype", DTYPES, ids=["float64", "float32"])
@pytest.mark.parametrize("m", ORDERS)
def test_tiled_across_look_back_groups_matches_plain(m, dtype):
    """N across a look-back group (33 tiles and a ragged one) at the card's
    schedule: every stream against the port's plain B1r (1e-12 in float64;
    5e-4 in float32, where the plain version scans in float32)."""
    tile = cuda_loglik.b1_schedule(m, dtype)[0]
    _, args = operands(m, 33 * tile + 77, seed=20 + m, dtype=dtype)
    assert_matches_plain(tiled(args, m), args, 1e-12 if dtype == torch.float64 else 5e-4)


@pytest.mark.parametrize("m", ORDERS)
@pytest.mark.parametrize("size", ["one", "below-tile", "tile", "tile+1"])
def test_tiled_at_the_edges_of_tiles(m, size):
    """N of one element (its residuals F and e are 0), below one tile, one
    tile and one tile and one, in float64 at the card's schedule, against
    plain B1r (1e-12) and, at m <= 2 and below one tile at m = 3, 4, the
    JAX package's ``stacked_loglik_terms`` (5e-7; its trace at m = 3, 4
    takes 5-10 s a size)."""
    tile = cuda_loglik.b1_schedule(m, torch.float64)[0]
    n = {"one": 1, "below-tile": tile // 2 + 3, "tile": tile, "tile+1": tile + 1}[size]
    arrays, args = operands(m, n, seed=30 + m + n)
    got = tiled(args, m)
    if m <= 2 or size == "below-tile":
        for g, w in zip(got[:2], _jax_sums(*map(jnp.asarray, arrays))):
            assert_allclose(g, w)
    assert_matches_plain(got, args, 1e-12)


@pytest.mark.parametrize("tile,sub", [(8, 2), (12, 3), (96, 1), (64, 32), (256, 4)])
@pytest.mark.parametrize("m", [2, 4])
def test_tiled_any_schedule_is_b1(m, tile, sub):
    """Other shapes of the association: teams of one element, one warp's
    run of teams and several runs (96 teams of 1), one team a tile, and the
    m = 3, 4 schedule at m = 2; over many look-back groups."""
    _, args = operands(m, 40 * tile + 5, seed=60 + tile)
    assert_matches_plain(cuda_loglik.plain_loglik_terms_res_tiled(*args, tile, sub), args, 1e-12)


def test_tiled_value_is_the_res_sums():
    _, args = operands(3, 999, seed=7)
    got = cuda_loglik.plain_loglik_terms_tiled(*args, 64, 4)
    want = cuda_loglik.plain_loglik_terms_res_tiled(*args, 64, 4)[:2]
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_schedule_covers_the_one_launch_orders():
    """Every order up to 32 has a schedule in both storage types: 64 teams
    a tile up to 4, four warp teams at 5..16 (up to 64 elements a team with
    maps padded to 8, 64 at m = 5 in float32; up to 32 padded to 16, 27 at
    m = 9 and 9 at m = 16 in float64), one team of 64 above; none above
    32."""
    for m in range(1, 33):
        for dtype in DTYPES:
            tile, sub = cuda_loglik.b1_schedule(m, dtype)
            if m <= 4:
                assert tile == 64 * sub and sub == (8 if m <= 2 else 4)
            elif m <= 16:
                assert tile == 4 * sub and 1 <= sub <= (64 if m <= 8 else 32)
            else:
                assert tile == sub == 64
    assert cuda_loglik.b1_schedule(5, torch.float32) == (256, 64)
    assert cuda_loglik.b1_schedule(9, torch.float64) == (108, 27)
    assert cuda_loglik.b1_schedule(16, torch.float64) == (36, 9)
    assert cuda_loglik.b1_schedule(33, torch.float32) is None


# The one-launch kernels above m = 4: a warp a team on the float64 tensor
# cores (m = 5, 9) and a block a team (m = 20), each chain's look-back in
# groups of 16 tiles folded in runs of 4.
NEW_ORDERS = [5, 9, 20]


@pytest.mark.parametrize("dtype", DTYPES, ids=["float64", "float32"])
@pytest.mark.parametrize("m", NEW_ORDERS)
def test_generic_orders_across_look_back_groups_match_plain(m, dtype):
    """N across a look-back group of 16 tiles (17 tiles and a ragged one)
    at the card's schedule: every stream against the port's plain B1r
    (1e-12 in float64; 5e-4 in float32, where the plain version scans in
    float32)."""
    tile = cuda_loglik.b1_schedule(m, dtype)[0]
    _, args = operands(m, 17 * tile + 7, seed=120 + m, dtype=dtype)
    assert_matches_plain(tiled(args, m), args, 1e-12 if dtype == torch.float64 else 5e-4)


@pytest.mark.parametrize("m", NEW_ORDERS)
@pytest.mark.parametrize("size", ["one", "below-tile", "tile", "tile+1"])
def test_generic_orders_at_the_edges_of_tiles(m, size):
    """N of one element, below one tile, one tile and one tile and one, in
    float64 at the card's schedule, against plain B1r (1e-12)."""
    tile = cuda_loglik.b1_schedule(m, torch.float64)[0]
    n = {"one": 1, "below-tile": tile // 2 + 3, "tile": tile, "tile+1": tile + 1}[size]
    _, args = operands(m, n, seed=130 + m + n)
    assert_matches_plain(tiled(args, m), args, 1e-12)
