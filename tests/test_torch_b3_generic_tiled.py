"""Kernel B3's one-launch Riccati flow, affine and congruence scans at
m = 5..16 and couplings whose larger order is 9..16
(``csrc/quasisep_generic.cu``: ``ric_tile_kernel``, ``aff_tile_kernel``,
``cong_tile_kernel``, ``cpl_tc_tile_kernel``), and every monoid above 16
(``csrc/quasisep_wide.cu``: a tile of 32 elements one team), in plain
PyTorch: ``cuda_scan.plain_scan_tiled`` under ``cuda_scan.b3_schedule`` (4
warp teams a tile to 16, look-back groups of 16 tiles folded in runs of
4). Held against
the JAX package's stacked scans (``scan.py``) through XLA, the port's plain
blocked scans across several look-back groups and at the edges of tiles,
the TPU kernel in interpret mode (an affine scan at m = 8), and, for the
order-16 posterior process given ``diag=1e-3`` at N = 5000, a dense
Cholesky, within the limit ``chip_smoke.py`` holds the card to. The card
tests hold the kernels to these (``test_torch_cuda.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinygp_tpu.solvers.quasisep import scan as jscan
from tinygp_tpu_torch import GaussianProcess
from tinygp_tpu_torch.kernels import quasisep
from tinygp_tpu_torch.solvers.quasisep import cuda_scan, scan
from tinygp_tpu_torch.test_utils import random_qsm_operands

ORDERS = (5, 8, 12, 16)
WIDE_ORDERS = (17, 20, 32)
COLUMNS = (1, 3, 16)
# The couplings above order 8: (m, m2), equal and unequal, either side of 16.
COUPLINGS = ((9, 9), (10, 10), (16, 16), (18, 18), (32, 32), (5, 16), (16, 5))


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these tests run many small tensor operations,
    which more threads only slow down where test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def operands(monoid, m, n, r, seed, dtype=torch.float64, m2=None):
    """Numpy operands of one scan (the Riccati flow's of a positive definite
    K, contracting transitions and normal loads for the affine scan, the
    congruence, whose loads are not symmetric, and the coupling of orders
    m and m2) and the same as tensors."""
    d, ps, qs, as_, _ = random_qsm_operands(m, n, seed)
    if monoid == "aff":
        arrays = (as_, np.random.default_rng(seed + 1).normal(size=(m * r, n)))
    elif monoid == "cong":
        arrays = (as_, np.random.default_rng(seed + 1).normal(size=(m * m, n)))
    elif monoid == "cpl":
        arrays = (as_, random_qsm_operands(m2, n, seed + 2)[3],
                  np.random.default_rng(seed + 1).normal(size=(m * m2, n)))
    else:
        arrays = (d, ps, qs, as_)
    arrays = tuple(np.ascontiguousarray(x) for x in arrays)
    return arrays, [torch.tensor(x, dtype=dtype) for x in arrays]


def tiled(monoid, args, m, r, reverse, exclusive, m2=None):
    schedule = cuda_scan.b3_schedule(monoid, m, r, args[0].dtype, m2=m2)
    return cuda_scan.plain_scan_tiled(monoid, args, m, r=r, m2=m2, reverse=reverse,
                                      exclusive=exclusive, schedule=schedule)


def plain(monoid, args, m, r, reverse, exclusive, m2=None):
    """The port's plain B3: the stacked blocked scans."""
    if monoid == "aff":
        return scan._affine_scan_s(*args, m, r, reverse=reverse, exclusive=exclusive)
    if monoid == "cong":
        return scan._congruence_scan_s(*args, m, reverse=reverse)
    if monoid == "cpl":
        return scan._coupling_scan_s(*args, m, m2, reverse=reverse, exclusive=exclusive)
    return scan._riccati_scan_s(*args, m)


def stream_err(got, want):
    """Largest error relative to the largest magnitude, in float64."""
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(g - w)) / max(np.max(np.abs(w)), 1e-300))


def check(got, want, tol):
    assert got.shape == want.shape and np.isfinite(np.asarray(got)).all()
    assert stream_err(got, want) <= tol, stream_err(got, want)


# (monoid, m, r, reverse, exclusive): the Riccati flow (forward, exclusive)
# at each order, the affine scan at each order, column count, direction
# and output, and the congruence scan (exclusive) in either direction; above
# 16 the affine scan in either direction (exclusive forward, inclusive
# reverse); the coupling (the third entry its second order m2) in either
# direction.
CASES = [("ric", m, 1, False, True) for m in ORDERS] + [
    ("aff", m, r, reverse, exclusive)
    for m in ORDERS for r in COLUMNS for reverse in (False, True) for exclusive in (True, False)
] + [("cong", m, 1, reverse, True) for m in ORDERS for reverse in (False, True)] + [
    ("ric", m, 1, False, True) for m in WIDE_ORDERS] + [
    ("aff", m, r, reverse, not reverse) for m in WIDE_ORDERS for r in COLUMNS
    for reverse in (False, True)
] + [("cong", m, 1, reverse, True) for m in WIDE_ORDERS for reverse in (False, True)] + [
    ("cpl", m, m2, reverse, not reverse) for m, m2 in COUPLINGS for reverse in (False, True)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["float64", "float32"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_tiled_across_look_back_groups_matches_plain(case, dtype):
    """The card's schedule over 33 tiles and a ragged one (three look-back
    groups of 16, each folding runs of 4 tiles), against the
    port's plain scan on the same values (1e-12 in float64; 5e-4 in
    float32, where the plain version scans in float32)."""
    monoid, m, r, reverse, exclusive = case
    m2, r = (r, 1) if monoid == "cpl" else (None, r)
    tile = cuda_scan.b3_schedule(monoid, m, r, dtype, m2=m2)[0]
    _, args = operands(monoid, m, 33 * tile + 5, r, seed=m + r, dtype=dtype, m2=m2)
    got = tiled(monoid, args, m, r, reverse, exclusive, m2=m2)
    assert got.dtype == dtype
    check(got, plain(monoid, args, m, r, reverse, exclusive, m2=m2),
          1e-12 if dtype == torch.float64 else 5e-4)


# Each order and column count once, the directions and outputs spread over
# them.
JAX_CASES = [("ric", m, 1, False, True) for m in ORDERS] + [
    ("aff", m, r, (i + j) % 2 == 1, (i + 2 * j) % 3 != 1)
    for i, m in enumerate(ORDERS) for j, r in enumerate(COLUMNS)
] + [("cong", m, 1, i % 2 == 0, True) for i, m in enumerate(ORDERS)] + [
    ("ric", 20, 1, False, True), ("aff", 20, 3, True, False), ("cong", 20, 1, True, True)]


def jax_scan(monoid, arrays, m, r, reverse, exclusive):
    """The JAX package's scan on stacked operands: its stacked blocked scan
    at m = 5, its sequential recurrence (``lax.scan``) above and for the
    congruence, whose stacked form takes minutes to compile at m = 12 and
    16."""
    n = arrays[0].shape[-1]
    if monoid == "cong":
        A, B = (x.T.reshape(n, m, m) for x in arrays)
        return jscan.congruence_scan(A, B, reverse=reverse, parallel=False).reshape(n, m * m).T
    if m == 5:
        if monoid == "aff":
            return jscan._affine_scan_s(*arrays, m, r, reverse=reverse, exclusive=exclusive)
        return jscan._riccati_scan_s(*arrays, m)
    if monoid == "aff":
        A, B = arrays[0].T.reshape(n, m, m), arrays[1].T.reshape(n, m, r)
        e = jscan.affine_scan(A, B, reverse=reverse, parallel=False, exclusive=exclusive)
        return e.reshape(n, m * r).T
    d, ps, qs, as_ = arrays
    F = jscan.riccati_scan(d, ps.T, qs.T, as_.T.reshape(n, m, m), parallel=False)
    return F.reshape(n, m * m).T


@pytest.mark.parametrize("case", JAX_CASES, ids=lambda c: "-".join(map(str, c)))
def test_tiled_matches_jax(case):
    """Over 600 elements (tiles of 16 to 128, up to 38 of them) against the
    JAX package through XLA on the same float64 operands (5e-7 of each
    output's largest magnitude, the tolerance table's float64 entry)."""
    monoid, m, r, reverse, exclusive = case
    arrays, args = operands(monoid, m, 600, r, seed=3 * m + r)
    want = np.asarray(jax.jit(
        lambda *x: jax_scan(monoid, x, m, r, reverse, exclusive))(*map(jnp.asarray, arrays)))
    check(tiled(monoid, args, m, r, reverse, exclusive), want, 5e-7)


@pytest.mark.parametrize("monoid", ["ric", "aff", "cong"])
@pytest.mark.parametrize("m", [5, 16, 20])
def test_tiled_at_the_edges_of_tiles(monoid, m):
    """N of one element, one below a tile, one tile and one more, in
    float64, against the port's plain scan (1e-12); an exclusive scan's
    first state is 0."""
    tile = cuda_scan.b3_schedule(monoid, m, 1, torch.float64)[0]
    for n in (1, tile - 1, tile, tile + 1):
        _, args = operands(monoid, m, n, 1, seed=n)
        got = tiled(monoid, args, m, 1, False, True)
        assert torch.equal(got[:, 0], torch.zeros_like(got[:, 0]))
        check(got, plain(monoid, args, m, 1, False, True), 1e-12)


def test_tiled_matches_pallas_interpret(monkeypatch):
    """The reverse affine scan at m = 8 against the TPU kernel in interpret
    mode (``pallas_monoid_scan``, one block of 128 lanes a grid step, so 150
    elements span two steps with a ragged tail), on the same float32
    operands: two association orders of float32 scans, so within 5e-4 of
    the output's largest magnitude."""
    from tinygp_tpu.solvers.quasisep import pallas_scan

    monkeypatch.setattr(pallas_scan, "INTERPRET", "warp")
    m, n, reverse = 8, 150, True
    arrays, args = operands("aff", m, n, 1, seed=7, dtype=torch.float32)
    ident = (np.eye(m).reshape(m * m, 1).astype(np.float32), np.zeros((m, 1), np.float32))
    want = pallas_scan.pallas_monoid_scan(
        jscan.affine_combine_lists(m, 1, reverse), ident,
        tuple(jnp.asarray(x, jnp.float32) for x in arrays), reverse=reverse, block=1, lanes=128)
    check(tiled("aff", args, m, 1, reverse, True), want[1], 5e-4)


def test_schedule_of_the_one_launch_generic_scans():
    """4 teams a tile, the most elements a team (32 down to 1) whose staged
    tile fits beside the block's maps, the look-back in groups of 16 tiles
    folded in runs of 4; the couplings whose larger order is 9..16 the same
    (padded to 16); above 16 a tile of 32 elements one team (the Riccati
    flow's 64), the same look-back; nothing above 32."""
    f32, f64 = torch.float32, torch.float64
    assert cuda_scan.b3_schedule("ric", 8, 1, f64) == (128, 32, (4, 16))
    assert cuda_scan.b3_schedule("ric", 12, 1, f64) == (64, 16, (4, 16))
    assert cuda_scan.b3_schedule("ric", 16, 1, f64) == (32, 8, (4, 16))
    assert cuda_scan.b3_schedule("ric", 16, 1, f32) == (64, 16, (4, 16))
    assert cuda_scan.b3_schedule("aff", 8, 16, f64) == (64, 16, (4, 16))
    assert cuda_scan.b3_schedule("aff", 16, 1, f64) == (32, 8, (4, 16))
    assert cuda_scan.b3_schedule("aff", 16, 16, f64) == (16, 4, (4, 16))
    assert cuda_scan.b3_schedule("cong", 5, 1, f32) == (128, 32, (4, 16))
    assert cuda_scan.b3_schedule("cong", 8, 1, f64) == (64, 16, (4, 16))
    assert cuda_scan.b3_schedule("cong", 12, 1, f64) == (32, 8, (4, 16))
    assert cuda_scan.b3_schedule("cong", 16, 1, f64) == (16, 4, (4, 16))
    assert cuda_scan.b3_schedule("cong", 16, 1, f32) == (32, 8, (4, 16))
    assert cuda_scan.b3_schedule("cpl", 9, 1, f32) == (64, 16, (4, 16))
    assert cuda_scan.b3_schedule("cpl", 10, 1, f32) == (64, 16, (4, 16))
    assert cuda_scan.b3_schedule("cpl", 16, 1, f64) == (8, 2, (4, 16))
    assert cuda_scan.b3_schedule("cpl", 5, 1, f64, 16) == (32, 8, (4, 16))
    for monoid in ("ric", "aff", "cong", "cpl"):
        tile = 64 if monoid == "ric" else 32
        for m in (17, 20, 32):
            for dtype in (f32, f64):
                assert cuda_scan.b3_schedule(monoid, m, 1, dtype) == (tile, tile, (4, 16))
        assert cuda_scan.b3_schedule(monoid, 33, 1, f64) is None
    assert cuda_scan.b3_schedule("cpl", 4, 1, f32, 18) == (32, 32, (4, 16))


def celerite2():
    """``bench.py:331-345``'s 2-term celerite (order 4; its posterior is of
    order 16)."""
    return quasisep.Celerite(a=1.0, b=0.1, c=0.5, d=1.0) + quasisep.Celerite(
        a=0.5, b=0.05, c=1.5, d=3.0
    )


def posterior(X, y):
    gp = GaussianProcess(celerite2(), X, diag=0.1, assume_sorted=True, device="cpu")
    return gp.condition(y, diag=1e-3)[1]


def dense_reference(post, y, noise):
    """The log probability and the factor times noise from a dense Cholesky
    of the posterior matrix, built 1000 columns at a time by the sequential
    recurrences."""
    n = y.shape[0]
    eye = torch.eye(n, dtype=y.dtype)
    K = torch.cat([post.solver.matrix.matmul(eye[:, k:k + 1000], parallel=False)
                   for k in range(0, n, 1000)], 1)
    L = torch.linalg.cholesky(K)
    z = torch.linalg.solve_triangular(L, (y - post.loc)[:, None], upper=False)[:, 0]
    lp = (-0.5 * torch.sum(z * z) - torch.sum(torch.log(torch.diagonal(L)))
          - 0.5 * n * np.log(2 * np.pi)).item()
    return lp, L @ noise


def posterior_errors(post, y, noise, lp, draws):
    """The O(N) log probability's and factor times noise's distances from
    the dense ones."""
    got_lp = post.log_probability(y).item()
    got = post.solver.dot_triangular(noise)
    return (abs(got_lp - lp) / abs(lp),
            float((got - draws).abs().max() / draws.abs().max()))


def test_order_16_posterior_through_the_tiled_association_holds_to_dense(monkeypatch):
    """The 2-term celerite's posterior process (order 16) given diag=1e-3
    at N = 5000 (every 20th of ``bench.py``'s 1e5 points), float64: with
    every Riccati and affine scan at m = 5..16 through ``plain_scan_tiled``
    under the card's schedule, its log probability and its factor times
    noise are no further from a dense Cholesky than ten times the plain
    blocked scans' distance, and never past 1e-8 where that is smaller:
    the limit ``chip_smoke.py`` holds the card to (its orders-path phase)."""
    rng = np.random.default_rng(42)
    X5 = np.sort(rng.uniform(0, 10, 100_000))
    y5 = rng.normal(size=100_000)
    X, y = torch.as_tensor(X5[::20]), torch.as_tensor(y5[::20])
    noise = torch.as_tensor(np.random.default_rng(3).normal(size=(X.shape[0], 16)))
    post, again = posterior(X, y), posterior(X, y)
    lp, draws = dense_reference(post, y, noise)
    plain_errs = posterior_errors(post, y, noise, lp, draws)

    routed = {"aff": 0, "ric": 0}
    affine, riccati = cuda_scan.affine, cuda_scan.riccati

    def tiled_affine(As, Bs, m, r, *, reverse, exclusive):
        if cuda_scan.b3_schedule("aff", m, r, As.dtype) is None:
            return affine(As, Bs, m, r, reverse=reverse, exclusive=exclusive)
        routed["aff"] += 1
        return tiled("aff", [As, Bs], m, r, reverse, exclusive)

    def tiled_riccati(d, ps, qs, as_):
        m = ps.shape[0]
        if cuda_scan.b3_schedule("ric", m, 1, d.dtype) is None:
            return riccati(d, ps, qs, as_)
        routed["ric"] += 1
        return tiled("ric", [d, ps, qs, as_], m, 1, False, True)

    monkeypatch.setattr(cuda_scan, "affine", tiled_affine)
    monkeypatch.setattr(cuda_scan, "riccati", tiled_riccati)
    tiled_errs = posterior_errors(again, y, noise, lp, draws)
    assert routed["ric"] >= 1 and routed["aff"] >= 2, routed
    limits = [max(1e-8, 10 * e) for e in plain_errs]
    assert all(e <= lim for e, lim in zip(tiled_errs, limits)), (tiled_errs, plain_errs)
