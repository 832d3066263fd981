"""Kernel B3's association on the card, in plain PyTorch
(``cuda_scan.plain_scan_tiled``): the templated one-launch scan at m <= 4
(a thread a team, 64 teams a tile, a warp-parallel look-back fold) and the
one-launch coupling of orders up to 8 (a warp a team, 4 teams a tile, the
look-back folding one tile at a time). Held against the JAX package's
stacked scans (``scan.py``) and ``ops._coupling_scan`` through XLA, the TPU
kernel in interpret mode (an affine scan at m = 2, as its own test runs
it), and the port's plain scans (themselves held to the JAX package in
``test_torch_scan.py``). The card tests hold the kernels to these
(``test_torch_cuda.py``). Only forwards run here, never a VJP."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinygp_tpu.solvers.quasisep import ops as jops
from tinygp_tpu.solvers.quasisep import scan as jscan
from tinygp_tpu_torch.solvers.quasisep import cuda_scan, scan
from tinygp_tpu_torch.test_utils import random_qsm_operands

# A schedule of small tiles: 600 elements make 38 tiles, two look-back
# groups and a ragged tile.
SMALL = (16, 2, "warp")
N_SMALL = 600


def operands(monoid, m, n, r, seed, m2=None, dtype=torch.float64):
    """Numpy operands of one scan (contracting transitions, normal loads)
    and the same as tensors."""
    m2 = m if m2 is None else m2
    d, ps, qs, as_, _ = random_qsm_operands(m, n, seed)
    rng = np.random.default_rng(seed + 1)
    if monoid == "aff":
        arrays = (as_, rng.normal(size=(m * r, n)))
    elif monoid == "cong":
        arrays = (as_, rng.normal(size=(m * m, n)))
    elif monoid == "ric":
        arrays = (d, ps, qs, as_)
    else:
        arrays = (as_, random_qsm_operands(m2, n, seed + 2)[3], rng.normal(size=(m * m2, n)))
    arrays = tuple(np.ascontiguousarray(x) for x in arrays)
    return arrays, [torch.tensor(x, dtype=dtype) for x in arrays]


def tiled(monoid, args, m, r, m2, reverse, exclusive, schedule=None):
    schedule = schedule or cuda_scan.b3_schedule(monoid, m, r, args[0].dtype, m2)
    return cuda_scan.plain_scan_tiled(monoid, args, m, r=r, m2=m2, reverse=reverse,
                                      exclusive=exclusive, schedule=schedule)


def plain(monoid, args, m, r, m2, reverse, exclusive):
    """The port's plain B3: the stacked blocked scans."""
    if monoid == "aff":
        return scan._affine_scan_s(*args, m, r, reverse=reverse, exclusive=exclusive)
    if monoid == "cong":
        return scan._congruence_scan_s(*args, m, reverse=reverse)
    if monoid == "ric":
        return scan._riccati_scan_s(*args, m)
    return scan._coupling_scan_s(*args, m, m2, reverse=reverse, exclusive=exclusive)


def jax_scan(monoid, arrays, m, r, m2, reverse, exclusive):
    """The JAX package's scan on the same operands, stacked (rows, N)."""
    if monoid == "aff":
        return jscan._affine_scan_s(*arrays, m, r, reverse=reverse, exclusive=exclusive)
    if monoid == "cong":
        return jscan._congruence_scan_s(*arrays, m, reverse=reverse)
    if monoid == "ric":
        return jscan._riccati_scan_s(*arrays, m)
    n = arrays[0].shape[-1]
    A, B, C = (x.T.reshape(n, a, b) for x, (a, b) in zip(arrays, ((m, m), (m2, m2), (m, m2))))
    return jops._coupling_scan(A, B, C, reverse=reverse).reshape(n, m * m2).T


def stream_err(got, want):
    """Largest error relative to the largest magnitude, in float64."""
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(g - w)) / max(np.max(np.abs(w)), 1e-300))


def check(got, want, tol):
    assert got.shape == want.shape and np.isfinite(np.asarray(got)).all()
    assert stream_err(got, want) <= tol, stream_err(got, want)


# (monoid, m, m2, r, reverse, exclusive): each monoid, direction and output,
# affine columns on the grid (r > 1), the couplings the card routes to the
# generic source's one launch.
JAX_CASES = [
    ("aff", 1, 1, 1, False, True),
    ("aff", 2, 2, 3, True, False),
    ("aff", 3, 3, 9, False, False),
    ("cong", 1, 1, 1, True, True),
    ("cong", 3, 3, 1, False, True),
    ("ric", 2, 2, 1, False, True),
    ("ric", 3, 3, 1, False, True),
    ("cpl", 2, 2, 1, True, True),
    ("cpl", 4, 4, 1, False, True),
    ("cpl", 2, 4, 1, False, True),
    ("cpl", 4, 8, 1, True, True),
    ("cpl", 6, 6, 1, False, True),
    ("cpl", 8, 8, 1, True, True),
]


@pytest.mark.parametrize("case", JAX_CASES, ids=lambda c: "-".join(map(str, c)))
def test_tiled_matches_jax(case):
    """At the card's schedule and at a schedule of small tiles across two
    look-back groups, against the JAX package through XLA on the same
    float64 operands (5e-7 of each output's largest magnitude, the
    tolerance table's float64 entry)."""
    monoid, m, m2, r, reverse, exclusive = case
    arrays, args = operands(monoid, m, N_SMALL, r, seed=10 * m + m2 + r, m2=m2)
    want = np.asarray(jax.jit(
        lambda *x: jax_scan(monoid, x, m, r, m2, reverse, exclusive))(*map(jnp.asarray, arrays)))
    for schedule in (None, SMALL if monoid != "cpl" or max(m, m2) <= 4 else (16, 4, 8)):
        check(tiled(monoid, args, m, r, m2, reverse, exclusive, schedule), want, 5e-7)


@pytest.mark.parametrize("reverse", [False, True])
def test_tiled_matches_pallas_interpret(monkeypatch, reverse):
    """The affine scan at m = 2 against the TPU kernel in interpret mode
    (``pallas_monoid_scan``, one block of 128 lanes a grid step, so 2125
    elements span three steps with a ragged tail), on the same float32
    operands: two association orders of float32 scans, so within 5e-4 of
    the output's largest magnitude."""
    from tinygp_tpu.solvers.quasisep import pallas_scan

    monkeypatch.setattr(pallas_scan, "INTERPRET", "warp")
    m, n = 2, 2 * 1024 + 77
    arrays, args = operands("aff", m, n, 1, seed=5, dtype=torch.float32)
    ident = (np.eye(m).reshape(m * m, 1).astype(np.float32), np.zeros((m, 1), np.float32))
    want = pallas_scan.pallas_monoid_scan(
        jscan.affine_combine_lists(m, 1, reverse), ident,
        tuple(jnp.asarray(x, jnp.float32) for x in arrays), reverse=reverse, block=1, lanes=128)
    check(tiled("aff", args, m, 1, m, reverse, True), want[1], 5e-4)


# Every monoid, direction and output at m = 1..4, and the couplings of the
# generic source's one launch.
PLAIN_CASES = [
    (monoid, m, m, r, reverse, exclusive)
    for m in (1, 2, 3, 4)
    for monoid, r, reverse, exclusive in (
        ("aff", 1, False, True), ("aff", 1, True, False), ("aff", 16, True, True),
        ("aff", 11, False, False), ("cong", 1, False, True), ("cong", 1, True, True),
        ("ric", 1, False, True), ("cpl", 1, False, False), ("cpl", 1, True, True))
] + [("cpl", m, m2, 1, reverse, exclusive) for m, m2 in ((2, 4), (4, 8), (6, 6), (8, 8), (8, 2))
     for reverse, exclusive in ((False, True), (True, False))]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["float64", "float32"])
@pytest.mark.parametrize("case", PLAIN_CASES, ids=lambda c: "-".join(map(str, c)))
def test_tiled_across_look_back_groups_matches_plain(case, dtype):
    """The card's schedule over 33 tiles and a ragged one (two look-back
    groups), against the port's plain scan on the same values (1e-12 in
    float64; 5e-4 in float32, where the plain version scans in float32)."""
    monoid, m, m2, r, reverse, exclusive = case
    tile = cuda_scan.b3_schedule(monoid, m, r, dtype, m2)[0]
    _, args = operands(monoid, m, 33 * tile + 5, r, seed=m + m2 + r, m2=m2, dtype=dtype)
    got = tiled(monoid, args, m, r, m2, reverse, exclusive)
    assert got.dtype == dtype
    check(got, plain(monoid, args, m, r, m2, reverse, exclusive),
          1e-12 if dtype == torch.float64 else 5e-4)


@pytest.mark.parametrize("monoid", ["aff", "cong", "ric", "cpl"])
@pytest.mark.parametrize("n", [1, 15, 16, 17])
def test_tiled_at_the_edges_of_tiles(monoid, n):
    """N of one element, below one tile, one tile and one more, at m = 2 in
    float64 and tiles of 16, against the port's plain scan (1e-12); an
    exclusive scan's first state is 0."""
    _, args = operands(monoid, 2, n, 1, seed=n)
    got = tiled(monoid, args, 2, 1, 2, False, True, SMALL)
    assert torch.equal(got[:, 0], torch.zeros_like(got[:, 0]))
    check(got, plain(monoid, args, 2, 1, 2, False, True), 1e-12)


def test_schedule_covers_the_one_launch_scans():
    """m <= 4: 64 teams a tile, 8, 4 or 2 elements a thread by the staged
    bytes, the warp-parallel fold; the coupling up to order 8: 4 teams a
    tile, 32, 16 or 8 elements a team by the staged bytes, the look-back in
    runs of 8 tiles; the Riccati flow, the affine and the congruence scans
    at m = 5..16, the couplings above order 8 and every monoid above 16 in
    their own tiles (tests/test_torch_b3_generic_tiled.py); nothing above
    order 32 (None)."""
    f32, f64 = torch.float32, torch.float64
    assert cuda_scan.b3_schedule("aff", 2, 1, f32) == (512, 8, "warp")
    assert cuda_scan.b3_schedule("aff", 2, 16, f64) == (256, 4, "warp")
    assert cuda_scan.b3_schedule("aff", 4, 16, f64) == (128, 2, "warp")
    assert cuda_scan.b3_schedule("cpl", 4, 1, f32) == (256, 4, "warp")
    assert cuda_scan.b3_schedule("ric", 4, 1, f64) == (256, 4, "warp")
    assert cuda_scan.b3_schedule("cpl", 6, 1, f32) == (64, 16, 8)
    assert cuda_scan.b3_schedule("cpl", 8, 1, f32, 8) == (32, 8, 8)
    assert cuda_scan.b3_schedule("cpl", 8, 1, f64, 8) == (32, 8, 8)
    assert cuda_scan.b3_schedule("cpl", 2, 1, f64, 4) == (128, 32, 8)
    assert cuda_scan.b3_schedule("cpl", 9, 1, f32) == (64, 16, (4, 16))
    for monoid in ("aff", "ric", "cong"):
        assert cuda_scan.b3_schedule(monoid, 5, 1, f32) == (128, 32, (4, 16))
        tile = 64 if monoid == "ric" else 32
        assert cuda_scan.b3_schedule(monoid, 17, 1, f32) == (tile, tile, (4, 16))
        assert cuda_scan.b3_schedule(monoid, 33, 1, f32) is None
    assert cuda_scan.b3_schedule("cpl", 4, 1, f32, 9) == (128, 32, (4, 16))
