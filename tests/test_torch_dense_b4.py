"""Kernel B4's tile schedule and row side products, on the CPU.

B4 (the blocked Cholesky's in-place trailing update) runs on the tensor
cores: a split pass that also computes the row side products, then a GEMM
over the lower 128 x 128 tile pairs of the trailing submatrix, written in
place with no mirror. ``plain_syrk_inplace_by_tiles`` is that schedule in
plain PyTorch and ``plain_row_sums`` the split pass's reduction order.
Here the schedule is held bit for bit to ``plain_syrk_sub_inplace`` on
integer operands (every product and sum exact), at trailing sizes that are
no multiple of 128, with T outside the lower tiles left as it was; the
row sums bit for bit to a float32 loop in the kernel's order; and both,
with ``syrk_sub_inplace`` on the CPU, to the JAX package's
``pallas_dense.syrk_sub_inplace`` in interpret mode on the same seeded
inputs (rtol = atol = 1e-5, plus the JAX kernel's own split error at 2
terms).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinygp_tpu.ops import pallas_dense
from tinygp_tpu_torch.ops import cuda_dense


def integer_operands(m, b, seed):
    rng = np.random.default_rng(seed)
    T = torch.as_tensor(rng.integers(-50, 50, size=(m, m)), dtype=torch.float32)
    L = torch.as_tensor(rng.integers(-4, 5, size=(m, b)), dtype=torch.float32)
    ak = torch.as_tensor(rng.integers(-4, 5, size=b), dtype=torch.float32)
    return T, L, ak


def lower_tiles(t, kernel_tile):
    """The mask of the lower kernel tiles (i >= j) of a t x t block."""
    blocks = torch.arange(t) // kernel_tile
    return blocks[:, None] >= blocks[None, :]


# (m, caller tile, offset): trailing sizes 224, 336, 448 and 96 against the
# kernel's 128, offsets no multiple of 128, caller tiles 16 and 32.
RAGGED = [(320, 32, 96), (416, 16, 80), (544, 32, 96), (112, 16, 16)]


@pytest.mark.parametrize("extras", [False, True], ids=["plain", "ak"])
@pytest.mark.parametrize("m,tile,offset", RAGGED, ids=lambda v: str(v))
def test_plain_syrk_inplace_by_tiles_equals_plain_syrk_sub_inplace(m, tile, offset, extras):
    T, L, ak = integer_operands(m, 24, seed=m + offset)
    L = L[offset:]
    ak = ak if extras else None
    got = cuda_dense.plain_syrk_inplace_by_tiles(T.clone(), L, offset, ak)
    want = cuda_dense.plain_syrk_sub_inplace(T.clone(), L, offset, ak)
    if extras:
        (got, gsq, gsu), (want, wsq, wsu) = got, want
        assert torch.equal(gsq, wsq) and torch.equal(gsu, wsu)
    t = m - offset
    # The leading rows and columns untouched, bit for bit.
    assert torch.equal(got[:offset], T[:offset]) and torch.equal(got[:, :offset], T[:, :offset])
    trail, orig = got[offset:, offset:], T[offset:, offset:]
    lower = torch.ones(t, t, dtype=torch.bool).tril()
    assert torch.equal(trail[lower], want[offset:, offset:][lower])
    # The strictly upper kernel tiles untouched; the diagonal tiles updated
    # whole (above the diagonal too).
    tiles = lower_tiles(t, cuda_dense.KERNEL_TILE)
    assert torch.equal(trail[~tiles], orig[~tiles])
    full = orig - L @ L.T
    assert torch.equal(trail[tiles], full[tiles])


def row_sums_loop(L, ak):
    """The split pass's row side products, written as the kernel runs them:
    32 lanes, each summing its columns in turn in float32 (product rounded,
    then the sum), then a butterfly over the lanes."""
    L, ak = L.astype(np.float32), ak.astype(np.float32)
    t, b = L.shape
    sq = np.zeros((t, 32), np.float32)
    su = np.zeros((t, 32), np.float32)
    for lane in range(32):
        for c in range(lane, b, 32):
            sq[:, lane] = sq[:, lane] + L[:, c] * L[:, c]
            su[:, lane] = su[:, lane] + L[:, c] * ak[c]
    for o in (16, 8, 4, 2, 1):
        partner = np.arange(32) ^ o
        sq, su = sq + sq[:, partner], su + su[:, partner]
    return sq[:, 0], su[:, 0]


@pytest.mark.parametrize("b", [20, 32, 100, 512])
def test_plain_row_sums_repeat_the_split_pass_order(b):
    rng = np.random.default_rng(b)
    L = (rng.normal(size=(70, b)) * 10.0 ** rng.uniform(-3, 3, size=(70, 1))).astype(np.float32)
    ak = rng.normal(size=b).astype(np.float32)
    sq, su = cuda_dense.plain_row_sums(torch.as_tensor(L), torch.as_tensor(ak))
    want_sq, want_su = row_sums_loop(L, ak)
    np.testing.assert_array_equal(sq.numpy(), want_sq)
    np.testing.assert_array_equal(su.numpy(), want_su)
    L64 = L.astype(np.float64)
    np.testing.assert_allclose(sq.numpy(), np.sum(L64 * L64, axis=1), rtol=1e-6)


# (m, caller tile, b, offset) for the JAX kernel in interpret mode: ragged
# trailing sizes (160 and 224) against the kernel's 128 at tiles 16 and 32.
JAX_SHAPES = [(192, 16, 16, 32), (256, 32, 32, 32)]


@pytest.mark.parametrize("terms", [2, 3])
@pytest.mark.parametrize("extras", [False, True], ids=["plain", "ak"])
@pytest.mark.parametrize("m,tile,b,offset", JAX_SHAPES, ids=lambda v: str(v))
def test_b4_schedule_matches_pallas_interpret(m, tile, b, offset, extras, terms):
    """Within rtol = atol = 1e-5 of the JAX kernel at 3 terms, at either
    ``terms``: B4 computes the 3-term products for both orders (and the
    plain versions exact float32 products). Against the JAX kernel at 2
    terms the bound adds that kernel's own split error, 2^-16 per operand
    (about 1e-5 here)."""
    rng = np.random.default_rng(m + b + terms + extras)
    S = rng.normal(size=(m, m))
    T = ((S + S.T) * 2**-0.5).astype(np.float32)
    L = (rng.normal(size=(m - offset, b)) * b**-0.5).astype(np.float32)
    ak = rng.normal(size=b).astype(np.float32) if extras else None

    def jax_b4(jax_terms):
        out = pallas_dense.syrk_sub_inplace(
            jnp.asarray(T), jnp.asarray(L), offset=offset, tile=tile, terms=jax_terms,
            ak=None if ak is None else jnp.asarray(ak),
        )
        return [np.asarray(x) for x in (out if extras else (out,))]

    tak = None if ak is None else torch.as_tensor(ak)
    by_tiles = cuda_dense.plain_syrk_inplace_by_tiles(
        torch.as_tensor(T.copy()), torch.as_tensor(L), offset, tak
    )
    wrapper = cuda_dense.syrk_sub_inplace(
        torch.as_tensor(T.copy()), torch.as_tensor(L), offset=offset, tile=tile, terms=terms,
        ak=tak,
    )
    if not extras:
        by_tiles, wrapper = (by_tiles,), (wrapper,)
    lower = np.tril_indices(m - offset)
    absL = np.abs(L.astype(np.float64))
    split_err = {2: 2.0**-16, 3: 0.0}[terms] * (absL @ absL.T)[lower]
    references = [(jax_b4(3), 0.0)] + ([(jax_b4(2), split_err)] if terms == 2 else [])
    for got in (by_tiles, wrapper):
        got = [x.numpy() for x in got]
        np.testing.assert_array_equal(got[0][:offset], T[:offset])
        np.testing.assert_array_equal(got[0][:, :offset], T[:, :offset])
        for want, extra in references:
            g, w = got[0][offset:, offset:][lower], want[0][offset:, offset:][lower]
            assert np.all(np.abs(g - w) <= 1e-5 + 1e-5 * np.abs(w) + extra)
            for side, jax_side in zip(got[1:], want[1:]):
                np.testing.assert_allclose(side, jax_side, rtol=1e-5, atol=1e-5)
