"""The bf16 splits of kernels B5 and B6 and B6's tile schedule, on the CPU.

B5 and B6 run on the tensor cores: a split pass turns each float32 operand
into bf16 pieces and a GEMM sums the piece products. Their plain
counterparts here are held to the JAX package's ``_split2``, ``_split3``
and ``_split_dots`` (``tinygp_tpu/ops/pallas_dense.py:44-89``) on the same
seeded numpy inputs: the pieces bit for bit, the piece products within
1e-6 of the largest magnitude (the JAX dots sum in float32, the plain
version in float64). ``plain_syrk_by_tiles``, B6's lower-pair schedule
with its mirrored tiles and ``lower_only`` zeros, is held equal to
``plain_syrk_sub`` on integer-valued operands, where every product and sum
is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinygp_tpu.ops import pallas_dense
from tinygp_tpu_torch.ops import cuda_dense

TINY = np.finfo(np.float32).tiny


def split_inputs(kind, seed):
    """Seeded float32 inputs of one kind, with both signs."""
    rng = np.random.default_rng(seed)
    sign = np.where(rng.uniform(size=600) < 0.5, -1.0, 1.0)
    if kind == "normal":
        x = rng.normal(size=600) * 10.0 ** rng.uniform(-6, 6, size=600)
    elif kind == "subnormal_adjacent":
        # Just above the smallest normal (the residual x - bf16(x) is then
        # subnormal), subnormals themselves, and zeros of both signs.
        x = np.concatenate([
            TINY * (1 + rng.uniform(0, 2.0**-5, size=300)),
            TINY * rng.uniform(0, 1, size=290),
            [TINY, 2 * TINY, TINY / 2, 1e-45, 0.0, 0.0, 1e-38, 1.2e-38, 2e-38, 3e-38],
        ]) * sign
    elif kind == "exact_bf16":
        # bf16 values (the residuals are exact zeros) and sums of two or
        # three of them (each piece recovers one).
        h = rng.normal(size=600).astype(np.float32)
        h = (h.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)
        x = h.astype(np.float64)
        x[200:400] += np.ldexp(np.sign(rng.normal(size=200)), -12) * np.abs(x[200:400])
        x[400:] += np.ldexp(1.0, -20) * x[400:]
    else:  # extremes, up to bf16's largest finite value (above it h is inf)
        x = np.concatenate([
            [1.0, -1.0, 0.5, 3.0, 1.0000001, 65504.0, 3.3895314e38, -3.3895314e38],
            3.3895314e38 * rng.uniform(0.5, 1.0, size=296),
            rng.normal(size=296) * 1e-30,
        ]) * sign
    return np.asarray(x, np.float32)


def bits(a):
    return np.asarray(a).view(np.uint16)


@pytest.mark.parametrize("kind", ["normal", "subnormal_adjacent", "exact_bf16", "extremes"])
@pytest.mark.parametrize("terms", [2, 3])
def test_split_pieces_match_jax_bit_for_bit(terms, kind):
    x = split_inputs(kind, seed=terms * 10 + len(kind))
    jax_split = pallas_dense._split2 if terms == 2 else pallas_dense._split3
    want = jax_split(jnp.asarray(x))
    got = cuda_dense.split_pieces(torch.as_tensor(x), terms)
    assert len(got) == terms
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_array_equal(bits(g.view(torch.int16).numpy()), bits(w))


@pytest.mark.parametrize("terms", [2, 3])
def test_split_pieces_recover_x_to_the_split_order(terms):
    x = torch.as_tensor(split_inputs("normal", seed=5))
    total = sum(p.double() for p in cuda_dense.split_pieces(x, terms))
    rel = ((total - x.double()).abs() / x.double().abs()).max()
    assert float(rel) <= (2.0**-16 if terms == 2 else 2.0**-24)


def rel_max(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("nt", [False, True], ids=["nn_panel", "nt_syrk"])
@pytest.mark.parametrize("terms", [2, 3])
@pytest.mark.parametrize("shape", [(37, 20, 29), (64, 130, 48)], ids=["ragged", "k130"])
def test_plain_split_dots_match_jax(shape, terms, nt):
    m, k, n = shape
    rng = np.random.default_rng(m * terms + n)
    x = rng.normal(size=(m, k)).astype(np.float32)
    y = rng.normal(size=(n, k) if nt else (k, n)).astype(np.float32)
    dot = pallas_dense._dot_nt if nt else pallas_dense._dot_nn
    want = pallas_dense._split_dots(jnp.asarray(x), jnp.asarray(y), terms, dot)
    got = cuda_dense.plain_split_dots(torch.as_tensor(x), torch.as_tensor(y), terms, nt=nt)
    assert got.dtype == torch.float64 and got.shape == (m, n)
    assert rel_max(got.numpy(), want) <= 1e-6
    # And the split's own error against the exact product.
    exact = x.astype(np.float64) @ (y.astype(np.float64).T if nt else y.astype(np.float64))
    assert rel_max(got.numpy(), exact) <= (2.0**-16 * 4 if terms == 2 else 2.0**-24 * 4)


@pytest.mark.parametrize("terms", [2, 3])
@pytest.mark.parametrize("shape", [(100, 20), (128, 64), (200, 130)])
def test_split_pass_pads_the_pieces_on_the_cpu(shape, terms):
    """The split pass writes the three pieces; the first two are the
    2-term split."""
    rows, k = shape
    x = torch.as_tensor(np.random.default_rng(rows).normal(size=shape), dtype=torch.float32)
    out = cuda_dense.split_pass(x)
    rows_pad = -(-rows // cuda_dense.KERNEL_TILE) * cuda_dense.KERNEL_TILE
    k_pad = -(-k // cuda_dense.K_CHUNK) * cuda_dense.K_CHUNK
    assert out.shape == (3, rows_pad, k_pad) and out.dtype == torch.bfloat16
    for p, piece in enumerate(cuda_dense.split_pieces(x, terms)):
        assert torch.equal(out[p, :rows, :k].view(torch.int16), piece.view(torch.int16))
    assert not out[:, rows:].any() and not out[:, :, k:].any()
    # Through a transposed view, as B5 reads W^T.
    assert torch.equal(cuda_dense.split_pass(x.T.contiguous().T), out)


@pytest.mark.parametrize("nt", [1, 2, 7, 80, 300])
def test_lower_pair_enumerates_each_lower_pair_once_in_row_order(nt):
    pairs = [cuda_dense.lower_pair(g) for g in range(nt * (nt + 1) // 2)]
    assert pairs == [(i, j) for i in range(nt) for j in range(i + 1)]


def test_lower_pair_at_large_indices():
    for i in (4096, 46340, 65535):
        for j in (0, i // 2, i):
            assert cuda_dense.lower_pair(i * (i + 1) // 2 + j) == (i, j)


def integer_operands(m, b, seed):
    rng = np.random.default_rng(seed)
    T = torch.as_tensor(rng.integers(-50, 50, size=(m, m)), dtype=torch.float64)
    L = torch.as_tensor(rng.integers(-4, 5, size=(m, b)), dtype=torch.float64)
    return T, L


@pytest.mark.parametrize("lower_only", [False, True])
@pytest.mark.parametrize("kernel_tile", [128, 96])
@pytest.mark.parametrize("m,tile", [(320, 64), (384, 128), (512, 256)])
def test_plain_syrk_by_tiles_equals_plain_syrk_sub(m, tile, kernel_tile, lower_only):
    """Ragged against the kernel tile (m = 320 against 128; every m against
    96), with caller tiles of 64, 128 and 256."""
    T, L = integer_operands(m, 20, seed=m + kernel_tile)
    got = cuda_dense.plain_syrk_by_tiles(T, L, tile, lower_only, kernel_tile=kernel_tile)
    want = cuda_dense.plain_syrk_sub(T, L, tile, lower_only)
    assert torch.equal(got, want)
    if lower_only:
        blocks = torch.arange(m) // tile
        assert not got[blocks[None, :] > blocks[:, None]].any()


def test_plain_syrk_by_tiles_mirrors_a_non_symmetric_t():
    """T need not be symmetric: the mirrored tiles read T's own upper part."""
    T, L = integer_operands(200, 8, seed=3)
    T = T + 1000.0 * torch.triu(torch.ones_like(T), 1)
    got = cuda_dense.plain_syrk_by_tiles(T, L, 200, kernel_tile=64)
    assert torch.equal(got, T - L @ L.T)
