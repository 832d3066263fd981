"""The chain-batched log density and its gradient at m = 5
(``SHO + Matern52``, the generic-order route, launched once for each chain
on the card), against the JAX package as ``test_torch_samplers_chains.py``
holds the m <= 4 models, and the once-differentiable rule under
``torch.func``."""

import numpy as np
import pytest
import torch

from test_torch_samplers_chains import check_batched_value_and_grad, log_densities, positions


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_batched_value_and_grad_matches_jax(dtype):
    check_batched_value_and_grad("sho_matern52", dtype)


def test_gradient_is_once_differentiable():
    """``create_graph=True`` raises, as before; ``torch.func.grad`` does not,
    and a second derivative through it raises."""
    _, tlp = log_densities("sho", np.float64)
    z = torch.as_tensor(positions(np.float64)[0])
    g = torch.func.grad(tlp)(z)
    assert torch.isfinite(g).all()
    zr = z.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="once differentiable"):
        torch.autograd.grad(tlp(zr), zr, create_graph=True)
    with pytest.raises(RuntimeError, match="once differentiable"):
        torch.func.grad(lambda x: torch.func.grad(tlp)(x)[0])(z)
