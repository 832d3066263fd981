"""``fit_map`` of the port: its trace against the JAX package's on a GP,
and the semantics tests of ``tests/test_fit.py`` in PyTorch's idiom."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinygp_tpu import GaussianProcess as JaxGP
from tinygp_tpu import fit_map as jax_fit_map
from tinygp_tpu.kernels import quasisep as jq
from tinygp_tpu_torch import GaussianProcess, fit_map
from tinygp_tpu_torch.kernels import quasisep as tq


def test_gp_fit_matches_jax():
    """exp(a) * Matern32(scale=exp(s)) with diag exp(b), 25 Adam steps in
    float64 from the same start: the loss traces agree step by step."""
    rng = np.random.default_rng(11)
    X = np.sort(rng.uniform(0, 8, 300))
    y = np.sin(1.3 * X) + 0.3 * rng.normal(size=300)
    init = {"a": 0.3, "s": 0.2, "b": -1.5}

    def jax_loss(p):
        kernel = jnp.exp(p["a"]) * jq.Matern32(scale=jnp.exp(p["s"]))
        gp = JaxGP(kernel, jnp.asarray(X), diag=jnp.exp(p["b"]), assume_sorted=True)
        return -gp.log_probability(jnp.asarray(y))

    Xt = torch.as_tensor(X)

    def torch_loss(p):
        kernel = torch.exp(p["a"]) * tq.Matern32(scale=torch.exp(p["s"]))
        gp = GaussianProcess(kernel, Xt, diag=torch.exp(p["b"]), assume_sorted=True, device="cpu")
        return -gp.log_probability(y)

    want = jax_fit_map(
        jax_loss, {k: jnp.asarray(v) for k, v in init.items()}, num_steps=25, learning_rate=0.05
    )
    got = fit_map(torch_loss, {k: np.float64(v) for k, v in init.items()},
                  num_steps=25, learning_rate=0.05, device="cpu")
    assert got.losses.shape == (25,) and got.losses.dtype == torch.float64
    np.testing.assert_allclose(got.losses.numpy(), np.asarray(want.losses), rtol=1e-6, atol=0)
    np.testing.assert_allclose(float(got.loss), float(want.loss), rtol=1e-6)
    for name in init:
        np.testing.assert_allclose(float(got.params[name]), float(want.params[name]), rtol=1e-6, atol=1e-9)
    assert float(got.loss) < float(got.losses[0])
    assert got.converged == bool(want.converged)


def test_quadratic_exact():
    target = {"a": torch.tensor([1.0, -2.0], dtype=torch.float64),
              "b": torch.tensor(3.0, dtype=torch.float64)}

    def loss(p):
        return torch.sum((p["a"] - target["a"]) ** 2) + (p["b"] - target["b"]) ** 2

    init = {"a": torch.zeros(2, dtype=torch.float64), "b": 0.0}
    res = fit_map(loss, init, num_steps=800, learning_rate=0.1, device="cpu")
    assert float(res.loss) < 1e-6
    np.testing.assert_allclose(res.params["a"].numpy(), [1.0, -2.0], atol=1e-3)
    assert res.converged
    assert res.losses.shape == (800,)
    # The starting values are copied, not updated.
    assert torch.equal(init["a"], torch.zeros(2, dtype=torch.float64))


def test_nonfinite_excursions_do_not_win():
    # loss = -log(x) + x for x > 0; negative x gives nan. A hot learning
    # rate from near zero overshoots into the invalid region.
    res = fit_map(lambda p: -torch.log(p["x"]) + p["x"], {"x": 0.05},
                  num_steps=200, learning_rate=0.5, device="cpu")
    assert np.isfinite(float(res.loss))
    assert float(res.loss) >= 1.0 - 1e-5  # min of x - log x is 1 at x=1


def test_custom_optimizer():
    res = fit_map(lambda p: torch.sum(p["x"] ** 2), {"x": torch.ones(3, dtype=torch.float64)},
                  optimizer=lambda ps: torch.optim.SGD(ps, lr=0.2), num_steps=100, device="cpu")
    assert float(res.loss) < 1e-4


class LeaveThenFreeze(torch.optim.Optimizer):
    """Descends for 50 steps, jumps by +10 on step 50, then stands still."""

    def __init__(self, params):
        super().__init__(params, {})
        self.count = 0

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if self.count < 50:
                    p.add_(p.grad, alpha=-0.2)
                elif self.count == 50:
                    p.add_(10.0)
        self.count += 1


def test_flat_but_diverged_tail_not_converged():
    # A trajectory that leaves its optimum and then sits flat at a much
    # worse loss must not report converged.
    res = fit_map(lambda p: torch.sum(p["x"] ** 2), {"x": torch.tensor([1.0], dtype=torch.float64)},
                  optimizer=LeaveThenFreeze, num_steps=200, device="cpu")
    assert float(res.loss) < 1e-3  # best tracked from the descent phase
    assert float(res.losses[-1]) > 50.0  # the tail is far from the best
    assert not res.converged


def test_rising_tail_not_converged():
    # Divergent SGD: the losses rise, so the per-step drops are negative.
    res = fit_map(lambda p: torch.sum(p["x"] ** 2), {"x": torch.tensor([1.0], dtype=torch.float64)},
                  optimizer=lambda ps: torch.optim.SGD(ps, lr=1.5), num_steps=100, device="cpu")
    assert not res.converged


def test_fit_defaults_to_the_card(monkeypatch):
    """Like every entry point, fit_map runs on the card unless asked for the
    CPU: without CUDA, device=None raises instead of running elsewhere."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fit_map(lambda p: p["x"] ** 2, {"x": np.float64(1.0)}, num_steps=2)


def test_fit_puts_every_start_on_its_device_and_dtype():
    seen = []

    def loss(p):
        seen.append({k: (v.device, v.dtype) for k, v in p.items()})
        return p["a"] ** 2 + torch.sum(p["b"] ** 2) + p["c"] ** 2

    init = {"a": 1.0, "b": np.ones(2, np.float32), "c": torch.tensor(2.0, dtype=torch.float64)}
    res = fit_map(loss, init, num_steps=3, device="cpu", dtype=torch.float32)
    want = (torch.device("cpu"), torch.float32)
    assert all(v == want for step in seen for v in step.values())
    assert all((v.device, v.dtype) == want for v in res.params.values())
    assert res.loss.dtype == torch.float32
    # Without a dtype each start keeps its own (float64 for numbers).
    res = fit_map(loss, init, num_steps=2, device="cpu")
    assert {k: v.dtype for k, v in res.params.items()} == {
        "a": torch.float64, "b": torch.float32, "c": torch.float64}
