"""The port's entry points run their float32 products in full float32
whatever the caller set globally (``tinygp_tpu_torch.helpers.full_float32``,
the counterpart of the JAX package's precision-pinned ``pdot``), and give
the caller's setting back. The limits this protects are checked on the card
with TF32 on (``chip_smoke.py``, ``phase_tf32``)."""

import numpy as np
import pytest
import torch

from tinygp_tpu_torch import GaussianProcess, fit_map, kernels
from tinygp_tpu_torch.helpers import full_float32, pinned
from tinygp_tpu_torch.ops import dense


@pytest.fixture
def tf32_on():
    saved = torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32
    torch.set_float32_matmul_precision("high")
    torch.backends.cuda.matmul.allow_tf32 = True
    yield
    torch.set_float32_matmul_precision(saved[0])
    torch.backends.cuda.matmul.allow_tf32 = saved[1]


def setting():
    return torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32


def test_full_float32_pins_and_restores(tf32_on):
    assert setting() == ("high", True)
    with full_float32():
        assert setting() == ("highest", False)
        with full_float32():
            assert setting() == ("highest", False)
        assert setting() == ("highest", False)
    assert setting() == ("high", True)
    with pytest.raises(ValueError), full_float32():
        raise ValueError
    assert setting() == ("high", True)


def test_defaults_are_left_alone():
    assert setting() == ("highest", False)
    assert pinned(setting)() == ("highest", False)
    assert setting() == ("highest", False)


class Recording(kernels.Matern32):
    """Matern32 that records the product precision each evaluation saw."""

    seen: list = []

    def evaluate(self, X1, X2):
        Recording.seen.append(setting())
        return super().evaluate(X1, X2)


@pytest.mark.parametrize("entry", ["log_probability", "condition", "predict", "sample", "fit"])
def test_entry_points_run_in_full_float32(tf32_on, entry):
    rng = np.random.default_rng(0)
    X = torch.tensor(np.sort(rng.uniform(0, 5, 40)), dtype=torch.float32)
    y = torch.tensor(rng.normal(size=40), dtype=torch.float32)
    Recording.seen = []
    gp = GaussianProcess(Recording(scale=1.5), X, diag=0.1, device="cpu")
    if entry == "log_probability":
        out = gp.log_probability(y)
    elif entry == "condition":
        out = gp.condition(y)[1].variance
    elif entry == "predict":
        out = gp.predict(y, X[:7] + 0.05, return_var=True)[1]
    elif entry == "sample":
        out = gp.sample(torch.Generator().manual_seed(0), (3,))
    else:
        def loss(p):
            return -GaussianProcess(
                Recording(scale=torch.exp(p["log_scale"])), X, diag=0.1, device="cpu"
            ).log_probability(y)

        out = fit_map(loss, {"log_scale": 0.3}, num_steps=2, device="cpu",
                      dtype=torch.float32).loss
    assert torch.isfinite(torch.as_tensor(out)).all()
    assert Recording.seen and set(Recording.seen) == {("highest", False)}
    assert setting() == ("high", True)


def test_dense_ops_run_in_full_float32(tf32_on, monkeypatch):
    seen = []
    real = dense._native_cholesky

    def recording(K):
        seen.append(setting())
        return real(K)

    monkeypatch.setattr(dense, "_native_cholesky", recording)
    rng = np.random.default_rng(1)
    A = torch.tensor(rng.normal(size=(30, 30)), dtype=torch.float32)
    K = A @ A.T / 30 + torch.eye(30)
    dense.cholesky_with_fallback(K)
    dense.blocked_cholesky(K, min_size=0, block=8)
    assert seen and set(seen) == {("highest", False)}
    assert setting() == ("high", True)


class _RecordSetting(torch.autograd.Function):
    """The identity, recording the product setting its backward runs under."""

    seen: list = []

    @staticmethod
    def forward(x):
        return x.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, grad):
        _RecordSetting.seen.append(setting())
        return grad


def _entry_output(entry, scale):
    """An entry point's output for a process whose scale passes through
    ``scale``'s graph."""
    from tinygp_tpu_torch.kernels import quasisep

    rng = np.random.default_rng(0)
    X = np.sort(rng.uniform(0, 10, 50))
    y = rng.normal(size=50)
    gp = GaussianProcess(quasisep.Matern32(scale=scale), X, diag=0.1, device="cpu")
    if entry == "log_probability":
        return gp.log_probability(y)
    if entry == "predict":
        return sum(torch.sum(v) for v in gp.predict(y, X[::5], return_var=True))
    return gp.condition(y).log_probability


@pytest.mark.parametrize("entry", ["log_probability", "predict", "condition"])
def test_entry_point_backwards_run_in_full_float32(tf32_on, entry):
    """A gradient taken from an entry point's outputs runs the products its
    graph recorded in full float32 (``helpers.pin_backward``), and the
    caller's setting is back when the backward pass ends."""
    scale = torch.tensor(1.5, dtype=torch.float64, requires_grad=True)
    _RecordSetting.seen.clear()
    out = _entry_output(entry, _RecordSetting.apply(scale))
    assert setting() == ("high", True)
    out.backward()
    assert _RecordSetting.seen == [("highest", False)]
    assert setting() == ("high", True)
    assert scale.grad is not None


class _RaiseInBackward(torch.autograd.Function):
    """The identity, whose backward raises."""

    @staticmethod
    def forward(x):
        return x.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, grad):
        raise RuntimeError("refused in the backward")


@pytest.mark.parametrize("entry", ["log_probability", "predict", "condition"])
def test_entry_point_backward_restores_the_setting_when_it_raises(tf32_on, entry):
    """A backward pass that raises below an entry point's output (as a
    refused reverse launch does) still gives the caller's setting back,
    and the next backward pass is pinned again."""
    scale = torch.tensor(1.5, dtype=torch.float64, requires_grad=True)
    out = _entry_output(entry, _RaiseInBackward.apply(scale))
    with pytest.raises(RuntimeError, match="refused in the backward"):
        out.backward()
    assert setting() == ("high", True)

    _RecordSetting.seen.clear()
    _entry_output(entry, _RecordSetting.apply(scale)).backward()
    assert _RecordSetting.seen == [("highest", False)]
    assert setting() == ("high", True)
