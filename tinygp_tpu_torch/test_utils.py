"""dtype-aware testing assertions.

Counterpart of ``tinygp_tpu/test_utils.py``, with its own copy of the
tolerance table: 5e-4 for float32 and 5e-7 for float64, keyed on the least
precise operand.
"""

from __future__ import annotations

__all__ = ["assert_allclose", "random_qsm_operands"]

from typing import Any

import numpy as np
import torch

_TOL = {
    "bfloat16": 1e-2,
    "float16": 1e-2,
    "float32": 5e-4,
    "float64": 5e-7,
}


def _numpy(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _tolerance(*arrays: Any) -> float:
    """The table's tolerance for the least precise of ``arrays``."""
    names = [
        str(a.dtype).removeprefix("torch.")
        if isinstance(a, torch.Tensor)
        else np.dtype(np.asarray(a).dtype).name
        for a in arrays
    ]
    return max((_TOL[n] for n in names if n in _TOL), default=5e-4)


def assert_allclose(calculated: Any, expected: Any, **kwargs: Any) -> None:
    tol = _tolerance(calculated, expected)
    atol = kwargs.pop("atol", tol)
    rtol = kwargs.pop("rtol", tol)
    np.testing.assert_allclose(
        _numpy(calculated).astype(np.float64),
        _numpy(expected).astype(np.float64),
        atol=atol,
        rtol=rtol,
        **kwargs,
    )


def random_qsm_operands(
    m: int, n: int, seed: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Random stacked operands ``(d, ps, qs, as_, y)`` of a positive
    definite ``K = diag(d) + tril(p, q, a) + tril^T``, float64.

    They are the covariance of ``h_k^T x_k`` plus noise for a random
    time-varying state-space model whose state covariance stays the
    identity: ``x_k = a_k x_{k-1} + w_k`` with ``||a_k||_2 <= 0.95`` and
    ``Cov(w_k) = I - a_k a_k^T``. So ``q_k = h_k``, ``p_k = a_k^T h_k`` and
    ``d_k = h_k^T h_k + sigma_k^2`` with ``sigma_k^2 >= 0.5``, which bounds
    every Cholesky pivot below by 0.5 at any N. (Transitions drawn near the
    identity without a norm bound make K indefinite after a few hundred
    points.)
    """
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(n, m, m))
    g /= np.linalg.norm(g, axis=(1, 2), keepdims=True)
    a = 0.95 * (0.7 * np.eye(m) + 0.3 * g)
    h = rng.normal(size=(n, m)) / np.sqrt(m)
    p = np.einsum("nji,nj->ni", a, h)
    d = np.sum(h * h, axis=1) + rng.uniform(0.5, 1.0, n)
    y = rng.normal(size=n)
    return d, p.T.copy(), h.T.copy(), a.reshape(n, m * m).T.copy(), y
