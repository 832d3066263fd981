"""dtype-aware testing assertions.

Counterpart of ``tinygp_tpu/test_utils.py``, with its own copy of the
tolerance table: 5e-4 for float32 and 5e-7 for float64, keyed on the least
precise operand; and generators of well-conditioned random operands and
quasiseparable matrices, as numpy arrays that both packages take.
"""

from __future__ import annotations

__all__ = [
    "assert_allclose",
    "assert_pytrees_allclose",
    "random_qsm_operands",
    "random_qsm_tree",
]

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


def assert_pytrees_allclose(calculated: Any, expected: Any, **kwargs: Any) -> None:
    """:func:`assert_allclose` leaf by leaf over nested dicts, lists and
    tuples of the same structure (the JAX package's pytrees)."""
    if isinstance(expected, dict):
        assert isinstance(calculated, dict) and calculated.keys() == expected.keys(), (
            f"dict keys differ: {calculated!r} vs {expected!r}"
        )
        for key in expected:
            assert_pytrees_allclose(calculated[key], expected[key], **kwargs)
    elif isinstance(expected, list | tuple):
        assert isinstance(calculated, type(expected)) and len(calculated) == len(expected), (
            f"sequences differ: {calculated!r} vs {expected!r}"
        )
        for c, e in zip(calculated, expected):
            assert_pytrees_allclose(c, e, **kwargs)
    else:
        assert_allclose(calculated, expected, **kwargs)


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


def _tree(name: str, **fields: Any) -> dict[str, Any]:
    """A QSM tree as :func:`tinygp_tpu_torch.convert.qsm_from_tree` takes
    it: arrays under ``params``, sub-matrices under ``children``."""
    return {
        "class": name,
        "params": {k: v for k, v in fields.items() if not isinstance(v, dict)},
        "children": {k: v for k, v in fields.items() if isinstance(v, dict)},
    }


def _row_major(m: int, n: int, seed: int):
    """``(d, p, q, a)`` of a positive definite symmetric QSM in the row-major
    layout: ``(N,)``, ``(N, m)``, ``(N, m)``, ``(N, m, m)``."""
    d, ps, qs, as_, _ = random_qsm_operands(m, n, seed)
    return d, ps.T.copy(), qs.T.copy(), as_.T.reshape(n, m, m).copy()


def random_qsm_tree(name: str, n: int, m: int, seed: int) -> dict[str, Any]:
    """A well-conditioned random order-``m`` QSM of the class ``name``, as a
    tree of float64 numpy arrays (see :mod:`tinygp_tpu_torch.convert`).

    The symmetric matrices are positive definite
    (:func:`random_qsm_operands`); the strict triangles are their lower
    parts; the triangular matrices are their Cholesky factors; a
    ``SquareQSM`` is ``D + L1 + L2^T`` with ``D = (D1 + D2) / 2`` for two
    such matrices ``K_i = D_i + L_i + L_i^T``: a positive definite matrix
    plus a skew-symmetric one, so elimination without pivoting is stable.
    """
    d, p, q, a = _row_major(m, n, seed)
    if name == "DiagQSM":
        return _tree(name, d=d)
    if name in ("StrictLowerTriQSM", "StrictUpperTriQSM"):
        return _tree(name, p=p, q=q, a=a)
    if name == "SymmQSM":
        return _tree(
            name, diag=_tree("DiagQSM", d=d), lower=_tree("StrictLowerTriQSM", p=p, q=q, a=a)
        )
    if name in ("LowerTriQSM", "UpperTriQSM"):
        # The Cholesky factor by the sequential Riccati recurrence.
        F = np.zeros((m, m))
        c, w = np.empty(n), np.empty((n, m))
        for k in range(n):
            Fp = F @ p[k]
            c2 = d[k] - p[k] @ Fp
            u = q[k] - a[k] @ Fp
            c[k], w[k] = np.sqrt(c2), u / np.sqrt(c2)
            F = a[k] @ F @ a[k].T + np.outer(u, u) / c2
        part = "lower" if name == "LowerTriQSM" else "upper"
        strict = "StrictLowerTriQSM" if part == "lower" else "StrictUpperTriQSM"
        return _tree(name, diag=_tree("DiagQSM", d=c), **{part: _tree(strict, p=p, q=w, a=a)})
    if name == "SquareQSM":
        d2, p2, q2, a2 = _row_major(m, n, seed + 1)
        return _tree(
            name,
            diag=_tree("DiagQSM", d=0.5 * (d + d2)),
            lower=_tree("StrictLowerTriQSM", p=p, q=q, a=a),
            upper=_tree("StrictUpperTriQSM", p=p2, q=q2, a=a2),
        )
    raise ValueError(f"no quasiseparable matrix class named {name!r}")
