"""Carry a kernel's hyperparameters, or a quasiseparable matrix, across
from the JAX package.

The port never sees a JAX object. A kernel is described as a nested
dictionary of numpy arrays::

    {"class": "Scale",
     "params": {"scale": np.ndarray},
     "children": {"kernel": {"class": "Matern32", ...}}}

where ``class`` names a class of :mod:`tinygp_tpu_torch.kernels.quasisep`,
``params`` its hyperparameters and ``children`` its wrapped kernels, each
under the name of its constructor argument (``kernel``, or ``kernel1`` and
``kernel2``). A caller with the JAX package at hand builds it by walking
the JAX kernel's dataclass fields.

A quasiseparable matrix is described the same way, with the class names
of :mod:`tinygp_tpu_torch.solvers.quasisep.core` and their field names::

    {"class": "SymmQSM",
     "children": {"diag": {"class": "DiagQSM", "params": {"d": ...}},
                  "lower": {"class": "StrictLowerTriQSM",
                            "params": {"p": ..., "q": ..., "a": ...}}}}

with the JAX package's layout (``(N, m)`` generators, ``(N, m, m)``
transitions), which the port keeps.
"""

from __future__ import annotations

__all__ = ["kernel_from_tree", "qsm_from_tree"]

from typing import Any

import torch

from tinygp_tpu_torch.helpers import as_tensor, resolve_device
from tinygp_tpu_torch.kernels import quasisep
from tinygp_tpu_torch.solvers.quasisep import core


def kernel_from_tree(
    tree: dict[str, Any],
    *,
    device: Any = None,
    dtype: torch.dtype = torch.float64,
) -> quasisep.Quasisep:
    """The port's kernel for ``tree``, its hyperparameters on ``device``
    (``None`` is ``"cuda"``) in ``dtype``."""
    device = resolve_device(device)
    name = tree["class"]
    if name not in quasisep.__all__:
        raise ValueError(f"no quasiseparable kernel named {name!r} in the port")
    params = {
        k: as_tensor(v, device, dtype) for k, v in tree.get("params", {}).items()
    }
    children = {
        k: kernel_from_tree(v, device=device, dtype=dtype)
        for k, v in tree.get("children", {}).items()
    }
    return getattr(quasisep, name)(**children, **params)


def qsm_from_tree(
    tree: dict[str, Any],
    *,
    device: Any = None,
    dtype: torch.dtype = torch.float64,
) -> core.QSM:
    """The port's QSM for ``tree``, its arrays on ``device`` (``None`` is
    ``"cuda"``) in ``dtype``."""
    device = resolve_device(device)
    name = tree["class"]
    if name not in core.__all__ or name == "QSM":
        raise ValueError(f"no quasiseparable matrix class named {name!r} in the port")
    fields = {k: as_tensor(v, device, dtype) for k, v in tree.get("params", {}).items()}
    for k, v in tree.get("children", {}).items():
        fields[k] = qsm_from_tree(v, device=device, dtype=dtype)
    return getattr(core, name)(**fields)
