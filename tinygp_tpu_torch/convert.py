"""Carry a kernel's hyperparameters, or a quasiseparable matrix, across
from the JAX package.

The port never sees a JAX object. A kernel is described as a nested
dictionary of numpy arrays::

    {"class": "Scale",
     "params": {"scale": np.ndarray},
     "children": {"kernel": {"class": "Matern32", ...}}}

where ``class`` names a class, ``params`` its hyperparameters, ``children``
its wrapped kernels or distance, each under the name of its constructor
argument (``kernel``, ``kernel1`` and ``kernel2``, ``distance``), and an
optional ``static`` its other constructor arguments, passed unchanged
(``Subspace``'s ``axis``; ``Custom``'s and ``Transform``'s callables, which
the caller writes for PyTorch). A bare class name is looked up in
:mod:`~tinygp_tpu_torch.kernels.quasisep` first; a qualified one names the
module: ``quasisep.Matern32``, ``stationary.Matern32``, ``base.Product``,
``distance.L2Distance`` or ``transforms.Linear``, the last part of the JAX
class's module and its name. A caller with the JAX package at hand builds
the tree by walking the JAX kernel's dataclass fields.

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

from tinygp_tpu_torch import transforms
from tinygp_tpu_torch.helpers import as_tensor, resolve_device
from tinygp_tpu_torch.kernels import base, distance, quasisep, stationary
from tinygp_tpu_torch.solvers.quasisep import core

_MODULES = {
    "quasisep": quasisep,
    "base": base,
    "stationary": stationary,
    "distance": distance,
    "transforms": transforms,
}


def _kernel_class(name: str) -> type:
    """The port's class for a bare or module-qualified class name."""
    module, _, cls = name.rpartition(".")
    if module:
        found = _MODULES.get(module)
        if found is not None and cls in found.__all__:
            return getattr(found, cls)
    else:
        for found in _MODULES.values():
            if cls in found.__all__:
                return getattr(found, cls)
    raise ValueError(f"no kernel, distance or transform named {name!r} in the port")


def kernel_from_tree(
    tree: dict[str, Any],
    *,
    device: Any = None,
    dtype: torch.dtype = torch.float64,
) -> base.Kernel | distance.Distance:
    """The port's kernel (or distance) for ``tree``, its hyperparameters on
    ``device`` (``None`` is ``"cuda"``) in ``dtype``."""
    device = resolve_device(device)
    cls = _kernel_class(tree["class"])
    # Fields a class computes from its other hyperparameters (CARMA's roots
    # and masks) are recomputed, not carried.
    derived = getattr(cls, "_derived", ())
    params = {
        k: as_tensor(v, device, dtype)
        for k, v in tree.get("params", {}).items()
        if k not in derived
    }
    children = {
        k: kernel_from_tree(v, device=device, dtype=dtype)
        for k, v in tree.get("children", {}).items()
    }
    return cls(**children, **params, **tree.get("static", {}))


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
