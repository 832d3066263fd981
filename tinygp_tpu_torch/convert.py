"""Carry a kernel's hyperparameters across from the JAX package.

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
"""

from __future__ import annotations

__all__ = ["kernel_from_tree"]

from typing import Any

import torch

from tinygp_tpu_torch.helpers import as_tensor, resolve_device
from tinygp_tpu_torch.kernels import quasisep


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
