"""Pytree checkpointing for long sampler runs.

Counterpart of ``tinygp_tpu/utils/checkpoint.py``'s single-host pair: a
sampler's state (chain positions, adaptation state, step counters) is a
pytree (:mod:`tinygp_tpu_torch.utils.tree`), saved atomically as an
``.npz`` of its leaves in order and restored against a template with shape
and dtype checks. The leaves' order is the JAX package's, so either
package reads the other's files. The sharded pair
(``save_pytree_sharded``, ``load_pytree_sharded``) waits for the port's
``parallel`` subpackage (ROADMAP L4).
"""

from __future__ import annotations

__all__ = ["save_pytree", "load_pytree"]

import os
import tempfile
from typing import Any

import numpy as np
import torch

from tinygp_tpu_torch.utils.tree import tree_flatten, tree_leaves, tree_unflatten


def _atomic_savez(path: str, arrays: dict[str, np.ndarray]) -> None:
    directory = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def _numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_pytree(path: str, tree: Any) -> None:
    """Atomically save a pytree of tensors, arrays and scalars to ``path``
    (.npz); tensors are copied to the host."""
    arrays = {f"leaf_{i}": _numpy(leaf) for i, leaf in enumerate(tree_leaves(tree))}
    _atomic_savez(path, arrays)


def load_pytree(path: str, like: Any) -> Any:
    """Load a pytree saved by :func:`save_pytree`.

    Args:
        path: The ``.npz`` path.
        like: A template pytree with the same structure, shapes and dtypes
            (e.g. the initial loop carry). Its leaf data is ignored; a
            tensor leaf comes back as a tensor on the template's device, in
            its dtype, any other leaf as a numpy array of its dtype.

    Returns:
        A pytree shaped like ``like`` with the stored values.
    """
    leaves, spec = tree_flatten(like)
    with np.load(path) as data:
        stored = [data[f"leaf_{i}"] for i in range(len(data.files))]
    if len(stored) != len(leaves):
        raise ValueError(
            f"checkpoint at {path!r} has {len(stored)} leaves; the template "
            f"has {len(leaves)}"
        )
    out = []
    for i, (new, old) in enumerate(zip(stored, leaves)):
        ref = _numpy(old)
        if new.shape != ref.shape:
            raise ValueError(
                f"checkpoint leaf {i} shape {new.shape} != template {ref.shape}"
            )
        new = new.astype(ref.dtype, copy=False)
        if isinstance(old, torch.Tensor):
            new = torch.from_numpy(np.array(new)).to(device=old.device, dtype=old.dtype)
        out.append(new)
    return tree_unflatten(spec, out)
