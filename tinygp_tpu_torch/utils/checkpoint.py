"""Pytree checkpointing for long sampler runs.

Counterpart of ``tinygp_tpu/utils/checkpoint.py``'s single-host pair: a
sampler's state (chain positions, adaptation state, step counters) is a
pytree (:mod:`tinygp_tpu_torch.utils.tree`), saved atomically as an
``.npz`` of its leaves in order and restored against a template with shape
and dtype checks. The leaves' order is the JAX package's, so either
package reads the other's files.

The sharded pair (:func:`save_pytree_sharded`, :func:`load_pytree_sharded`)
writes one file per rank of a ``torch.distributed`` group. A sharded leaf
is a :class:`~torch.distributed.tensor.DTensor` (the counterpart of a JAX
array spread over processes): a rank stores its block and the block's
global offset. The files hold the JAX package's keys.
"""

from __future__ import annotations

__all__ = ["save_pytree", "load_pytree", "save_pytree_sharded", "load_pytree_sharded"]

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
    return tree_unflatten(spec, [_restored(i, new, old) for i, (new, old) in
                                 enumerate(zip(stored, leaves))])


def _restored(i: int, new: np.ndarray, old: Any) -> Any:
    """Stored leaf ``i`` in the template leaf's type, device and dtype."""
    ref = _numpy(old)
    if new.shape != ref.shape:
        raise ValueError(f"checkpoint leaf {i} shape {new.shape} != template {ref.shape}")
    new = new.astype(ref.dtype, copy=False)
    if isinstance(old, torch.Tensor):
        new = torch.from_numpy(np.array(new)).to(device=old.device, dtype=old.dtype)
    return new


def _proc_path(path: str, rank: int) -> str:
    return f"{path}.proc{rank}.npz"


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def _global_offset(leaf: Any) -> list[int]:
    """Where a :class:`DTensor`'s local block starts in the global tensor:
    each ``Shard(dim)`` placement adds the rank's coordinate on that mesh
    dimension times the block's extent (even shards)."""
    local = leaf.to_local()
    offset = [0] * local.ndim
    coordinate = leaf.device_mesh.get_coordinate()
    for mesh_dim, placement in enumerate(leaf.placements):
        if placement.is_shard():
            offset[placement.dim] += coordinate[mesh_dim] * local.shape[placement.dim]
    return offset


def save_pytree_sharded(path: str, tree: Any) -> None:
    """Save a pytree whose leaves may be sharded over a group's ranks.

    Each rank writes one ``{path}.proc{rank}.npz`` atomically, holding, per
    leaf, its block of a sharded (:class:`DTensor`) leaf with the block's
    global offset, and any other leaf whole: redundant but
    self-contained, so any one file restores the replicated state.
    """
    from torch.distributed.tensor import DTensor

    arrays: dict[str, np.ndarray] = {}
    for i, leaf in enumerate(tree_leaves(tree)):
        if isinstance(leaf, DTensor):
            arrays[f"leaf_{i}_shard_0"] = _numpy(leaf.to_local())
            arrays[f"leaf_{i}_shard_0_at"] = np.asarray(_global_offset(leaf), np.int64)
        else:
            arrays[f"leaf_{i}"] = _numpy(leaf)
    _atomic_savez(_proc_path(path, _rank()), arrays)


def load_pytree_sharded(path: str, like: Any) -> Any:
    """Restore a :func:`save_pytree_sharded` checkpoint from this rank's
    own file.

    ``like`` gives the structure, shapes and dtypes and, for a sharded
    leaf, its mesh and placements: the block comes back as a
    :class:`DTensor` laid out like the template's. A block stored at
    another offset (another mesh or layout) or with another shape raises
    ``ValueError``.
    """
    from torch.distributed.tensor import DTensor

    leaves, spec = tree_flatten(like)
    out = []
    with np.load(_proc_path(path, _rank())) as data:
        for i, tmpl in enumerate(leaves):
            if not isinstance(tmpl, DTensor):
                out.append(_restored(i, data[f"leaf_{i}"], tmpl))
                continue
            at = [int(v) for v in data[f"leaf_{i}_shard_0_at"]]
            want = _global_offset(tmpl)
            if at != want:
                raise ValueError(
                    f"checkpoint shard layout changed for leaf {i}: stored offset {at}, "
                    f"expected {want}; restore with the same mesh and placements"
                )
            block = _restored(i, data[f"leaf_{i}_shard_0"], tmpl.to_local())
            out.append(DTensor.from_local(block, tmpl.device_mesh, tmpl.placements,
                                          run_check=False))
    return tree_unflatten(spec, out)
