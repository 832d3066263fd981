"""Shared helpers: device resolution, tensor coercion and the float32
product precision.

Counterpart of ``tinygp_tpu/helpers.py``. The JAX package pins the
precision of its contractions (``pdot``, ``Precision.HIGHEST``) because
the TPU demotes float32 products by default. PyTorch runs float32 products
in full float32 by default, but a caller may turn TF32 on globally
(``torch.set_float32_matmul_precision("high")``), which on an H100 broke
the dense gradient's and posterior's limits (ROADMAP.md, C5). So the
port's entry points run under :func:`full_float32` (:func:`pinned`), which
restores the caller's setting on return. Their gradients are pinned too:
:func:`pin_backward` makes the backward pass that reaches an entry point's
outputs run in full float32 from there on.
"""

from __future__ import annotations

__all__ = [
    "resolve_device",
    "as_tensor",
    "as_hyper",
    "full_float32",
    "pinned",
    "pin_backward",
    "mapped_module",
]

import contextlib
import copy
import functools
from collections.abc import Callable, Iterator
from typing import Any, TypeVar

import numpy as np
import torch
from torch import nn

_F = TypeVar("_F", bound=Callable[..., Any])


@contextlib.contextmanager
def full_float32() -> Iterator[None]:
    """Float32 matrix products in full float32 inside the block (TF32 off,
    precision ``"highest"``), whatever the caller set; the caller's
    setting is restored on exit. A no-op under PyTorch's defaults."""
    precision = torch.get_float32_matmul_precision()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    if precision == "highest" and not tf32:
        yield
        return
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(precision)
        torch.backends.cuda.matmul.allow_tf32 = tf32


def pinned(fn: _F) -> _F:
    """``fn`` run under :func:`full_float32`."""

    @functools.wraps(fn)
    def wrapper(*args: Any, **kwargs: Any) -> Any:
        with full_float32():
            return fn(*args, **kwargs)

    return wrapper  # type: ignore[return-value]


class _Restore:
    """The caller's product setting, put back once: when the backward pass
    that pinned it ends (an autograd engine callback), or, if a node of
    that pass raises and the engine drops its callbacks unrun, when the
    engine releases this one."""

    def __init__(self) -> None:
        self.saved = (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32)

    def __call__(self) -> None:
        if self.saved is None:
            return
        precision, tf32 = self.saved
        self.saved = None
        torch.set_float32_matmul_precision(precision)
        torch.backends.cuda.matmul.allow_tf32 = tf32

    def __del__(self) -> None:
        self()


def _pin_rest_of_backward(grad_outputs: Any) -> None:
    """A node pre-hook: full float32 products from here to the end of the
    running backward pass, then the caller's setting again."""
    restore = _Restore()
    if restore.saved == ("highest", False):
        restore.saved = None
        return
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.autograd.Variable._execution_engine.queue_callback(restore)


def pin_backward(x: torch.Tensor) -> torch.Tensor:
    """``x``, its backward node made to turn TF32 off for the rest of the
    backward pass that reaches it.

    An entry point's outputs pass through it, so that every product its
    graph recorded (einsums, ``matmul`` s, solves, ``torch.linalg``'s own
    backwards) runs its backward in full float32 whatever the caller set,
    as its forward does under :func:`pinned`: the backward reaches that
    graph only through the outputs. The caller's setting is back when the
    pass ends, also when it ends by an error. Under ``torch.func``
    transforms it does nothing (the samplers pin their whole evaluation)."""
    if x.grad_fn is not None and not torch._C._are_functorch_transforms_active():
        x.grad_fn.register_prehook(_pin_rest_of_backward)
    return x


def resolve_device(device: Any = None) -> torch.device:
    """The device an entry point runs on: the card unless asked otherwise.

    ``None`` means ``"cuda"``. A CUDA device without a usable CUDA runtime
    raises ``RuntimeError`` rather than quietly running on the CPU; callers
    that want the CPU pass ``device="cpu"``.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this host; pass device='cpu' to run "
            "the plain PyTorch path on the CPU"
        )
    return device


def as_tensor(
    value: Any, device: torch.device, dtype: torch.dtype
) -> torch.Tensor:
    """A number, numpy array or tensor as a tensor on ``device`` in
    ``dtype`` (a tensor already there is returned as it is, so autograd
    history survives)."""
    return as_hyper(value).to(device=device, dtype=dtype)


def as_hyper(value: Any) -> torch.Tensor:
    """A hyperparameter as a tensor. Python numbers become float64 so that
    no precision is lost before the process casts to its own dtype."""
    if isinstance(value, torch.Tensor):
        return value
    if isinstance(value, np.ndarray | np.generic):
        return torch.tensor(value)
    return torch.tensor(value, dtype=torch.float64)


def mapped_module(module: nn.Module, fn: Callable[[torch.Tensor], torch.Tensor]) -> nn.Module:
    """A copy of ``module`` with ``fn`` applied to each floating tensor it
    holds (its parameters and buffers, and its submodules' in turn). The
    copy has its own buffers and submodules, so ``module`` is unchanged;
    ``fn``'s autograd history stays on the copy's tensors, whose parameters
    become buffers."""
    out = copy.copy(module)
    tensors = {**module._parameters, **module._buffers}
    out._parameters = {}
    out._buffers = {
        k: fn(v) if v is not None and v.is_floating_point() else v for k, v in tensors.items()
    }
    out._modules = {
        k: None if v is None else mapped_module(v, fn) for k, v in module._modules.items()
    }
    return out
