"""The tiled kernel-matrix builder: kernel B7, its wrapper, its gate and its
plain version.

Counterpart of ``tinygp_tpu/ops/pallas_gram.py``. :func:`gram_tiled` builds
``K[i, j] = k(X1[i], X2[j])``; on a CUDA tensor it launches kernel B7
(``csrc/gram.cu``, float32), on a CPU tensor it runs :func:`plain_gram`.
Nothing falls back: a CUDA input that the gate refuses, or a failed build
or launch, raises.

The JAX builder traces any ``evaluate`` that Pallas lowers. CUDA cannot take
Python, so B7 is one evaluator for a closed set of nodes, and this module
compiles a kernel tree into its program on the host: a postfix list of
opcodes over a stack of at most :data:`MAX_STACK` values and at most
:data:`MAX_OPS` nodes, with the hyperparameters in one float32 vector on
the inputs' device (so a launch reads nothing back to the host, as the TPU
design passes its parameters as operands). The program depends only on
the tree's structure and is built once per structure; every call reads
the hyperparameters' current values into the vector. The set:

- the seven stationary leaves of :mod:`~tinygp_tpu_torch.kernels.stationary`
  (``Exp``, ``ExpSquared``, ``Matern32``, ``Matern52``, ``Cosine``,
  ``ExpSineSquared``, ``RationalQuadratic``), each with ``L1Distance`` or
  ``L2Distance``;
- ``Constant``, and ``Sum`` and ``Product`` of supported nodes;
- at the root only (nested roots too), the transforms ``Linear``,
  ``Cholesky`` and ``Subspace``: they map X1 and X2 once, in PyTorch, before
  the launch, as ``_Wrapped.evaluate`` does.

Nodes are matched by their exact class, so a subclass that overrides the
arithmetic is refused rather than evaluated as its parent. Inputs are
float32 tensors, ``(N,)`` or ``(N, d)``, on one device, with at most
:data:`MAX_D` features after the root transforms (B7 stages a tile's
points, all features, in shared memory); every hyperparameter is a 0-d
floating tensor, except a root transform's scale or factor, which may be
0-, 1- or 2-d.

Where the gate differs from the JAX package's ``supports_tiled_gram``:

- Float64 hyperparameters are accepted. The port stores Python numbers as
  float64 (``helpers.as_hyper``), where JAX keeps them weakly typed; either
  way every floating hyperparameter is cast to float32 for the kernel, as
  the JAX builder's ``prep`` does.
- Kernels the JAX gate accepts because Pallas can trace them are refused:
  ``DotProduct``, ``Polynomial``, ``Custom``, ``Transform`` with a callable,
  the quasiseparable kernels in a dense sum, ``Conditioned``, a transform
  below a ``Sum`` or ``Product``, and trees deeper than the stack.

The gradient is the JAX builder's ``custom_vjp``: the forward launches B7,
the backward is the vector-Jacobian product of :func:`plain_gram` recomputed
on the same inputs (B7 has no backward kernel, nor had the TPU). Cotangents
reach X1, X2 and every hyperparameter, each in its own dtype. The
hyperparameters are buffers, so they reach the ``torch.autograd.Function``
as explicit inputs. A second derivative raises. A call with nothing to
differentiate (gradients off, or no input or buffer that requires one)
launches B7 without the ``Function``.

Every launch adds one to ``LAUNCHES["gram"]``.
"""

from __future__ import annotations

__all__ = ["LAUNCHES", "MAX_OPS", "MAX_STACK", "MAX_D", "gram_tiled",
           "supports_tiled_gram", "plain_gram"]

import contextlib
import ctypes
import functools
from types import SimpleNamespace

import torch
from torch.autograd.function import once_differentiable

from tinygp_tpu_torch import cuda_build, transforms
from tinygp_tpu_torch.kernels import base, distance, stationary

LAUNCHES = {"gram": 0}
"""Launches of B7."""

MAX_OPS = 64
"""The most nodes a program holds (``kMaxOps`` in ``csrc/gram.cu``)."""
MAX_STACK = 8
"""The deepest stack a program may need (``kMaxStack``)."""
MAX_D = 64
"""The most features a point may have after the root transforms
(``kMaxD``: a tile's points, all features, sit in shared memory)."""

# Opcodes, as in csrc/gram.cu.
_CONST, _ADD, _MUL = 0, 1, 2
_LEAVES = {
    stationary.Exp: 3,
    stationary.ExpSquared: 4,
    stationary.Matern32: 5,
    stationary.Matern52: 6,
    stationary.Cosine: 7,
    stationary.ExpSineSquared: 8,
    stationary.RationalQuadratic: 9,
}
_SQUARED = {_LEAVES[stationary.ExpSquared], _LEAVES[stationary.RationalQuadratic]}
_EXTRA = {stationary.ExpSineSquared: "gamma", stationary.RationalQuadratic: "alpha"}
_TWO_PARAMS = {_LEAVES[kind] for kind in _EXTRA}
_METRICS = {distance.L1Distance: 0, distance.L2Distance: 1}
_ROOTS = {transforms.Linear: "scale", transforms.Cholesky: "factor", transforms.Subspace: None}


class _Program(ctypes.Structure):
    _fields_ = [
        ("n_ops", ctypes.c_int),
        ("n_params", ctypes.c_int),
        ("uses_l1", ctypes.c_int),
        ("uses_l2", ctypes.c_int),
        ("depth", ctypes.c_int),
        ("op", ctypes.c_int * MAX_OPS),
        ("metric", ctypes.c_int * MAX_OPS),
        ("param", ctypes.c_int * MAX_OPS),
        ("factor", ctypes.c_int * MAX_OPS),
    ]


def _fused(ops: tuple) -> list:
    """``ops`` with each product of a constant and a leaf, ``c * leaf`` or
    ``leaf * c``, made one op: ``(opcode, metric, parameter offset, the
    constant's offset)``, -1 where the op has no factor. The kernel
    multiplies the leaf's value by the factor, the same float32 product as
    the plain version's."""
    out, o = [], 0
    while o < len(ops):
        if o + 2 < len(ops) and ops[o + 2][0] == _MUL:
            a, b = ops[o], ops[o + 1]
            if a[0] == _CONST and b[0] > _MUL:
                a, b = b, a
            if a[0] > _MUL and b[0] == _CONST:
                out.append((*a, b[2]))
                o += 3
                continue
        out.append((*ops[o], -1))
        o += 1
    return out


@functools.cache
def _program(ops: tuple) -> _Program:
    """B7's program for the postfix list ``ops`` (a tuple of ``(opcode,
    metric, parameter offset)``), built once per tree structure: the ops
    with each constant factor of a leaf fused into it (:func:`_fused`), the
    parameter count, which sums the leaves read (an L2 distance reads the
    L1 sum at zero) and the deepest the stack gets, by which
    ``csrc/gram.cu`` picks its instantiation. Holds no hyperparameter
    value."""
    fused = _fused(ops)
    prog = _Program(n_ops=len(fused))
    prog.n_params = sum(2 if op in _TWO_PARAMS else 1 for op, _, _ in ops if op not in (_ADD, _MUL))
    sp = 0
    for o, (op, metric, offset, factor) in enumerate(fused):
        prog.op[o], prog.metric[o], prog.param[o], prog.factor[o] = op, metric, offset, factor
        if op in (_ADD, _MUL):
            sp -= 1
            continue
        sp += 1
        prog.depth = max(prog.depth, sp)
        if op != _CONST:
            prog.uses_l1 |= metric == 0 or op not in _SQUARED
            prog.uses_l2 |= metric == 1
    return prog


def _hyper(node, name: str) -> torch.Tensor:
    value = getattr(node, name)
    if not isinstance(value, torch.Tensor) or not value.is_floating_point() or value.ndim:
        raise ValueError(
            f"{type(node).__name__}.{name} must be a 0-d floating tensor for the tiled "
            "gram builder"
        )
    return value


def _tree(module) -> list:
    """The module and every module below it: ``nn.Module.modules()``
    without its names, de-duplication and generators, since every call
    walks it."""
    out, todo = [], [module]
    while todo:
        m = todo.pop()
        out.append(m)
        for child in m._modules.values():
            if child is not None:
                todo.append(child)
    return out


def _compile(kernel, X1, X2):
    """B7's program for ``kernel`` on these inputs: ``(roots, inner, ops,
    params, grad)`` with the root transforms (outermost first), the kernel
    below them, the postfix ``(opcode, metric, parameter offset)`` tuple,
    the hyperparameter tensors it reads and whether any buffer of the tree
    requires a gradient. Raises ``ValueError`` with the reason for anything
    B7 does not take."""
    for X in (X1, X2):
        if not isinstance(X, torch.Tensor):
            raise ValueError(f"inputs must be tensors; got {type(X).__name__}")
        if X.ndim not in (1, 2) or X.dtype != torch.float32:
            raise ValueError(
                f"inputs must be float32 of shape (N,) or (N, d); got {X.dtype} "
                f"{tuple(X.shape)}"
            )
    if X1.device != X2.device:
        raise ValueError(f"inputs on two devices: {X1.device} and {X2.device}")
    if X1.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no tiled gram builder for device {X1.device}")
    d1 = 1 if X1.ndim == 1 else X1.shape[1]
    d2 = 1 if X2.ndim == 1 else X2.shape[1]
    if d1 != d2:
        raise ValueError(f"inputs with {d1} and {d2} features")
    if not isinstance(kernel, base.Kernel):
        raise ValueError(f"not a kernel of the port: {type(kernel).__name__}")
    modules = _tree(kernel)
    if any(p is not None for m in modules for p in m._parameters.values()):
        raise ValueError("the tiled gram builder takes hyperparameters held as buffers")
    grad = any(b is not None and b.requires_grad for m in modules for b in m._buffers.values())

    roots, d = [], d1
    while type(kernel) in _ROOTS:
        name = _ROOTS[type(kernel)]
        if name is None:
            d = len(torch.as_tensor(kernel.axis).reshape(-1))
        else:
            value = getattr(kernel, name)
            if not value.is_floating_point() or value.ndim > 2:
                raise ValueError(
                    f"{type(kernel).__name__}.{name} must be a floating tensor of at most 2 "
                    "dimensions"
                )
            if value.ndim == 2 and isinstance(kernel, transforms.Linear):
                d = value.shape[0]
        roots.append(kernel)
        kernel = kernel.kernel
    if not 1 <= d <= MAX_D:
        raise ValueError(f"points of {d} features; the tiled gram builder takes 1 to {MAX_D}")

    ops, params = [], []
    depth = 0

    def push():
        nonlocal depth
        depth += 1
        if depth > MAX_STACK:
            raise ValueError(f"the kernel tree needs a stack deeper than {MAX_STACK}")

    def walk(node):
        nonlocal depth
        kind = type(node)
        if kind in (base.Sum, base.Product):
            walk(node.kernel1)
            walk(node.kernel2)
            ops.append((_ADD if kind is base.Sum else _MUL, 0, 0))
            depth -= 1
        elif kind is base.Constant:
            ops.append((_CONST, 0, len(params)))
            params.append(_hyper(node, "value"))
            push()
        elif kind in _LEAVES:
            metric = _METRICS.get(type(node.distance))
            if metric is None:
                raise ValueError(
                    f"{kind.__name__} with {type(node.distance).__name__}: the tiled gram "
                    "builder takes L1Distance or L2Distance"
                )
            ops.append((_LEAVES[kind], metric, len(params)))
            params.append(_hyper(node, "scale"))
            if kind in _EXTRA:
                params.append(_hyper(node, _EXTRA[kind]))
            push()
        else:
            where = " below the root" if kind in _ROOTS else ""
            raise ValueError(f"the tiled gram builder does not take {kind.__name__}{where}")
        if len(ops) > MAX_OPS:
            raise ValueError(f"the kernel tree has more than {MAX_OPS} nodes")

    walk(kernel)
    return roots, kernel, tuple(ops), params, grad


def supports_tiled_gram(kernel, X1, X2) -> bool:
    """Whether :func:`gram_tiled` takes this kernel and these inputs (see the
    module docstring for the set and how it differs from the JAX gate)."""
    try:
        _compile(kernel, X1, X2)
    except ValueError:
        return False
    return True


def _plain(kernel, buffers: dict[str, torch.Tensor], X1, X2) -> torch.Tensor:
    """``kernel(X1, X2)`` with ``buffers`` in place of its own, each floating
    one cast to float32."""
    cast = {n: b.to(torch.float32) if b.is_floating_point() else b for n, b in buffers.items()}
    return torch.func.functional_call(kernel, cast, (X1, X2))


def plain_gram(kernel, X1: torch.Tensor, X2: torch.Tensor) -> torch.Tensor:
    """B7's plain version: ``kernel(X1, X2)`` with every floating
    hyperparameter cast to float32 (root transforms included), the same
    arithmetic in the same type."""
    return _plain(kernel, dict(kernel.named_buffers()), X1, X2)


def _mapped(roots, X: torch.Tensor) -> torch.Tensor:
    """Points through the root transforms, outermost first, each with its
    hyperparameters in float32, exactly as ``_Wrapped.evaluate`` maps them."""
    X = X.unsqueeze(1) if X.ndim == 1 else X
    for node in roots:
        own = {n: b.to(torch.float32) for n, b in node.named_buffers(recurse=False)}
        X = type(node)._map(SimpleNamespace(axis=getattr(node, "axis", None), **own), X)
    return X


@functools.cache
def _library() -> ctypes.CDLL:
    """B7's library, built at first use, with its C signatures."""
    lib = cuda_build.library("gram")
    lib.gram_build.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.POINTER(_Program), ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_void_p,
    ]
    lib.gram_build.restype = ctypes.c_int
    lib.gram_error_string.argtypes = [ctypes.c_int]
    lib.gram_error_string.restype = ctypes.c_char_p
    for name, want in (("gram_max_ops", MAX_OPS), ("gram_max_stack", MAX_STACK),
                       ("gram_max_d", MAX_D)):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        if fn() != want:
            raise RuntimeError(f"csrc/gram.cu has {name}() = {fn()}, ops/gram.py {want}")
    return lib


def _param_vector(params, device: torch.device) -> torch.Tensor:
    """The hyperparameters' values now, in program order, as one float32
    vector on ``device``: one stack and one cast, nothing read back."""
    if any(p.device != device for p in params):
        params = [p.to(device) for p in params]
    return torch.stack(params).to(torch.float32)


def _launch(ops, params, P1: torch.Tensor, P2: torch.Tensor) -> torch.Tensor:
    """B7 on points ``(N, d)`` and ``(M, d)`` on one CUDA device."""
    n1, n2, d = P1.shape[0], P2.shape[0], P1.shape[1]
    out = P1.new_empty(n1, n2)
    if not n1 or not n2:
        return out
    prog = _program(ops)
    P1, P2 = P1.contiguous(), P2.contiguous()
    vec = _param_vector(params, P1.device)
    lib = _library()
    index = P1.device.index
    with contextlib.nullcontext() if index == torch.cuda.current_device() \
            else torch.cuda.device(index):
        err = lib.gram_build(P1.data_ptr(), n1, P2.data_ptr(), n2, d, ctypes.byref(prog),
                             vec.data_ptr(), out.data_ptr(), out.stride(0),
                             torch._C._cuda_getCurrentRawStream(index))
    if err:
        raise RuntimeError(
            f"gram kernel failed: {lib.gram_error_string(err).decode()} (cudaError {err})"
        )
    LAUNCHES["gram"] += 1
    return out


def _forward(kernel, ops, params, P1: torch.Tensor, P2: torch.Tensor) -> torch.Tensor:
    """B7 on a CUDA tensor, :func:`plain_gram` on a CPU tensor."""
    if P1.device.type == "cpu":
        return plain_gram(kernel, P1, P2)
    return _launch(ops, params, P1, P2)


class _GramTiled(torch.autograd.Function):
    """B7 (or on the CPU :func:`plain_gram`) forward; the vector-Jacobian
    product of :func:`plain_gram` backward, as the JAX ``custom_vjp``."""

    @staticmethod
    def forward(ctx, kernel, names, ops, params, P1, P2, *hypers):
        ctx.kernel, ctx.names = kernel, names
        ctx.save_for_backward(P1, P2, *hypers)
        return _forward(kernel, ops, params, P1, P2)

    @staticmethod
    @once_differentiable
    def backward(ctx, dK):
        P1, P2, *hypers = ctx.saved_tensors
        wants = ctx.needs_input_grad[4:]
        leaves = [t.detach().requires_grad_(w) for t, w in zip((P1, P2, *hypers), wants)]
        with torch.enable_grad():
            K = _plain(ctx.kernel, dict(zip(ctx.names, leaves[2:])), *leaves[:2])
            wanted = [t for t, w in zip(leaves, wants) if w]
            grads = iter(torch.autograd.grad(K, wanted, dK, allow_unused=True))
        # Each cotangent is in its input's own dtype (autograd's, through the cast).
        return (None, None, None, None, *(next(grads) if w else None for w in wants))


def gram_tiled(kernel, X1: torch.Tensor, X2: torch.Tensor, *, tile: int = 256) -> torch.Tensor:
    """``K[i, j] = k(X1[i], X2[j])``, ``(N, M)`` float32: kernel B7 on a CUDA
    tensor, :func:`plain_gram` on a CPU tensor.

    Raises ``ValueError``, on either device, for whatever
    :func:`supports_tiled_gram` refuses. ``tile`` is kept for parity with
    the JAX builder and must be a positive int; it changes no result and
    does not set B7's own tiling (tiles of 128 columns, the ragged edge
    masked, where ``pallas_gram.gram_tiled`` pads to whole tiles and
    slices). Its ``interpret`` has no counterpart: a CPU tensor runs the
    plain version.
    Differentiable in X1, X2 and every hyperparameter, once.
    """
    if isinstance(tile, bool) or not isinstance(tile, int) or tile < 1:
        raise ValueError(f"tile must be a positive int; got {tile!r}")
    roots, inner, ops, params, grad = _compile(kernel, X1, X2)
    # The root transforms run here, differentiably, so the Function sees the
    # inner tree on mapped points; its hyperparameters are explicit inputs.
    P1, P2 = _mapped(roots, X1), _mapped(roots, X2)
    if not (torch.is_grad_enabled() and (grad or X1.requires_grad or X2.requires_grad)):
        return _forward(inner, ops, params, P1, P2)  # nothing to differentiate
    named = dict(inner.named_buffers())
    return _GramTiled.apply(inner, tuple(named), ops, params, P1, P2, *named.values())
