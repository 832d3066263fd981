"""Stationary kernels defined through a distance metric.

Counterpart of ``tinygp_tpu/kernels/stationary.py``: the
:class:`Stationary` base with a scalar ``scale`` and a pluggable
``distance``, and Exp, ExpSquared, Matern32, Matern52, Cosine,
ExpSineSquared and RationalQuadratic. Each is written in terms of the
scaled distance ``r`` between broadcast points (feature axis last, see
:mod:`~tinygp_tpu_torch.kernels.base`).
"""

from __future__ import annotations

__all__ = [
    "Stationary",
    "Exp",
    "ExpSquared",
    "Matern32",
    "Matern52",
    "Cosine",
    "ExpSineSquared",
    "RationalQuadratic",
]

import math
from typing import Any

import torch

from tinygp_tpu_torch.helpers import as_hyper
from tinygp_tpu_torch.kernels.base import Kernel
from tinygp_tpu_torch.kernels.distance import Distance, L1Distance, L2Distance


def _require(value: Any, kernel: str, name: str) -> Any:
    """Fail construction loudly when a no-default parameter was omitted."""
    if value is None:
        raise ValueError(f"{kernel} needs its required `{name}` parameter")
    return value


class Stationary(Kernel):
    """Base class of the isotropic stationary kernels.

    Args:
        scale: A *scalar* length scale in the units of ``distance``. For
            anisotropic length scales wrap the kernel in
            :class:`tinygp_tpu_torch.transforms.Linear` or
            :class:`tinygp_tpu_torch.transforms.Cholesky`.
        distance: The distance metric; L1 by default, L2 for
            :class:`ExpSquared` (:class:`RationalQuadratic` keeps L1, as
            the JAX package's code does).
    """

    _default_distance = L1Distance

    def __init__(self, scale: Any = 1.0, distance: Distance | None = None):
        super().__init__()
        self.register_buffer("scale", as_hyper(scale))
        self.distance = self._default_distance() if distance is None else distance

    def profile(self, r: torch.Tensor) -> torch.Tensor:
        """The radial profile ``k(r)``; most subclasses implement only this.

        Kernels that are cheaper (or gradient-safer) in the *squared*
        distance override :meth:`evaluate` directly instead.
        """
        raise NotImplementedError

    def evaluate(self, X1: torch.Tensor, X2: torch.Tensor) -> torch.Tensor:
        return self.profile(self._r(X1, X2))

    def _check_scale(self) -> None:
        if self.scale.ndim:
            raise ValueError(
                "stationary kernels take a single scalar length scale; "
                "per-dimension scales are spelled as input transforms "
                "(transforms.Linear / transforms.Cholesky)"
            )

    def _r(self, X1: torch.Tensor, X2: torch.Tensor) -> torch.Tensor:
        self._check_scale()
        return self.distance.distance(X1, X2) / self.scale

    def _r2(self, X1: torch.Tensor, X2: torch.Tensor) -> torch.Tensor:
        self._check_scale()
        return self.distance.squared_distance(X1, X2) / torch.square(self.scale)


class Exp(Stationary):
    r""":math:`k(r) = \exp(-r)` with :math:`r` the (scaled) L1 distance."""

    def profile(self, r: torch.Tensor) -> torch.Tensor:
        return torch.exp(-r)


class ExpSquared(Stationary):
    r""":math:`k(r) = \exp(-r^2/2)` (RBF); L2 distance by default."""

    _default_distance = L2Distance

    def evaluate(self, X1: torch.Tensor, X2: torch.Tensor) -> torch.Tensor:
        return torch.exp(-0.5 * self._r2(X1, X2))


class Matern32(Stationary):
    r""":math:`k(r) = (1+\sqrt{3}r)\exp(-\sqrt{3}r)`."""

    def profile(self, r: torch.Tensor) -> torch.Tensor:
        arg = math.sqrt(3.0) * r
        return (1.0 + arg) * torch.exp(-arg)


class Matern52(Stationary):
    r""":math:`k(r) = (1+\sqrt{5}r+5r^2/3)\exp(-\sqrt{5}r)`."""

    def profile(self, r: torch.Tensor) -> torch.Tensor:
        arg = math.sqrt(5.0) * r
        return (1.0 + arg + torch.square(arg) / 3.0) * torch.exp(-arg)


class Cosine(Stationary):
    r""":math:`k(r) = \cos(2\pi r)` with period ``scale``."""

    def profile(self, r: torch.Tensor) -> torch.Tensor:
        return torch.cos(2.0 * math.pi * r)


class ExpSineSquared(Stationary):
    r"""The quasiperiodic kernel :math:`k(r) = \exp(-\Gamma \sin^2 \pi r)`.

    Args:
        scale: The period :math:`P`.
        gamma: The required parameter :math:`\Gamma`.
    """

    def __init__(
        self, scale: Any = 1.0, distance: Distance | None = None, gamma: Any = None
    ):
        super().__init__(scale, distance)
        self.register_buffer("gamma", as_hyper(_require(gamma, "ExpSineSquared", "gamma")))

    def profile(self, r: torch.Tensor) -> torch.Tensor:
        s = torch.sin(math.pi * r)
        return torch.exp(-self.gamma * s * s)


class RationalQuadratic(Stationary):
    r""":math:`k(r) = (1 + r^2/2\alpha)^{-\alpha}`.

    Args:
        scale: The length scale :math:`\ell`.
        alpha: The required parameter :math:`\alpha`.
    """

    def __init__(
        self, scale: Any = 1.0, distance: Distance | None = None, alpha: Any = None
    ):
        super().__init__(scale, distance)
        self.register_buffer(
            "alpha", as_hyper(_require(alpha, "RationalQuadratic", "alpha"))
        )

    def evaluate(self, X1: torch.Tensor, X2: torch.Tensor) -> torch.Tensor:
        a = self.alpha
        return torch.pow(1.0 + self._r2(X1, X2) / (2.0 * a), -a)
