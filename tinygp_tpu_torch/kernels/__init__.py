"""Kernel building blocks: compose sums and products of these, or subclass
:class:`Kernel` with a custom ``evaluate``. The quasiseparable family lives
under :mod:`~tinygp_tpu_torch.kernels.quasisep` (its ``Matern32`` is not
the dense one exported here), as in the JAX package."""

__all__ = [
    "quasisep",
    "Distance",
    "L1Distance",
    "L2Distance",
    "Kernel",
    "Conditioned",
    "Custom",
    "Sum",
    "Product",
    "Constant",
    "DotProduct",
    "Polynomial",
    "Stationary",
    "Exp",
    "ExpSquared",
    "Matern32",
    "Matern52",
    "Cosine",
    "ExpSineSquared",
    "RationalQuadratic",
]

from tinygp_tpu_torch.kernels import quasisep
from tinygp_tpu_torch.kernels.base import (
    Conditioned,
    Constant,
    Custom,
    DotProduct,
    Kernel,
    Polynomial,
    Product,
    Sum,
)
from tinygp_tpu_torch.kernels.distance import Distance, L1Distance, L2Distance
from tinygp_tpu_torch.kernels.stationary import (
    Cosine,
    Exp,
    ExpSineSquared,
    ExpSquared,
    Matern32,
    Matern52,
    RationalQuadratic,
    Stationary,
)
