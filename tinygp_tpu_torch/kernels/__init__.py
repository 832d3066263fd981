"""Kernel building blocks. This slice of the port carries the base class and
the quasiseparable family."""

__all__ = ["quasisep", "Kernel"]

from tinygp_tpu_torch.kernels import quasisep
from tinygp_tpu_torch.kernels.base import Kernel
