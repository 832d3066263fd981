"""tinygp-tpu's port to PyTorch and CUDA for one NVIDIA H100.

A second package beside the JAX reference ``tinygp_tpu``, ported one slice
at a time (see ROADMAP.md). It carries the O(N) quasiseparable GP
marginal log-likelihood and its gradient end to end: the quasiseparable
kernels, ``GaussianProcess`` with ``log_probability``, the fused
log-likelihood and its backward as hand-written CUDA kernels for Hopper,
and ``fit_map``, which fits hyperparameters with them. Entry points run on
the card unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from tinygp_tpu_torch import (
    kernels as kernels,
    means as means,
    noise as noise,
    solvers as solvers,
)
from tinygp_tpu_torch.fit import FitResult as FitResult, fit_map as fit_map
from tinygp_tpu_torch.gp import GaussianProcess as GaussianProcess
