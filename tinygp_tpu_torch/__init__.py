"""tinygp-tpu's port to PyTorch and CUDA for one NVIDIA H100.

A second package beside the JAX reference ``tinygp_tpu``, ported one slice
at a time (see ROADMAP.md). This slice carries the O(N) quasiseparable GP
marginal log-likelihood end to end: the quasiseparable kernels,
``GaussianProcess`` with ``log_probability``, and the fused log-likelihood
as a hand-written CUDA kernel for Hopper. Entry points run on the card
unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from tinygp_tpu_torch import (
    kernels as kernels,
    means as means,
    noise as noise,
    solvers as solvers,
)
from tinygp_tpu_torch.gp import GaussianProcess as GaussianProcess
