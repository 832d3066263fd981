"""tinygp-tpu's port to PyTorch and CUDA for one NVIDIA H100.

A second package beside the JAX reference ``tinygp_tpu``, ported one slice
at a time (see ROADMAP.md). It carries ``GaussianProcess`` with
``log_probability`` (and its gradient), ``condition``, ``predict`` and
``sample`` on two paths: the O(N) quasiseparable solver, whose fused
log-likelihood, backward and monoid scans are hand-written CUDA kernels for
Hopper, and the dense solver for the stationary kernels, whose blocked
Cholesky runs its panel and trailing products as CUDA kernels too; and
``fit_map``, which fits hyperparameters with either. Entry points run on
the card unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

import torch as _torch

# On some CPU hosts (torch 2.13, 8 OpenMP threads) the first multithreaded
# float32 ``torch.exp`` of a process returns one thread's chunk about 1.5e-4
# off (9 of 40 fresh processes); one single-threaded call first avoids it
# (0 of 40). tests/test_torch_float32_grain.py probes it.
_torch.exp(_torch.zeros(16))

from tinygp_tpu_torch import (
    kernels as kernels,
    means as means,
    noise as noise,
    solvers as solvers,
    transforms as transforms,
)
from tinygp_tpu_torch.fit import FitResult as FitResult, fit_map as fit_map
from tinygp_tpu_torch.gp import (
    ConditionResult as ConditionResult,
    GaussianProcess as GaussianProcess,
)
