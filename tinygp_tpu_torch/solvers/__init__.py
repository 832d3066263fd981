"""Linear-algebra backends for GP computations.

- :class:`DirectSolver`: the exact dense Cholesky (any kernel).
- :class:`QuasisepSolver`: the O(N) solver for quasiseparable kernels,
  with its quasiseparable matrix algebra (``solvers.quasisep``).
- :class:`KalmanSolver`: an O(N) likelihood-only oracle by Kalman filtering.
- :class:`LowRankSolver`: the FITC/Nystrom inducing-point approximation for
  dense kernels at large N, O(N M^2), exact within the approximate prior.
"""

__all__ = [
    "DirectSolver",
    "QuasisepSolver",
    "KalmanSolver",
    "LowRankSolver",
]

from tinygp_tpu_torch.solvers.direct import DirectSolver
from tinygp_tpu_torch.solvers.kalman import KalmanSolver
from tinygp_tpu_torch.solvers.lowrank import LowRankSolver
from tinygp_tpu_torch.solvers.quasisep import QuasisepSolver
