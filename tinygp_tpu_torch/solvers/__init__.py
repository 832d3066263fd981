"""Linear-algebra backends for GP computations: the dense
:class:`DirectSolver` and the O(N) :class:`QuasisepSolver` with its
quasiseparable matrix algebra (``solvers.quasisep``). The Kalman and
low-rank solvers are ROADMAP item L2."""

__all__ = ["DirectSolver", "QuasisepSolver"]

from tinygp_tpu_torch.solvers.direct import DirectSolver
from tinygp_tpu_torch.solvers.quasisep import QuasisepSolver
