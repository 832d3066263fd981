"""Built-in inference over GP hyperparameters: many-chain NUTS and HMC with
their diagnostics.

Counterpart of ``tinygp_tpu/samplers``. The chains run together on one
leading axis, and each leapfrog step evaluates the log density and its
gradient for all of them at once, so a quasiseparable GP's likelihood takes
one launch of each kernel for every chain (``hmc.py``). Mean-field ADVI
(``vi.py``) and tempered SMC (``smc.py``) are still to port (ROADMAP.md,
queue A).
"""

__all__ = [
    "hmc",
    "nuts",
    "run_mcmc",
    "window_adaptation",
    "find_initial_step_size",
    "potential_scale_reduction",
    "effective_sample_size",
    "summary",
    "HMCState",
    "HMCInfo",
    "WarmupInfo",
]

from tinygp_tpu_torch.samplers.diagnostics import (
    effective_sample_size,
    potential_scale_reduction,
    summary,
)
from tinygp_tpu_torch.samplers.hmc import (
    HMCInfo,
    HMCState,
    WarmupInfo,
    find_initial_step_size,
    hmc,
    nuts,
    run_mcmc,
    window_adaptation,
)
