"""Built-in inference over GP hyperparameters: many-chain NUTS and HMC with
their diagnostics, mean-field and full-rank ADVI, and adaptive tempered
SMC.

Counterpart of ``tinygp_tpu/samplers``. The chains, ELBO draws and
particles run together on one leading axis, and each evaluation of the log
density covers all of them at once, so a quasiseparable GP's likelihood
takes one launch of each kernel for every chain (``hmc.py``), draw
(``vi.py``) or particle (``smc.py``).
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
    "fit_advi",
    "sample_advi",
    "run_smc",
    "HMCState",
    "HMCInfo",
    "WarmupInfo",
    "ADVIResult",
    "ADVIFullRankResult",
    "SMCResult",
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
from tinygp_tpu_torch.samplers.smc import SMCResult, run_smc
from tinygp_tpu_torch.samplers.vi import (
    ADVIFullRankResult,
    ADVIResult,
    fit_advi,
    sample_advi,
)
