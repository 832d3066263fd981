"""Multi-device parallelism over ``torch.distributed``.

Counterpart of ``tinygp_tpu/parallel``. Where the JAX package runs one
process over many devices and shards with ``shard_map``, the port runs one
process per device: :func:`initialize_distributed` joins the processes'
group (NCCL on the card, gloo on the CPU; ``torchrun`` sets what it reads),
:func:`make_mesh` lays a named
:class:`~torch.distributed.device_mesh.DeviceMesh` over it, and each
function here runs on every rank: the sharded samplers
(:mod:`.sharded`), the sequence-parallel scans and log-likelihoods
(:mod:`.scan`) and the tensor-parallel dense Cholesky (:mod:`.dense`).
Their collectives, and their adjoints, are in :mod:`.mesh`.
"""

__all__ = [
    "make_mesh",
    "chain_axis",
    "data_axis",
    "local_chunk",
    "initialize_distributed",
    "run_mcmc_sharded",
    "run_smc_sharded",
    "cholesky_tp",
]

from tinygp_tpu_torch.parallel.dense import cholesky_tp
from tinygp_tpu_torch.parallel.mesh import (
    chain_axis,
    data_axis,
    initialize_distributed,
    local_chunk,
    make_mesh,
)
from tinygp_tpu_torch.parallel.sharded import run_mcmc_sharded, run_smc_sharded
