"""Utilities: the samplers' checkpoints (:mod:`.checkpoint`) and the small
pytree flatten they share (:mod:`.tree`).

Counterpart of ``tinygp_tpu/utils``; its ``module.py``, the JAX pytree
module system, is not ported (the port's models are ``nn.Module``\\s).
"""

from tinygp_tpu_torch.utils.checkpoint import (
    load_pytree as load_pytree,
    load_pytree_sharded as load_pytree_sharded,
    save_pytree as save_pytree,
    save_pytree_sharded as save_pytree_sharded,
)
