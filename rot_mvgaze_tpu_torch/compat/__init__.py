from rot_mvgaze_tpu_torch.compat.convert import (
    checkpoint_state_dict,
    is_jax_tree,
    load_checkpoint,
    read_checkpoint,
    state_dict_from_jax,
    state_from_jax,
)
from rot_mvgaze_tpu_torch.compat.pretrained import load_pretrained_backbone

__all__ = [
    "checkpoint_state_dict",
    "is_jax_tree",
    "load_checkpoint",
    "load_pretrained_backbone",
    "read_checkpoint",
    "state_dict_from_jax",
    "state_from_jax",
]
