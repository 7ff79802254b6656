from rot_mvgaze_tpu_torch.compat.convert import (
    checkpoint_state_dict,
    load_checkpoint,
    read_checkpoint,
    state_dict_from_jax,
)

__all__ = ["checkpoint_state_dict", "load_checkpoint", "read_checkpoint", "state_dict_from_jax"]
