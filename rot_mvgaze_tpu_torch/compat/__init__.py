from rot_mvgaze_tpu_torch.compat.convert import load_checkpoint, state_dict_from_jax

__all__ = ["load_checkpoint", "state_dict_from_jax"]
