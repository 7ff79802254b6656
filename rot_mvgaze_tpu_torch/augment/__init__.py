from rot_mvgaze_tpu_torch.augment.ops import eval_preprocess, normalize, to_float

__all__ = ["eval_preprocess", "normalize", "to_float"]
