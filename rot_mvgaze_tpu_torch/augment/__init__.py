from rot_mvgaze_tpu_torch.augment.ops import (
    color_jitter,
    eval_preprocess,
    normalize,
    random_affine,
    random_multi_erasing,
    to_float,
    train_preprocess,
)

__all__ = [
    "color_jitter",
    "eval_preprocess",
    "normalize",
    "random_affine",
    "random_multi_erasing",
    "to_float",
    "train_preprocess",
]
