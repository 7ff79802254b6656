"""PyTorch / CUDA port of ``rot_mvgaze_tpu`` for NVIDIA Hopper (H100).

The layout mirrors the JAX package so that each module's counterpart is easy
to find. The port imports ``torch`` and numpy only: nothing of JAX and
nothing of the JAX package. Entry points run on the card (``device="cuda"``)
unless the caller asks for the CPU; on the CPU every kernel wrapper takes its
plain PyTorch version.

Slices covered so far: the two-view serving path (``serving``, ``serve``) of
``FeatRotationSymm`` in eval mode, with the rotate + concat + GEMM + ReLU
fuser as a hand-written CUDA kernel (``ops.fusion``, ``csrc/fusion.cu``); and
the stereo training step (``train.make_train_step``: augmentation, the train
forward, ``losses``, Adam), with train-mode BatchNorm as four hand-written
CUDA kernels (``ops.batchnorm``, ``csrc/batchnorm.cu``) and the fuser's
backward.
"""
