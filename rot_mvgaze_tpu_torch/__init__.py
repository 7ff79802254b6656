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
backward; and the training runtime around the step, single process: the
data tier (``data``), the step's options, evaluation (``evaluate``),
checkpoints and ``train.Trainer``; the command line, the model family;
and the single-card serving and export surface (the antialiased resize,
every ablation and the V-view model behind ``serving``, int8 serving in
``ops.quant``, ``torch.export`` artifacts in ``export``); data parallelism
and device meshes (``parallel``); and the protocol commands
(``reference_parity``, the four-protocol table; ``pairing_sensitivity``;
``probe_ema_benefit``) with the reference's conv block library
(``models.blocks``) and the profiling helpers (``utils``).
"""
