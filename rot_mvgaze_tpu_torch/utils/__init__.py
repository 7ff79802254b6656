"""Shared utilities: seeding, meters, parameter summaries, device selection,
tracing and timing (the counterpart of ``rot_mvgaze_tpu/utils``)."""

from rot_mvgaze_tpu_torch.utils.helper import AverageMeter
from rot_mvgaze_tpu_torch.utils.profiling import StepTimer, device_memory_stats, trace
from rot_mvgaze_tpu_torch.utils.seed import set_seed
from rot_mvgaze_tpu_torch.utils.summary import count_parameters, parameter_table

__all__ = [
    "AverageMeter",
    "StepTimer",
    "count_parameters",
    "device_memory_stats",
    "parameter_table",
    "set_seed",
    "trace",
]
