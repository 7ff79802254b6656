"""Train-mode BatchNorm's share of its roofline, in %: the least time of
every BatchNorm op of the window's steps (its bytes at the card's peak
bandwidth; ``perfbench.counts``: forward reads x and the residual and
writes y, backward reads x, dy and, after a residual sum with ReLU, y, and
writes dx and d-residual), over the profiler's device time of the kernels
those ops launch."""

from perfbench import counts

KERNELS = ("bn_stats_kernel", "bn_stats_finish_kernel", "bn_apply_kernel", "bn_bwd_reduce_kernel",
           "bn_bwd_finish_kernel", "bn_bwd_dx_kernel")
ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def read(rec):
    peaks = counts.peaks(rec["device_name"])
    if "steps" not in rec or peaks is None:
        return None
    seconds = sum(v for name, v in rec["trace"]["kernel_seconds"].items() if any(k in name for k in KERNELS))
    if seconds <= 0:
        return None
    model = rec["config"]["model"]
    nbytes = counts.bn_train_bytes_per_sample(model, ITEMSIZE[model["dtype"]]) * rec["traffic"]["pairs"] * rec["steps"]
    return 100.0 * nbytes / peaks["hbm_bytes_per_s"] / seconds
