"""The training step's share of the card's dense bf16 peak, in %: the
configuration's FLOPs per step (``perfbench.counts``, from shapes) times
the window's steps, over the window's seconds and the peak."""

from perfbench import counts


def read(rec):
    peaks = counts.peaks(rec["device_name"])
    if "steps" not in rec or peaks is None or not rec["steps"]:
        return None
    flops = counts.train_flops_per_sample(rec["config"]["model"]) * rec["traffic"]["pairs"] * rec["steps"]
    return 100.0 * flops / rec["window_s"] / peaks["bf16_flops_per_s"]
