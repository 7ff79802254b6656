"""The serving forward's share of the card's dense bf16 peak, in %: the
configuration's forward FLOPs per frame (``perfbench.counts``, from
shapes) times the frames delivered in the window, over the window's
seconds and the peak."""

from perfbench import counts


def read(rec):
    peaks = counts.peaks(rec["device_name"])
    if "frames_delivered" not in rec or peaks is None or not rec["frames_delivered"]:
        return None
    flops = counts.forward_flops_per_sample(rec["config"]["model"]) * rec["frames_delivered"]
    return 100.0 * flops / rec["window_s"] / peaks["bf16_flops_per_s"]
