"""Frames per coalesced micro-batch: the frames answered over the change
in the predictor's ``micro_batches_run`` across the window."""


def read(rec):
    if not rec.get("microbatches"):
        return None
    return rec["frames"] / rec["microbatches"]
