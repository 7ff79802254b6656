"""Milliseconds of one coalesced micro-batch in the predictor, mean over
the window: the harness's span around each ``predict`` call that the
batching dispatcher makes (copy in, preprocessing, forward, copy out)."""


def read(rec):
    spans = rec["spans"].seconds("microbatch")
    return 1e3 * sum(spans) / len(spans) if spans else None
