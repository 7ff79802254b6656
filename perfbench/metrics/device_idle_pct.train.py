"""The share of the traced window, in %, in which no kernel, copy or fill
ran on the card: one minus the union of the device's activity intervals
over the window."""


def read(rec):
    trace = rec["trace"]
    if not trace["window_s"] or not trace["busy_s"]:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
