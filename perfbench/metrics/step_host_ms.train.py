"""Host milliseconds from calling the train step to its return, mean over
the window's steps (the harness's ``train_step`` span). Near the step's
whole time where the host paces the step; below it where the host runs
ahead of the card."""


def read(rec):
    spans = rec["spans"].seconds("train_step")
    return 1e3 * sum(spans) / len(spans) if spans else None
