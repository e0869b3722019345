"""join_s: the window's length over the whole joins completed in it (the
window closes when the first join ends at or after ``--seconds``)."""


def read(run):
    steps = getattr(run.mix, "steps", None)
    return run.window_s / len(steps) if steps else None
