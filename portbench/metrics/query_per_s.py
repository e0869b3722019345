"""query_per_s: queries answered within the window over its length."""


def read(run):
    if not hasattr(run.mix, "answered_in_window"):
        return None
    return run.mix.answered_in_window() / run.window_s
