"""reads_per_query: bucket reads of the queries (``PipelineStats``
``query_reads`` + ``query_fallback_reads``) over the window's answered
queries; probe sharing lowers it."""


def read(run):
    mix = run.mix
    if not hasattr(mix, "reads") or mix.pipe1 is None:
        return None
    n = len(mix.answered())
    return mix.reads() / n if n else None
