"""query_p95_ms: the 95th percentile of submit → answer, client side,
over every answered query the window sent."""
from portbench.readers import latency_pct_ms


def read(run):
    return latency_pct_ms(run, 95)
