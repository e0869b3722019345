"""join_order_s: the time in ``join.order`` spans (Gorder: the node
order ``DiskJoinIndex._order_for`` computes on a cache miss, as every
fresh session does), over the window's joins."""
from portbench.spantime import per_join_s


def read(run):
    return per_join_s(run, "join.order")
