"""The collective traffic of a step: the counterpart of the JAX package's
``launch/hlo_analysis.py::collective_bytes``.

The reference parses the collective ops of a compiled program's post-SPMD
HLO; the port's mesh tallies every collective it issues instead
(``launch/mesh.py``, ``Mesh.tally``: one entry per op with its kind, group
size, payload bytes and dtype). The traffic model is the reference's, term
for term (the roofline's collective term divides it by a link's rate):

  all-gather        : output bytes × (n−1)/n     (ring; ≈ output bytes)
  reduce-scatter    : input  bytes × (n−1)/n
  all-reduce        : 2 × bytes × (n−1)/n        (reduce-scatter + all-gather)
  all-to-all        : bytes × (n−1)/n
  collective-permute: bytes                      (point-to-point)

An entry's ``bytes`` is the payload the term names: the gathered output of
an all-gather, the input of a reduce-scatter, the tensor otherwise. Each
op's traffic is truncated to an integer, as the reference's parser does.
(The reference's parser reads every op's bytes from its result type, which
for a reduce-scatter is the scattered output, n times less than its own
docstring's input; the port follows the docstring.)
"""
from __future__ import annotations

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def op_traffic(kind: str, nbytes: int, n: int) -> int:
    """Bytes one rank moves for one op of ``kind`` over ``n`` ranks."""
    frac = (n - 1) / n if n > 1 else 0.0
    if kind == "all-reduce":
        return int(2 * nbytes * frac)
    if kind == "collective-permute":
        return int(nbytes)
    return int(nbytes * frac)


def collective_bytes(tally: list[dict], default_group: int = 256) -> dict:
    """→ {kind: {'count', 'bytes', 'traffic_bytes'}, 'total_traffic_bytes'},
    the reference's keys; an entry without a group size takes
    ``default_group``."""
    out: dict = {k: {"count": 0, "bytes": 0, "traffic_bytes": 0}
                 for k in COLLECTIVES}
    for e in tally:
        rec = out[e["kind"]]
        rec["count"] += 1
        rec["bytes"] += int(e["bytes"])
        rec["traffic_bytes"] += op_traffic(e["kind"], int(e["bytes"]),
                                           int(e.get("n", default_group)))
    out["total_traffic_bytes"] = int(
        sum(v["traffic_bytes"] for v in out.values() if isinstance(v, dict)))
    return out
