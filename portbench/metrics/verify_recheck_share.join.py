"""verify_recheck_share: the outputs that the ``tc`` verify route
recomputed in float32 because their d² fell inside its re-check band
(the ``pairs`` of the window's ``verify.rechecks`` instants, one a join,
which the join records while tracing) over the live outputs that the
window's joins computed, in per cent.

The kernel computes, and may recompute, every output of a lane: an edge's
lane holds its live pairs (``pairs_verified`` counts them), a bucket's
lane against itself the whole square of its s live rows, of which
``pairs_verified`` counts the upper triangle, s(s - 1)/2, so each join
adds s(s + 1)/2 a bucket of two rows or more (every bucket is touched
once a join). Pad rows are never recomputed. None where the program
records no such instant."""
import numpy as np


def read(run):
    steps = getattr(run.mix, "steps", None) or ()
    marks = [e for e in run.events
             if e.get("ph") == "i" and e.get("name") == "verify.rechecks"]
    if not marks or not steps or run.sizes is None:
        return None
    s = np.asarray(run.sizes, np.int64)
    square = int((s[s >= 2] * (s[s >= 2] + 1) // 2).sum())
    computed = sum(st["pairs_verified"] for st in steps) + len(steps) * square
    if not computed:
        return None
    return 100.0 * sum(e["args"]["pairs"] for e in marks) / computed
