"""Transient read-error handling: capped exponential backoff + retry.

SSDs (and striped arrays of them) throw transient ``OSError``/``IOError``
— a timeout, a momentary EIO on one stripe. Before this module, any such
error aborted the whole join; now every store read path (sync
``BucketCache``, ``SchedulePrefetcher`` workers, the index's pooled
query reads, the distributed join's padded reads) retries up to
``JoinConfig.io_retries`` times, sleeping ``backoff_s · 2^attempt``
(capped) between attempts. Exhausted retries re-raise the last error —
permanent failures still fail fast, just not on the first blip.

Counters land in ``PipelineStats``: ``io_read_errors`` counts failed
attempts, ``io_retries`` counts re-issues (retries ≤ errors: the final
attempt of a permanent failure errors without a retry following it).
"""
from __future__ import annotations

import time

BACKOFF_CAP_MULT = 50  # cap the exponential at 50× the base backoff


def read_with_retry(fn, *, retries: int, backoff_s: float, stats=None):
    """Call ``fn()``, retrying transient ``OSError`` up to ``retries``
    times with capped exponential backoff. Returns ``fn``'s result or
    re-raises the last error."""
    attempt = 0
    while True:
        try:
            return fn()
        except OSError:
            if stats is not None:
                stats.add("io_read_errors", 1)
            if attempt >= retries:
                raise
            delay = min(backoff_s * (2 ** attempt),
                        backoff_s * BACKOFF_CAP_MULT)
            if delay > 0:
                time.sleep(delay)
            attempt += 1
            if stats is not None:
                stats.add("io_retries", 1)
