"""I/O accounting: every byte that crosses the storage boundary is recorded.

The paper's Fig. 16 reports *total* vs *useful* disk traffic; the ratio is
read amplification. We track both so the same table can be produced from any
store implementation (bucketed or per-vector).

Thread safety: the prefetching I/O subsystem (``repro.io``) issues bucket
reads from a worker pool while the executor thread accounts verify-side
traffic, so all mutation goes through one lock. The lock is uncontended in
sync mode (single thread) and cheap relative to a page-sized read.
"""
from __future__ import annotations

import dataclasses
import threading
import time


PAGE_SIZE = 4096  # bytes — minimum granularity of a disk read (paper §1)


@dataclasses.dataclass
class IOStats:
    """Mutable I/O counters shared by a store and its readers."""

    read_ops: int = 0
    write_ops: int = 0
    bytes_read_total: int = 0      # page-granular traffic (what the disk does)
    bytes_read_useful: int = 0     # bytes the caller actually consumes
    bytes_written_total: int = 0
    bytes_written_useful: int = 0
    read_seconds: float = 0.0
    write_seconds: float = 0.0

    def __post_init__(self) -> None:
        self._lock = threading.Lock()

    def record_read(self, useful: int, *, page_aligned: bool = True) -> None:
        total = _page_round(useful) if page_aligned else useful
        with self._lock:
            self.read_ops += 1
            self.bytes_read_total += total
            self.bytes_read_useful += useful

    def record_reads(self, count: int, bytes_each: int, *,
                     page_aligned: bool = True) -> None:
        """Account ``count`` same-sized reads in one locked update (a row
        gather is one call instead of O(n) ``record_read`` calls)."""
        if count <= 0:
            return
        each = _page_round(bytes_each) if page_aligned else bytes_each
        with self._lock:
            self.read_ops += count
            self.bytes_read_total += count * each
            self.bytes_read_useful += count * bytes_each

    def record_write(self, useful: int, *, page_aligned: bool = True) -> None:
        total = _page_round(useful) if page_aligned else useful
        with self._lock:
            self.write_ops += 1
            self.bytes_written_total += total
            self.bytes_written_useful += useful

    def add_seconds(self, field: str, dt: float) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + dt)

    @property
    def read_amplification(self) -> float:
        return _amplification(self.bytes_read_total, self.bytes_read_useful)

    @property
    def write_amplification(self) -> float:
        return _amplification(self.bytes_written_total,
                              self.bytes_written_useful)

    def merge(self, other: "IOStats") -> "IOStats":
        out = IOStats()
        for f in dataclasses.fields(IOStats):
            setattr(out, f.name, getattr(self, f.name) + getattr(other, f.name))
        return out

    def snapshot(self) -> dict:
        with self._lock:
            d = {f.name: getattr(self, f.name)
                 for f in dataclasses.fields(IOStats)}
        d["read_amplification"] = _amplification(d["bytes_read_total"],
                                                 d["bytes_read_useful"])
        d["write_amplification"] = _amplification(d["bytes_written_total"],
                                                  d["bytes_written_useful"])
        return d

    def reset(self) -> None:
        with self._lock:
            for f in dataclasses.fields(IOStats):
                setattr(self, f.name, type(getattr(self, f.name))())


class _Timer:
    """Context manager accumulating wall time into an IOStats field."""

    def __init__(self, stats: IOStats, field: str):
        self._stats = stats
        self._field = field

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._stats.add_seconds(self._field, dt)
        return False


def read_timer(stats: IOStats) -> _Timer:
    return _Timer(stats, "read_seconds")


def write_timer(stats: IOStats) -> _Timer:
    return _Timer(stats, "write_seconds")


def _amplification(total: int, useful: int) -> float:
    return total / useful if useful else 1.0


def _page_round(nbytes: int) -> int:
    if nbytes <= 0:
        return 0
    return ((nbytes + PAGE_SIZE - 1) // PAGE_SIZE) * PAGE_SIZE
