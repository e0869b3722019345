"""Durability primitives: the index manifest, the build's phase log, the
residency snapshots and the scheduler's queue spill.

Copied from the JAX package's ``ft/atomic.py`` (plain Python, no torch).
One implementation of the commit protocol the writers above rely on:

  * **atomic directory commit** — writers fill ``<name>.tmp/`` and make
    it visible with a single ``os.replace`` to ``<name>/``. A crash at
    any point leaves either the committed previous state or a torn
    ``.tmp`` that readers ignore and ``reap_tmp`` removes on next open.
  * **async writer thread** — ``AsyncCommitter`` runs commit closures on
    a daemon thread behind a depth-1 queue: a slow disk can delay at
    most one snapshot and never corrupts one. ``try_submit`` never
    blocks (a residency snapshot defers to the next query boundary
    instead of stalling the serve path); ``submit`` blocks
    (backpressure for a writer that must not skip a commit).
  * **config fingerprints** — ``fingerprint`` hashes a canonical-JSON
    rendering of a config/shape so restore can refuse state written by a
    different session setup instead of silently resuming into garbage.
"""
from __future__ import annotations

import hashlib
import json
import os
import queue
import shutil
import threading

TMP_SUFFIX = ".tmp"


def reap_tmp(directory: str) -> list[str]:
    """Remove torn ``*.tmp`` entries (uncommitted writes from a crashed
    writer). Returns the names reaped. Missing directory is a no-op."""
    reaped = []
    if not os.path.isdir(directory):
        return reaped
    for name in os.listdir(directory):
        if name.endswith(TMP_SUFFIX):
            path = os.path.join(directory, name)
            if os.path.isdir(path):
                shutil.rmtree(path, ignore_errors=True)
            else:
                try:
                    os.remove(path)
                except OSError:
                    pass
            reaped.append(name)
    return reaped


def atomic_commit_dir(directory: str, name: str, writer) -> str:
    """Commit ``writer``'s output as ``<directory>/<name>`` atomically.

    ``writer(tmp_path)`` fills a fresh ``<name>.tmp`` directory; the
    commit is the ``os.replace`` rename at the end — readers either see
    the complete directory or nothing. An existing committed ``name`` is
    replaced. Returns the committed path."""
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, name + TMP_SUFFIX)
    final = os.path.join(directory, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    writer(tmp)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def atomic_write_json(path: str, obj) -> None:
    """Single-file analogue of ``atomic_commit_dir`` for small metadata
    (e.g. the serving residency snapshot): write ``path.tmp``, fsync,
    ``os.replace``."""
    tmp = path + TMP_SUFFIX
    with open(tmp, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def fingerprint(obj) -> str:
    """Stable 16-hex digest of a canonical-JSON rendering of ``obj``.

    Non-JSON leaves (numpy scalars, arrays) are stringified via
    ``default=str`` — good enough for config dataclass dicts and shape
    tuples, which is all restore compatibility needs."""
    blob = json.dumps(obj, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


class AsyncCommitter:
    """Daemon writer thread behind a depth-1 queue.

    Work items are zero-arg closures (typically ``atomic_commit_dir``
    calls). Failures are recorded and re-raised on the *next* submit or
    on ``close()``. The residency snapshots and the scheduler's queue
    spill write through it, off the serving threads.
    """

    def __init__(self, name: str = "ft-commit"):
        self._q: queue.Queue = queue.Queue(maxsize=1)
        self._errors: list[Exception] = []
        self._worker = threading.Thread(target=self._drain, name=name,
                                        daemon=True)
        self._worker.start()

    def _drain(self) -> None:
        while True:
            fn = self._q.get()
            if fn is None:
                return
            try:
                fn()
            except Exception as e:  # surfaced on next submit()/close()
                self._errors.append(e)

    def _raise_pending(self) -> None:
        if self._errors:
            e = self._errors.pop(0)
            raise RuntimeError(f"async checkpoint failed: {e}") from e

    def submit(self, fn) -> None:
        """Enqueue, blocking while one write is in flight (backpressure)."""
        self._raise_pending()
        self._q.put(fn)

    def try_submit(self, fn) -> bool:
        """Enqueue only if the writer is idle — never blocks. Returns
        False when a write is in flight (caller keeps its pending state
        and retries at the next boundary)."""
        self._raise_pending()
        try:
            self._q.put_nowait(fn)
            return True
        except queue.Full:
            return False

    def drain(self, timeout: float = 60.0) -> None:
        """Block until every enqueued write has landed (the queue is
        depth-1, so joining the queue suffices)."""
        # depth-1 queue: wait by submitting a no-op barrier
        done = threading.Event()
        self._q.put(done.set)
        if not done.wait(timeout):
            raise TimeoutError("async committer did not drain")
        self._raise_pending()

    def close(self, timeout: float = 60.0) -> None:
        self._q.put(None)
        self._worker.join(timeout=timeout)
        self._raise_pending()
