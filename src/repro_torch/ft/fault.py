"""Fault injection for resilience tests and the failover checks of the
smoke run (copied from the JAX package's ``ft/fault.py``; plain Python).

Failure families map to the crash matrix in the JAX package's
``ft/README.md``:

  * ``FaultInjector(kill_at_superstep=k)`` — process death mid-join: the
    injector raises ``InjectedKill`` at the top of superstep ``k`` and
    then disarms, so the resumed run sails past the same point.
  * ``FlakyStore(store, read_error_every=n)`` — transient SSD read
    errors: every n-th read call raises ``IOError`` (capped by
    ``max_errors``), exercising the retry/backoff path in the executors
    and prefetcher.
  * ``FaultInjector.tear_checkpoint(dir)`` — a torn ``.tmp`` checkpoint
    directory as a crashed writer would leave it; restore must ignore it
    and open must reap it.

Shard-level verbs (the replicated-serving failure modes of
``serve.replica``) wrap a replica session's store in a ``FlakyStore``
and flip its mode:

  * ``FaultInjector.kill_replica(replica)`` — permanent death: every
    read raises ``InjectedKill`` until the supervisor reopens a fresh
    session (or ``revive_replica`` is called in tests).
  * ``FaultInjector.brownout(replica, latency_x)`` — a slow-but-alive
    disk: reads succeed after ``latency_x`` times the store's emulated
    read latency.
  * ``FaultInjector.flaky_replica(replica, every=n)`` — the transient
    mode, addressed by replica.

``replica`` is anything with an ``.index`` attribute (a
``serve.replica.Replica``) or a ``DiskJoinIndex`` itself.
"""
from __future__ import annotations

import os
import threading
import time

import numpy as np


class InjectedKill(RuntimeError):
    """Raised by the injector in place of a real SIGKILL — the test
    harness catches it where a supervisor would restart the process."""


class FaultInjector:
    """Deterministic fault schedule for one join attempt, plus the
    shard-level verbs used by the replicated-serving benchmarks."""

    def __init__(self, kill_at_superstep: int | None = None):
        self.kill_at_superstep = kill_at_superstep
        self._fired = False
        self.kills = 0

    def superstep(self, si: int) -> None:
        """Hook for the top of each superstep of a superstep join
        (``core.distributed.DistributedJoin.run``). Fires at most once,
        then disarms."""
        if (self.kill_at_superstep is not None and not self._fired
                and si >= self.kill_at_superstep):
            self._fired = True
            self.kills += 1
            raise InjectedKill(f"injected kill at superstep {si}")

    @staticmethod
    def tear_checkpoint(directory: str, superstep: int = 999999) -> str:
        """Fabricate a torn (uncommitted) checkpoint write: a ``.tmp``
        dir with a partial payload and no committed rename."""
        path = os.path.join(directory, f"ckpt_{superstep:06d}.tmp")
        os.makedirs(path, exist_ok=True)
        np.save(os.path.join(path, "pairs.npy"),
                np.zeros((3, 2), np.int64))   # garbage a resume must ignore
        with open(os.path.join(path, "state.json"), "w") as f:
            f.write('{"superstep": ')  # truncated mid-write
        return path

    # -- shard-level verbs ----------------------------------------------------
    @staticmethod
    def _flaky_store_of(target) -> "FlakyStore":
        """The target session's store, wrapped in a ``FlakyStore`` proxy
        (idempotent — an already-wrapped store is reused)."""
        index = getattr(target, "index", target)
        store = index.store
        if not isinstance(store, FlakyStore):
            store = FlakyStore(store, read_error_every=0)
            index.store = store
        return store

    def kill_replica(self, target) -> "FlakyStore":
        """Permanent replica death: every subsequent read on the
        session's store raises ``InjectedKill``, and the session's warm
        slabs are dropped — a dead process loses its cache, so requests
        cannot keep limping along on residual warm hits. The replica
        stays dead until a supervisor swaps in a fresh session (its
        reopen binds the real store again) or ``revive_replica`` is
        called."""
        store = self._flaky_store_of(target)
        store.kill()
        index = getattr(target, "index", target)
        try:
            index.drop_warm_cache()
        except Exception:
            pass           # a wedged session still counts as killed
        self.kills += 1
        return store

    def revive_replica(self, target) -> None:
        """Undo ``kill_replica`` in place (tests that do not run a
        supervisor)."""
        self._flaky_store_of(target).revive()

    def brownout(self, target, latency_x: float = 4.0, *,
                 extra_latency_s: float | None = None) -> "FlakyStore":
        """Slow-but-alive replica: reads succeed after ``latency_x``
        times the store's emulated read latency (or an explicit
        ``extra_latency_s``). A browned-out replica trips the hedging
        knob and drifts to DEGRADED via deadline drops — it is never
        ejected outright, which is the point: brownouts must be handled
        by routing AROUND the replica, not by declaring it dead."""
        store = self._flaky_store_of(target)
        if extra_latency_s is None:
            base = float(getattr(store, "read_latency_s", 0.0) or 0.0)
            extra_latency_s = base * (float(latency_x) - 1.0)
        store.extra_latency_s = float(max(0.0, extra_latency_s))
        return store

    def flaky_replica(self, target, every: int = 5,
                      max_errors: int | None = None) -> "FlakyStore":
        """Transient read errors on one replica (every n-th read), the
        retry-in-place regime — addressed form of ``FlakyStore``."""
        store = self._flaky_store_of(target)
        store.read_error_every = int(every)
        store.max_errors = max_errors
        return store


class FlakyStore:
    """Proxy store injecting faults on reads.

    Wraps any vector store; non-read attribute access (including
    ``read_latency_s`` assignment, which ``DiskJoinIndex`` sets) passes
    through to the inner store. Three modes, combinable:

      * transient: every ``read_error_every``-th read raises ``IOError``
        (capped by ``max_errors``; 0 disables);
      * killed (``kill()``/``revive()``): every read raises
        ``InjectedKill`` — a dead replica;
      * brownout (``extra_latency_s``): reads sleep first — a slow disk.

    Counters are shared across ``read_bucket`` / ``read_bucket_into`` /
    ``read_run_into`` and thread-safe (the prefetcher reads from worker
    threads).
    """

    _LOCAL = ("store", "read_error_every", "max_errors", "_lock",
              "_calls", "errors_injected", "killed", "kills_injected",
              "extra_latency_s")

    def __init__(self, store, *, read_error_every: int = 5,
                 max_errors: int | None = None):
        object.__setattr__(self, "store", store)
        object.__setattr__(self, "read_error_every", int(read_error_every))
        object.__setattr__(self, "max_errors", max_errors)
        object.__setattr__(self, "_lock", threading.Lock())
        object.__setattr__(self, "_calls", 0)
        object.__setattr__(self, "errors_injected", 0)
        object.__setattr__(self, "killed", False)
        object.__setattr__(self, "kills_injected", 0)
        object.__setattr__(self, "extra_latency_s", 0.0)

    def kill(self) -> None:
        object.__setattr__(self, "killed", True)

    def revive(self) -> None:
        object.__setattr__(self, "killed", False)

    def _maybe_fail(self) -> None:
        with self._lock:
            if self.killed:
                object.__setattr__(self, "kills_injected",
                                   self.kills_injected + 1)
                raise InjectedKill("replica store is dead (injected)")
            self._calls += 1
            calls, injected = self._calls, self.errors_injected
            if (self.read_error_every > 0
                    and calls % self.read_error_every == 0
                    and (self.max_errors is None
                         or injected < self.max_errors)):
                object.__setattr__(self, "errors_injected", injected + 1)
                raise IOError("injected transient read error")
        if self.extra_latency_s > 0:
            time.sleep(self.extra_latency_s)

    def read_bucket(self, *a, **kw):
        self._maybe_fail()
        return self.store.read_bucket(*a, **kw)

    def read_bucket_into(self, *a, **kw):
        self._maybe_fail()
        return self.store.read_bucket_into(*a, **kw)

    def read_run_into(self, *a, **kw):
        self._maybe_fail()
        return self.store.read_run_into(*a, **kw)

    def __getattr__(self, name):
        return getattr(self.store, name)

    def __setattr__(self, name, value):
        if name in self._LOCAL:
            object.__setattr__(self, name, value)
        else:
            setattr(self.store, name, value)
