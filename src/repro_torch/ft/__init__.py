"""Fault tolerance: crash-safe joins, resumable builds, warm restarts,
fault injection.

Copied from the JAX package's ``repro.ft`` (plain Python): the join
checkpointer (``join_ckpt``) records ``core.distributed.DistributedJoin``'s
supersteps in the JAX package's format.
"""
from repro_torch.ft.atomic import (AsyncCommitter, atomic_commit_dir,
                                   atomic_write_json, fingerprint, reap_tmp)
from repro_torch.ft.fault import FaultInjector, FlakyStore, InjectedKill
from repro_torch.ft.join_ckpt import JoinCheckpointer, ResumeState
from repro_torch.ft.phases import PhaseLog

__all__ = [
    "AsyncCommitter", "atomic_commit_dir", "atomic_write_json",
    "fingerprint", "reap_tmp",
    "FaultInjector", "FlakyStore", "InjectedKill",
    "JoinCheckpointer", "ResumeState",
    "PhaseLog",
]
