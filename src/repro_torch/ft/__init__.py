"""Fault tolerance: resumable builds, warm restarts, fault injection.

Copied from the JAX package's ``repro.ft`` (plain Python). The join
checkpointer (``join_ckpt``) waits for the distributed-join slice.
"""
from repro_torch.ft.atomic import (AsyncCommitter, atomic_commit_dir,
                                   atomic_write_json, fingerprint, reap_tmp)
from repro_torch.ft.fault import FaultInjector, FlakyStore, InjectedKill
from repro_torch.ft.phases import PhaseLog

__all__ = [
    "AsyncCommitter", "atomic_commit_dir", "atomic_write_json",
    "fingerprint", "reap_tmp",
    "FaultInjector", "FlakyStore", "InjectedKill",
    "PhaseLog",
]
