"""Runtime: elasticity, failure handling, straggler mitigation (plain
Python copies of the JAX package's ``repro.runtime``)."""
from repro_torch.runtime.elastic import (ElasticController,
                                         HeartbeatRegistry, MeshPlan,
                                         plan_mesh)
from repro_torch.runtime.straggler import (HostMonitor, StepTimer,
                                           rebalance_edges)

__all__ = ["ElasticController", "HeartbeatRegistry", "HostMonitor",
           "MeshPlan", "StepTimer", "plan_mesh", "rebalance_edges"]
