"""Distribution over several processes: logical-axis sharding rules, the
sharded parameter store and pipeline parallelism, a port of the JAX
package's ``dist``.

``repro_torch.dist.sharding`` — the rule table resolved against an ambient
mesh (``set_mesh`` / ``axis_rules``), ``param_shardings`` from the
reference leaves' names, and ``ShardedParams`` (parameters held as each
rank's parts, gathered around each block).

``repro_torch.dist.pipeline`` — GPipe over a ``stage`` mesh axis
(point-to-point sends tick by tick).
"""
from repro_torch.dist import sharding  # noqa: F401
