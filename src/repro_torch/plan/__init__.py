"""repro_torch.plan — cost-based adaptive planning (a copy of the JAX
package's ``repro.plan``; the cost model adds the card's own constants).

``CardinalityEstimator`` answers *how many pairs will this work emit*
from per-bucket sample sketches; ``CostModel`` prices reads, transfers
and verify paths from telemetry; ``Planner`` turns both into typed,
explainable ``JoinPlan``/``WavePlan``/``PoolPlan`` objects the
core/io/compute/serve layers consume instead of hand-tuned knobs.
"""
from repro_torch.plan.cost_model import CostModel
from repro_torch.plan.estimator import (SKETCH_FILE, CardinalityEstimator,
                                        PairEstimate)
from repro_torch.plan.planner import (Decision, JoinPlan, Planner, PoolPlan,
                                      WavePlan, predict_replica_service_s)

__all__ = [
    "CardinalityEstimator", "PairEstimate", "SKETCH_FILE",
    "CostModel", "Planner", "JoinPlan", "WavePlan", "PoolPlan",
    "Decision", "predict_replica_service_s",
]
