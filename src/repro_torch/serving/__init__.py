"""Vision serving: scheduler, ragged batcher, planner, quality controller,
step pipeline and the VisionEngine."""
from repro_torch.serving.pipeline import StagedStep, StepPipeline, StepReport
from repro_torch.serving.planner import (PLANNER_MODES, ExecutionPlan,
                                         FusedLane, PlanItem, TileCostModel,
                                         TilePlanner)
from repro_torch.serving.quality import (QUALITY_MODES, QualityConfig,
                                         QualityController)
from repro_torch.serving.ragged_batcher import RaggedBatcher, Tile
from repro_torch.serving.scheduler import Scheduler
from repro_torch.serving.vision import (VisionEngine, VisionEngineConfig,
                                        VisionRequest)

__all__ = ["StagedStep", "StepPipeline", "StepReport", "PLANNER_MODES",
           "ExecutionPlan", "FusedLane", "PlanItem", "TileCostModel",
           "TilePlanner", "QUALITY_MODES", "QualityConfig",
           "QualityController", "RaggedBatcher", "Tile", "Scheduler",
           "VisionEngine", "VisionEngineConfig", "VisionRequest"]
