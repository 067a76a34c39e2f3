"""Serving: the VisionEngine (scheduler, ragged batcher, planner, quality
controller, step pipeline) and the LM ServeEngine (scheduler, KV-cache
manager, model runner, step pipeline)."""
from repro_torch.serving.cache_manager import (KVCacheManager,
                                               bucket_length,
                                               prune_kv_caches)
from repro_torch.serving.engine import EngineConfig, Request, ServeEngine
from repro_torch.serving.pipeline import StagedStep, StepPipeline, StepReport
from repro_torch.serving.planner import (PLANNER_MODES, ExecutionPlan,
                                         FusedLane, PlanItem, TileCostModel,
                                         TilePlanner)
from repro_torch.serving.quality import (QUALITY_MODES, QualityConfig,
                                         QualityController)
from repro_torch.serving.ragged_batcher import RaggedBatcher, Tile
from repro_torch.serving.runner import ModelRunner, build_padded_batch
from repro_torch.serving.scheduler import Scheduler
from repro_torch.serving.vision import (VisionEngine, VisionEngineConfig,
                                        VisionRequest)

__all__ = ["StagedStep", "StepPipeline", "StepReport", "PLANNER_MODES",
           "ExecutionPlan", "FusedLane", "PlanItem", "TileCostModel",
           "TilePlanner", "QUALITY_MODES", "QualityConfig",
           "QualityController", "RaggedBatcher", "Tile", "Scheduler",
           "VisionEngine", "VisionEngineConfig", "VisionRequest",
           "EngineConfig", "Request", "ServeEngine", "KVCacheManager",
           "ModelRunner", "build_padded_batch", "bucket_length",
           "prune_kv_caches"]
