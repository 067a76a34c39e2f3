"""Fault tolerance for the training loop (``fault``): checkpointed restart
with exact resume, and a straggler watchdog."""
from repro_torch.dist.fault import FaultConfig, RestartableLoop, StepWatchdog

__all__ = ["FaultConfig", "StepWatchdog", "RestartableLoop"]
