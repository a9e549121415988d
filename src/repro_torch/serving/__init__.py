"""Serving: static reference engine + continuous-batching subsystem.

- :class:`~repro_torch.serving.engine.ServeEngine` — static-batch reference.
- :class:`~repro_torch.serving.continuous.ContinuousEngine` — in-flight
  batching over a fixed request-slot pool.
- :class:`~repro_torch.serving.scheduler.Scheduler` — wait-queue admission,
  deadlines, virtual-clock trace replay.
- :func:`~repro_torch.serving.traffic.synthetic_traffic` — bursty MMPP
  traces.
- :class:`~repro_torch.serving.hotswap.CheckpointWatcher` — live
  checkpoint hot-swap into a ``ContinuousEngine``, journalled as
  :class:`~repro_torch.serving.hotswap.SwapEvent` entries.
"""
from repro_torch.serving.continuous import ContinuousEngine, FinishedRequest
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.hotswap import CheckpointWatcher, SwapEvent
from repro_torch.serving.scheduler import Request, RequestResult, Scheduler
from repro_torch.serving.traffic import TrafficConfig, synthetic_traffic

__all__ = [
    "CheckpointWatcher",
    "ContinuousEngine",
    "FinishedRequest",
    "Request",
    "RequestResult",
    "Scheduler",
    "ServeEngine",
    "SwapEvent",
    "TrafficConfig",
    "synthetic_traffic",
]
