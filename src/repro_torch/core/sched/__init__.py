"""Layered scheduler subsystem: the RM run loop split into four pluggable
components (see docs/ARCHITECTURE.md).

  policy     — scheduling priority (depth/breadth/fair/deadline, SCHEDULES)
  admission  — budget check + make-room sequencing
  eviction   — victim selection + rollback/limitdrop/adaptive (POLICIES)
  executor   — concurrent worker-pool executor (workers=1: sequential)
"""

from .admission import AdmissionController
from .eviction import (AdaptiveEviction, EvictionPolicy, KswapEviction,
                       LimitDropEviction, NoEviction, POLICIES,
                       RollbackEviction, get_eviction, register_eviction)
from .executor import (NodePoisonedError, ProcessWorkerExecutor, Ticket,
                       WorkerPoolExecutor)
from .policy import (BreadthFirst, DeadlineAware, DepthFirst, FairShare,
                     SCHEDULES, SchedulePolicy, get_schedule,
                     register_schedule)

__all__ = [
    "AdmissionController",
    "AdaptiveEviction", "EvictionPolicy", "KswapEviction",
    "LimitDropEviction", "NoEviction", "POLICIES", "RollbackEviction",
    "get_eviction", "register_eviction",
    "NodePoisonedError", "ProcessWorkerExecutor", "Ticket",
    "WorkerPoolExecutor",
    "BreadthFirst", "DeadlineAware", "DepthFirst", "FairShare",
    "SCHEDULES", "SchedulePolicy", "get_schedule", "register_schedule",
]
