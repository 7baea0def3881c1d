"""The serving layer of the port: ``ShardedTriggerService`` (router,
replica groups per route or bucket, the deadline and streaming replica
loops, one merged in-order release stage) with its fault tolerance
(seeded fault injection, circuit breakers, failover, shedding).

Counterpart of ``repro/serving/``, with the trigger monitor
(``monitor.py``) and its HTTP server (``monitor_server.py``). On the card
each replica given a deployed pipeline serves through a lane of its own
(``core/pipeline.py:Lane``).
"""
from repro_torch.serving.engine import (AggregateStats, ServingStats,
                                        ShardedTriggerService,
                                        TriggerServingEngine)
from repro_torch.serving.faults import (FAULT_KINDS, FaultPlan, FaultSpec,
                                        InjectedFault)
from repro_torch.serving.health import (BREAKER_STATES, BreakerConfig,
                                        ReplicaHealth)
from repro_torch.serving.monitor import (MonitorSnapshot, TriggerMonitor,
                                         detector_grid, event_display,
                                         write_display)
from repro_torch.serving.monitor_server import MonitorServer
from repro_torch.serving.replica import (InOrderReleaser, ReplicaEngine,
                                         ShedError)
from repro_torch.serving.router import (POLICIES, Router, event_occupancy,
                                        pick_bucket, pick_bucket_sorted)
from repro_torch.serving.streaming import LOOPS, StreamingReplicaEngine

__all__ = ["AggregateStats", "BREAKER_STATES", "BreakerConfig",
           "FAULT_KINDS", "FaultPlan", "FaultSpec", "InOrderReleaser",
           "InjectedFault", "LOOPS", "MonitorServer", "MonitorSnapshot",
           "POLICIES", "ReplicaEngine", "ReplicaHealth", "Router",
           "ServingStats", "ShardedTriggerService", "ShedError",
           "StreamingReplicaEngine", "TriggerMonitor",
           "TriggerServingEngine", "detector_grid", "event_display",
           "event_occupancy", "pick_bucket", "pick_bucket_sorted",
           "write_display"]
