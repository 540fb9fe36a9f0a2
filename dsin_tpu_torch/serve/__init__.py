"""The port's compression service (counterpart of the JAX package's
`dsin_tpu.serve`), exported under the JAX names.

`CompressionService` (`service.py`) loads the model once, micro-batches
requests onto static buckets (`buckets.py`, `batcher.py`), writes
CRC-framed DSRV streams, caches side-image preps per session
(`session.py`) and overlaps device batches with rANS coding on a thread
pool, or with `entropy_backend="process"` in spawned children that hold
their own codec, their payloads on the pipe or in shared-memory lanes
(`shmlane.py`); `device.py` `DeviceServer` holds its device functions.
The model lifecycle (`swap.py`: hot swap, instant rollback, the
post-commit watchdog), model-health telemetry (`quality.py`: coding gap,
SI-match alarm, golden canary), priority classes with the admission gate,
the front door (`router.py`: `FrontDoorRouter` over spawned replica
services, session pinning, the fleet's two-phase swap, elastic add/drain,
the fleet's metrics and traces; `protocol.py`, its wire tuples), the
fleet's control loop (`autoscale.py`: the pure scale and fleet-health
policies, the `Autoscaler` and the `FederationHealthDriver`) and the router
of routers (`federation.py`: `FederatedRouter` over member fleets, rollout
waves, partition healing, the federated metrics and traces) and the
bucket ladder over several serve devices (`placement.py`: the pure
planner and rebalance trigger, `DevicePlacement`; the service's
device-affine workers, `devices` as an int or a tuple of logical devices)
are ported: the whole of the JAX package's serve stack.
"""

from dsin_tpu_torch.serve.batcher import (BULK, INTERACTIVE,
                                          DeadlineExceeded, Future,
                                          MicroBatcher, PriorityClass,
                                          Request, ServeError,
                                          ServiceDraining, ServiceOverloaded,
                                          ServiceUnavailable, SessionKey,
                                          default_priority_classes)
from dsin_tpu_torch.serve.autoscale import (Autoscaler, AutoscaleConfig,
                                            AutoscaleError, AutoscalePolicy,
                                            FederationHealthDriver,
                                            FleetHealthPolicy,
                                            FleetHealthSignals, ScaleSignals,
                                            federation_health_from_snapshot,
                                            health_from_snapshot,
                                            signals_from_snapshot)
from dsin_tpu_torch.serve.buckets import (BucketPolicy, NoBucketFits,
                                          crop_from_bucket, pad_to_bucket)
from dsin_tpu_torch.serve.device import DeviceServer
from dsin_tpu_torch.serve.federation import (FederatedMetrics,
                                             FederatedRouter, FederatedTraces,
                                             FederationError, Member,
                                             MemberUnreachable,
                                             RolloutAborted, RolloutPlan)
from dsin_tpu_torch.serve.metrics import MetricsRegistry, MetricsServer
from dsin_tpu_torch.serve.placement import (DevicePlacement, PlacementError,
                                            PlacementPlan, RebalanceTrigger,
                                            plan_placement)
from dsin_tpu_torch.serve.quality import (CanaryFailed, CanaryState,
                                          QualityMonitor)
from dsin_tpu_torch.serve.router import (AdmissionController,
                                         AggregatedMetrics, AggregatedTraces,
                                         FleetScaleError, FleetSwapError,
                                         FrontDoorRouter)
from dsin_tpu_torch.serve.service import (CompressionService, EncodeResult,
                                          ServiceConfig, StreamCorrupt,
                                          frame_stream, parse_stream)
from dsin_tpu_torch.serve.session import (SessionEntry, SessionError,
                                          SessionExpired, SessionOverCapacity,
                                          SessionStore)
from dsin_tpu_torch.serve.swap import (ConditionalRollbackRefused,
                                       ModelBundle, RollbackWatchdog,
                                       SwapCoordinator, SwapError)
from dsin_tpu_torch.serve.trace import FlightRecorder, TraceContext, Tracer
from dsin_tpu_torch.train.checkpoint import ManifestMismatch
from dsin_tpu_torch.utils.integrity import IntegrityError

__all__ = [
    "BULK", "INTERACTIVE",
    "AdmissionController", "AggregatedMetrics", "AggregatedTraces",
    "AutoscaleConfig", "AutoscaleError", "AutoscalePolicy", "Autoscaler",
    "BucketPolicy", "CanaryFailed", "CanaryState", "CompressionService",
    "ConditionalRollbackRefused", "DeadlineExceeded",
    "DevicePlacement", "DeviceServer", "EncodeResult", "FederatedMetrics", "FederatedRouter",
    "FederatedTraces", "FederationError", "FederationHealthDriver",
    "FleetHealthPolicy", "FleetHealthSignals", "FleetScaleError",
    "FleetSwapError", "FlightRecorder", "FrontDoorRouter", "Future",
    "IntegrityError", "ManifestMismatch", "Member", "MemberUnreachable",
    "MetricsRegistry", "MetricsServer", "MicroBatcher", "ModelBundle",
    "NoBucketFits", "PlacementError", "PlacementPlan", "PriorityClass", "QualityMonitor", "Request",
    "RebalanceTrigger", "RollbackWatchdog", "RolloutAborted", "RolloutPlan", "ScaleSignals",
    "ServeError", "ServiceConfig",
    "ServiceDraining", "ServiceOverloaded", "ServiceUnavailable",
    "SessionEntry", "SessionError", "SessionExpired", "SessionKey",
    "SessionOverCapacity", "SessionStore", "StreamCorrupt",
    "SwapCoordinator", "SwapError", "TraceContext", "Tracer", "crop_from_bucket",
    "default_priority_classes", "federation_health_from_snapshot",
    "frame_stream", "health_from_snapshot", "pad_to_bucket",
    "parse_stream", "plan_placement", "signals_from_snapshot",
]
