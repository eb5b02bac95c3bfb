"""Serving front-ends of the port (the port of ``repro/serving``): the
fault-tolerant async ``ServingPlane`` (plane.py), its fault injection
(faults.py), and ``LMServer``/``ServeConfig`` and ``TCNStreamServer``
(engine.py)."""

from repro_torch.serving.engine import LMServer, ServeConfig, TCNStreamServer
from repro_torch.serving.faults import (FaultInjector, FaultPlan,
                                        TransientError, WorkerCrashed)
from repro_torch.serving.plane import (CRASHED, DRAINED, DRAINING, HEALTHY,
                                       RECOVERING, Rejected, RetryPolicy,
                                       ServingPlane)

__all__ = ["LMServer", "ServeConfig", "TCNStreamServer",
           "Rejected", "RetryPolicy", "ServingPlane",
           "FaultInjector", "FaultPlan", "WorkerCrashed", "TransientError",
           "HEALTHY", "DRAINING", "DRAINED", "CRASHED", "RECOVERING"]
