"""Runtime services of the trainer: heartbeats, straggler detection and
fault injection."""
from .fault_tolerance import (FaultInjector, HeartbeatMonitor,  # noqa: F401
                              Preemption, SpeculativeFetcher,
                              StragglerDetector, WorkerFailure)
