"""Fault tolerance: heartbeats, straggler detection, fault injection (a
copy of the reference's ``runtime/fault_tolerance.py``, which is plain
Python).

The recovery MACHINERY is real (used by launch/train.py); the FAILURES are
injected (one process). On a real cluster the HeartbeatMonitor feeds from
per-host agents; here `FaultInjector` raises at scripted steps so tests
can drive the whole detect → rollback → resume path.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional


class WorkerFailure(RuntimeError):
    def __init__(self, worker: int, reason: str = "heartbeat timeout"):
        super().__init__(f"worker {worker} failed: {reason}")
        self.worker = worker


class Preemption(RuntimeError):
    pass


@dataclass
class HeartbeatMonitor:
    """Tracks per-worker liveness. `beat(w)` is called by host agents (or
    the training loop on behalf of simulated workers); `check()` raises
    WorkerFailure when a worker misses its deadline."""
    n_workers: int
    timeout_s: float = 60.0
    _last: Dict[int, float] = field(default_factory=dict)
    _dead: set = field(default_factory=set)

    def beat(self, worker: int, t: Optional[float] = None):
        self._last[worker] = t if t is not None else time.monotonic()

    def mark_dead(self, worker: int):
        self._dead.add(worker)

    def alive_workers(self) -> List[int]:
        return [w for w in range(self.n_workers) if w not in self._dead]

    def check(self, t: Optional[float] = None):
        now = t if t is not None else time.monotonic()
        for w in range(self.n_workers):
            if w in self._dead:
                continue
            last = self._last.get(w)
            if last is not None and now - last > self.timeout_s:
                self._dead.add(w)
                raise WorkerFailure(w)


@dataclass
class StragglerDetector:
    """EWMA step-time tracker. A step slower than factor× the EWMA flags a
    straggler; the training loop excludes the slow host at the next
    re-mesh and enables speculative (backup-task) data fetches
    meanwhile."""
    factor: float = 3.0
    alpha: float = 0.1
    min_samples: int = 5
    _ewma: float = 0.0
    _n: int = 0
    flagged: List[int] = field(default_factory=list)

    def observe(self, step: int, seconds: float) -> bool:
        if self._n >= self.min_samples and seconds > self.factor * self._ewma:
            self.flagged.append(step)
            # straggler steps do not poison the EWMA
            return True
        self._ewma = (seconds if self._n == 0
                      else (1 - self.alpha) * self._ewma + self.alpha * seconds)
        self._n += 1
        return False

    @property
    def ewma(self) -> float:
        return self._ewma


@dataclass
class FaultInjector:
    """Scripted failures for tests/examples: {step: exception_factory}."""
    schedule: Dict[int, Callable[[], BaseException]] = field(default_factory=dict)
    fired: set = field(default_factory=set)

    def maybe_fire(self, step: int):
        if step in self.schedule and step not in self.fired:
            self.fired.add(step)
            raise self.schedule[step]()

    @classmethod
    def worker_failure_at(cls, step: int, worker: int = 0):
        return cls(schedule={step: lambda: WorkerFailure(worker, "injected")})

    @classmethod
    def preemption_at(cls, step: int):
        return cls(schedule={step: lambda: Preemption(f"injected at {step}")})


@dataclass
class SpeculativeFetcher:
    """Backup-task mitigation for straggling data loads: send the same
    shard to two loaders, take whichever returns first."""
    loader: Callable[[int], object]
    backup_loader: Optional[Callable[[int], object]] = None
    use_backup: bool = False
    backup_wins: int = 0

    def fetch(self, shard: int):
        if not self.use_backup or self.backup_loader is None:
            return self.loader(shard)
        t0 = time.monotonic()
        try:
            return self.loader(shard)
        except TimeoutError:
            self.backup_wins += 1
            return self.backup_loader(shard)
