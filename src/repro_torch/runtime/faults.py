"""Deterministic fault injection for the serving tier.

The port's copy of the reference's ``runtime/faults.py``.  A
:class:`FaultInjector` sits on the compute plane
(:class:`repro_torch.runtime.cnn_server._BucketedCompute` calls
:meth:`FaultInjector.before_compute` with the batch's request uids before
every compute attempt) and raises according to a declarative
:class:`FaultPlan`:

* **one-shot** — fail the next N compute attempts with a transient
  :class:`InjectedFault` (exercises retry/backoff);
* **poison pill** — any attempt whose batch contains a poisoned uid fails,
  every time (exercises bisection);
* **flaky rate** — each attempt fails with probability ``flaky_rate`` from a
  seeded RNG;
* **straggler** — the next N attempts sleep ``straggle_ms`` first;
* **worker death** — after ``die_after_attempts`` attempts, the next one
  raises :class:`WorkerDeath`, which the async engine treats as fatal.

Process-level kinds, which only make sense when the worker is a real OS
process (:mod:`repro_torch.runtime.actor`), ride a
:class:`ProcessFaultPlan`:

* **SIGKILL** — the child kills itself at a compute boundary; the parent
  sees the process sentinel fire, not an exception;
* **SIGSTOP hang** — the child freezes without dying; heartbeats stop and
  the supervisor's hang detector must escalate to SIGKILL;
* **nonzero-exit crash** — ``os._exit(code)`` on the Nth attempt;
* **slow start** — the child sleeps before its HELLO handshake;
* **corrupt RPC reply** — the child truncates or garbles its next reply and
  then closes the connection, so the parent fails deterministically with a
  :class:`~repro_torch.runtime.rpc.ProtocolError` instead of hanging.
"""
from __future__ import annotations

import os
import random
import signal
import time
from dataclasses import dataclass
from typing import Collection


class InjectedFault(RuntimeError):
    """A compute failure injected by a :class:`FaultPlan` (indistinguishable
    from a real compute exception to the retry logic)."""


class WorkerDeath(RuntimeError):
    """Injected abrupt worker death.  The engine does NOT retry this — it is
    not a property of the batch but of the worker, which kills itself."""


@dataclass
class FaultPlan:
    """Declarative description of what to inject (all fields combinable)."""

    fail_next: int = 0              # transient: fail the next N attempts
    poison_uids: Collection[int] = ()  # any batch containing one fails
    flaky_rate: float = 0.0         # P(fail) per attempt, seeded RNG
    straggle_next: int = 0          # next N attempts sleep before computing
    straggle_ms: float = 0.0
    die_after_attempts: int | None = None  # attempts N+1... raise WorkerDeath
    seed: int = 0


class FaultInjector:
    """Applies a :class:`FaultPlan` at the compute boundary.  ``attempts``
    counts every compute attempt, retries and bisection sub-batches
    included — the unit the plan's budgets are denominated in."""

    def __init__(self, plan: FaultPlan | None = None, **plan_kwargs):
        self.plan = plan or FaultPlan(**plan_kwargs)
        self.attempts = 0
        self.injected: dict[str, int] = {
            "one_shot": 0, "poison": 0, "flaky": 0, "straggle": 0, "death": 0,
        }
        self._rng = random.Random(self.plan.seed)
        self._fail_budget = self.plan.fail_next
        self._straggle_budget = self.plan.straggle_next
        self._poison = frozenset(self.plan.poison_uids)

    def before_compute(self, uids: Collection[int]) -> None:
        """Raise or sleep per the plan.  Order: death > straggle > one-shot
        > poison > flaky."""
        self.attempts += 1
        plan = self.plan
        if (plan.die_after_attempts is not None
                and self.attempts > plan.die_after_attempts):
            self.injected["death"] += 1
            raise WorkerDeath(
                f"injected worker death after {plan.die_after_attempts} "
                f"compute attempts"
            )
        if self._straggle_budget > 0:
            self._straggle_budget -= 1
            self.injected["straggle"] += 1
            time.sleep(plan.straggle_ms / 1e3)
        if self._fail_budget > 0:
            self._fail_budget -= 1
            self.injected["one_shot"] += 1
            raise InjectedFault(
                f"injected one-shot failure (attempt {self.attempts})"
            )
        hit = self._poison.intersection(uids)
        if hit:
            self.injected["poison"] += 1
            raise InjectedFault(f"injected poison pill: uid(s) {sorted(hit)}")
        if plan.flaky_rate > 0 and self._rng.random() < plan.flaky_rate:
            self.injected["flaky"] += 1
            raise InjectedFault(
                f"injected flaky failure (attempt {self.attempts})"
            )


@dataclass
class ProcessFaultPlan(FaultPlan):
    """A :class:`FaultPlan` extended with OS-process fault kinds (only a
    :class:`~repro_torch.runtime.actor.WorkerActor` child acts on them).
    ``*_after_attempts`` budgets count compute attempts exactly like
    ``die_after_attempts`` does."""

    sigkill_after_attempts: int | None = None   # raw SIGKILL: sentinel fires
    sigstop_after_attempts: int | None = None   # freeze: hang, not death
    exit_after_attempts: int | None = None      # os._exit(exit_code)
    exit_code: int = 3
    slow_start_ms: float = 0.0                  # sleep before HELLO
    corrupt_reply_after: int | None = None      # corrupt the Nth RPC reply
    corrupt_mode: str = "truncate"              # "truncate" | "garbage"


class ProcessFaultInjector(FaultInjector):
    """Applies a :class:`ProcessFaultPlan` at the compute boundary of a
    worker process.  Inherits every in-process kind; the process kinds fire
    first (real death beats simulated death).  ``reply_corruption()`` is
    polled by the actor's RPC loop before each reply: it returns the
    corruption mode once, when the reply counter reaches
    ``corrupt_reply_after``, else ``None``."""

    def __init__(self, plan: ProcessFaultPlan | None = None, **plan_kwargs):
        super().__init__(plan or ProcessFaultPlan(**plan_kwargs))
        self.injected.update(
            {"sigkill": 0, "sigstop": 0, "exit": 0, "corrupt_reply": 0}
        )
        self._replies = 0

    def before_compute(self, uids: Collection[int]) -> None:
        plan = self.plan
        if isinstance(plan, ProcessFaultPlan):
            attempt = self.attempts + 1  # the one super() is about to count
            if (plan.sigkill_after_attempts is not None
                    and attempt > plan.sigkill_after_attempts):
                self.injected["sigkill"] += 1
                os.kill(os.getpid(), signal.SIGKILL)
            if (plan.sigstop_after_attempts is not None
                    and attempt > plan.sigstop_after_attempts):
                self.injected["sigstop"] += 1
                os.kill(os.getpid(), signal.SIGSTOP)
                # resumes here only if SIGCONTed; fall through
            if (plan.exit_after_attempts is not None
                    and attempt > plan.exit_after_attempts):
                self.injected["exit"] += 1
                os._exit(plan.exit_code)
        super().before_compute(uids)

    def reply_corruption(self) -> str | None:
        plan = self.plan
        if (not isinstance(plan, ProcessFaultPlan)
                or plan.corrupt_reply_after is None):
            return None
        self._replies += 1
        if self._replies == plan.corrupt_reply_after:
            self.injected["corrupt_reply"] += 1
            return plan.corrupt_mode
        return None


def make_injector(faults) -> FaultInjector | None:
    """Normalize a plan / injector / None into an injector (or None)."""
    if faults is None:
        return None
    if isinstance(faults, FaultInjector):
        return faults
    if isinstance(faults, ProcessFaultPlan):
        return ProcessFaultInjector(faults)
    if isinstance(faults, FaultPlan):
        return FaultInjector(faults)
    raise TypeError(f"expected FaultPlan or FaultInjector, got {faults!r}")
