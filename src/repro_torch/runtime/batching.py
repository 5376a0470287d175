"""Shared micro-batching core for the serving engines.

The serving engines (the CNN batch engines of
:mod:`repro_torch.runtime.cnn_server` and the LM continuous-batching engine
of :mod:`repro_torch.runtime.lm_server`) need the same primitives:
power-of-two batch buckets so the program's bucket cache stays small, a
bounded admission queue that rejects instead of growing without limit, and
a metrics surface (queue depth, latency percentiles, batch occupancy) that
benchmarks and CI can assert on.  This module owns those primitives; the
engines own only their dispatch loops.
"""
from __future__ import annotations

import random
from collections import deque
from dataclasses import dataclass, field

import numpy as np


class AdmissionError(RuntimeError):
    """Raised when a request is rejected because the queue is at capacity.

    ``retry_after_ms`` is the load-shedding hint: the engine's estimate of
    when capacity will free up (drain time of the current backlog), so a
    well-behaved client backs off instead of hammering a saturated plane.
    ``None`` means the engine had no estimate.
    """

    def __init__(self, message: str, *, retry_after_ms: float | None = None):
        super().__init__(message)
        self.retry_after_ms = retry_after_ms


class DeadlineExceeded(RuntimeError):
    """A request's ``deadline_ms`` expired before dispatch; it is fast-failed
    without burning compute on an answer nobody is waiting for."""


class WorkerUnavailable(RuntimeError):
    """The worker serving a request died (or was evicted) before resolving
    it.  Unlike a compute error this says nothing about the request itself —
    a supervisor re-routes it to a healthy worker."""


def admit_or_raise(pending: int, capacity: int | None,
                   retry_after_ms: float | None = None) -> None:
    """The one admission check both serving planes share: reject (raise)
    when the queue is at capacity; ``capacity=None`` admits everything."""
    if capacity is not None and pending >= capacity:
        raise AdmissionError(
            f"queue at capacity ({capacity}); request rejected",
            retry_after_ms=retry_after_ms,
        )


# ---------------------------------------------------------------------------
# retry / bisection policy
# ---------------------------------------------------------------------------


@dataclass
class RetryPolicy:
    """How the compute plane survives a failed batch.

    A failing batch is retried ``max_retries`` times with exponential
    backoff (``backoff_base_ms * backoff_multiplier**attempt``) plus
    deterministic seeded jitter.  If retries exhaust and the batch holds
    more than one request, it is *bisected* — each half solved recursively —
    to isolate a poison-pill request so innocent co-batched requests still
    succeed.  ``max_splits`` bounds the bisection depth per path (``None`` =
    split down to singletons); when the budget runs out the remaining
    sub-batch fails per-request.
    """

    max_retries: int = 2
    backoff_base_ms: float = 1.0
    backoff_multiplier: float = 2.0
    jitter: float = 0.5  # fraction of the backoff added as seeded jitter
    max_splits: int | None = None
    seed: int = 0

    def __post_init__(self):
        self._rng = random.Random(self.seed)

    def backoff_ms(self, attempt: int) -> float:
        base = self.backoff_base_ms * self.backoff_multiplier ** attempt
        return base * (1.0 + self.jitter * self._rng.random())


# ---------------------------------------------------------------------------
# buckets
# ---------------------------------------------------------------------------


def pow2_buckets(max_batch: int) -> tuple[int, ...]:
    """1, 2, 4, ... up to (and including) ``max_batch``."""
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return tuple(out)


def round_up_buckets(buckets: tuple[int, ...], multiple: int
                     ) -> tuple[int, ...]:
    """Round every bucket up to a multiple (DP: shards must divide batch)."""
    if multiple <= 1:
        return tuple(sorted(set(buckets)))
    up = [-(-b // multiple) * multiple for b in buckets]
    return tuple(sorted(set(up)))


def bucket_for(buckets: tuple[int, ...], n: int) -> int:
    """The smallest bucket that fits ``n`` requests (largest if none do)."""
    for b in buckets:
        if b >= n:
            return b
    return buckets[-1]


def pad_batch(x: np.ndarray, bucket: int) -> np.ndarray:
    """Pad the leading (batch) axis with zero lanes up to ``bucket``."""
    if x.shape[0] >= bucket:
        return x
    pad = np.zeros((bucket - x.shape[0], *x.shape[1:]), x.dtype)
    return np.concatenate([x, pad])


# ---------------------------------------------------------------------------
# admission-controlled queue
# ---------------------------------------------------------------------------


@dataclass
class BoundedQueue:
    """A deque with admission control: ``push`` raises :class:`AdmissionError`
    at capacity instead of queueing unboundedly (``capacity=None`` disables
    the bound)."""

    capacity: int | None = None
    rejected: int = 0
    _q: deque = field(default_factory=deque)

    def push(self, item) -> None:
        try:
            admit_or_raise(len(self._q), self.capacity)
        except AdmissionError:
            self.rejected += 1
            raise
        self._q.append(item)

    def popleft(self):
        return self._q.popleft()

    def push_front(self, item) -> None:
        """Return an already-admitted item to the head of the queue (slot
        contention / eviction-replay) — no admission check, it was paid on
        the original ``push``."""
        self._q.appendleft(item)

    def peek(self):
        return self._q[0]

    def pop_up_to(self, n: int) -> list:
        return [self._q.popleft() for _ in range(min(n, len(self._q)))]

    def __len__(self) -> int:
        return len(self._q)

    def __bool__(self) -> bool:
        return bool(self._q)


def refill_slots(slots: list, queue, on_fill) -> list[int]:
    """Fill empty (None) lanes from the queue; ``on_fill(lane, req)`` does the
    engine-specific lane reset.  Returns the lanes filled."""
    filled = []
    for i, slot in enumerate(slots):
        if slot is None and queue:
            req = queue.popleft()
            slots[i] = req
            on_fill(i, req)
            filled.append(i)
    return filled


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


class Reservoir:
    """A bounded sample reservoir with percentile readout — the one latency
    surface of the engines' request latency."""

    def __init__(self, maxlen: int = 4096):
        self._xs: deque = deque(maxlen=maxlen)

    def observe(self, x: float) -> None:
        self._xs.append(float(x))

    def __len__(self) -> int:
        return len(self._xs)

    def percentile(self, pct: float) -> float:
        if not self._xs:
            return 0.0
        xs = sorted(self._xs)
        i = min(len(xs) - 1, int(round(pct / 100.0 * (len(xs) - 1))))
        return xs[i]


@dataclass
class EngineMetrics:
    """Monotone serving counters + a bounded latency reservoir.

    ``snapshot()`` is the serving metrics surface: a flat dict the engines
    re-export (merged with the program's cache counters) so benchmarks and
    the CI bench-gate can assert on it.
    """

    submitted: int = 0
    completed: int = 0
    rejected: int = 0
    batches: int = 0
    lanes_used: int = 0
    lanes_total: int = 0
    deadline_flushes: int = 0
    full_flushes: int = 0
    # failure surface: requests that resolved with an error, retry attempts
    # made on their behalf, requests shed at admission with a retry-after
    # hint, requests fast-failed on an expired deadline, and worker restarts
    # (bumped by the supervisor; always 0 on a bare engine)
    errors: int = 0
    retries: int = 0
    shed: int = 0
    deadline_failures: int = 0
    restarts: int = 0
    # cross-thread compute->loop handoffs; the async engine resolves futures
    # in batch, so this stays == batches (one handoff per flush), never
    # == completed (one per request) — asserted by tests and bench_serving
    loop_handoffs: int = 0
    _latencies_ms: Reservoir = field(default_factory=Reservoir)

    def observe_latency(self, ms: float) -> None:
        self._latencies_ms.observe(ms)

    def observe_batch(self, used: int, total: int, *,
                      deadline: bool = False) -> None:
        self.batches += 1
        self.lanes_used += used
        self.lanes_total += total
        if deadline:
            self.deadline_flushes += 1
        else:
            self.full_flushes += 1

    def latency_ms(self, pct: float) -> float:
        return self._latencies_ms.percentile(pct)

    def snapshot(self, *, queue_depth: int = 0, **extra) -> dict:
        occ = self.lanes_used / self.lanes_total if self.lanes_total else 0.0
        out = {
            "queue_depth": queue_depth,
            "submitted": self.submitted,
            "completed": self.completed,
            "rejected": self.rejected,
            "batches": self.batches,
            "batch_occupancy": occ,
            "deadline_flushes": self.deadline_flushes,
            "full_flushes": self.full_flushes,
            "loop_handoffs": self.loop_handoffs,
            "errors": self.errors,
            "retries": self.retries,
            "shed": self.shed,
            "deadline_failures": self.deadline_failures,
            "restarts": self.restarts,
            "p50_latency_ms": self.latency_ms(50),
            "p99_latency_ms": self.latency_ms(99),
        }
        out.update(extra)
        return out
