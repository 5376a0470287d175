"""Supervised serving: a fault-tolerant control plane over engine workers
(the port's counterpart of the reference's ``runtime/supervisor.py``, with
its names, defaults and semantics).

One :class:`Supervisor` owns a model registry (``register()`` a
MarvelProgram under a name, with N workers each) and keeps the fleet
serving through worker failure:

* **routing** — ``submit()`` sends each request to the healthy worker with
  the fewest outstanding requests (least-outstanding; ties rotate
  round-robin); a request whose worker dies mid-flight comes back as
  :class:`~repro_torch.runtime.batching.WorkerUnavailable` and is transparently
  re-routed (bounded by ``max_failovers``), so an *accepted* request is
  never lost; a worker at admission capacity fails over to a sibling before
  shedding surfaces to the client.
* **graceful degradation** — when *every* healthy worker is saturated the
  fleet is in brownout: requests whose deadline slack is smaller than the
  estimated drain time shed immediately (``shed_brownout``), the rest
  surface backpressure honoring the workers' ``retry_after_ms`` hint.  A
  per-model :class:`CircuitBreaker` trips after K consecutive failed
  submits and fast-fails new work with
  :class:`~repro_torch.runtime.batching.AdmissionError` (+``retry_after_ms``)
  until a cooldown elapses, so a dying fleet sheds load instead of
  queueing doomed retries.
* **health checks** — a heartbeat loop pings every worker's compute thread
  (:meth:`AsyncCnnEngine.ping`) and feeds the round-trip into a per-worker
  :class:`~repro_torch.runtime.watchdog.StragglerWatchdog`; ``should_evict``
  (consecutive straggling heartbeats), a timed-out heartbeat, or a dead
  batcher task all trigger auto-recovery.
* **auto-recovery** — a dead/hung worker is killed (failing its unresolved
  futures into the re-route path above) and replaced by a fresh engine,
  with the warmup replayed from the recorded ``(shape, dtype)`` specs
  before it takes traffic — the program's shared bucket cache makes the
  replay a cache hit, so restarts add no bucket.
* **draining restarts** — ``restart_worker(name, drain=True)`` closes the
  worker's admission, flushes every in-flight request, then swaps in the
  replacement: a program hot-swap with zero dropped accepted requests.
* **metrics export** — ``metrics()`` aggregates per-worker snapshots;
  ``prometheus()`` renders the whole surface in Prometheus text format.

The lifecycle mirrors the xinference ``WorkerActor`` shape (launch /
terminate / recover-sub-pool); see ``docs/serving_ops.md`` for the ops
runbook.  Fault paths are driven deterministically by
:mod:`repro_torch.runtime.faults` — pass ``faults=`` at ``register()`` (an
injector shared by the model's workers, or a ``factory(worker_index)`` for
per-worker plans).

Process isolation
-----------------
``register(..., isolation="process", program_factory=...)`` puts each
worker in its own OS process (:class:`~repro_torch.runtime.actor.WorkerActor`):
the engine lives child-side behind a length-prefixed RPC channel, each
actor pins its CUDA device from a deterministic
:func:`~repro_torch.runtime.actor.allocation_plan` (workers share the one
card round-robin when they outnumber the cards), and crash detection rides
the process *sentinel* — a SIGKILLed worker fails its in-flight requests
into the same failover path the in-process tier uses, and the warm-handoff
respawn (replay recorded warmup specs, then reopen routing) is identical.
A replacement process is spawned only once the old one has been reaped, so
a frozen child's device memory is free before its successor allocates.
The in-process default (``isolation="inproc"``) is untouched.

In-process workers of one program share its device and its kernels'
per-device scratch (the split-K tile counters, the wkv flags); each engine
launches from its own compute thread on the device's current stream, the
legacy default stream, so their launches serialize.
"""
from __future__ import annotations

import asyncio
import inspect
from dataclasses import dataclass, field

from repro_torch.runtime import batching, faults as faults_mod
from repro_torch.runtime.batching import AdmissionError, WorkerUnavailable
from repro_torch.runtime.cnn_server import AsyncCnnEngine, CnnRequest
from repro_torch.runtime.watchdog import StragglerWatchdog


@dataclass
class WorkerHandle:
    """One supervised engine: the unit of health tracking and restart."""

    name: str
    model: str
    index: int
    engine: AsyncCnnEngine
    watchdog: StragglerWatchdog
    state: str = "starting"  # starting|healthy|draining|restarting|stopped
    restarts: int = 0
    heartbeats: int = 0


@dataclass
class _ModelEntry:
    """Registry row: everything needed to (re)spawn this model's workers."""

    name: str
    program: object
    workers: int
    engine_kwargs: dict
    mode: str = "async"  # "async" (CNN) | "lm" (continuous-batching decode)
    faults: object = None  # FaultInjector | factory(index) -> injector | None
    warmup_specs: list[tuple[tuple[int, ...], str]] = field(
        default_factory=list)
    isolation: str = "inproc"  # "inproc" | "process" (WorkerActor tier)
    program_factory: object = None  # picklable ref, rebuilt child-side
    factory_kwargs: dict = field(default_factory=dict)


class CircuitBreaker:
    """Per-model fast-fail switch over *submit-level* outcomes.

    A submit that exhausts its failovers (the caller sees
    :class:`WorkerUnavailable`) records one failure; any success resets.
    ``trip_after`` consecutive failures open the circuit: new submits
    fast-fail with :class:`AdmissionError` carrying the remaining cooldown
    as ``retry_after_ms`` — no queueing behind a fleet that cannot serve.
    After ``cooldown_ms`` the breaker goes half-open: the next submit is
    the probe; its outcome closes or re-opens the circuit.  Saturation
    (:class:`AdmissionError` from workers) never counts — overload is the
    brownout path's business, not the breaker's.
    """

    def __init__(self, trip_after: int = 8, cooldown_ms: float = 1_000.0):
        self.trip_after = trip_after
        self.cooldown_ms = cooldown_ms
        self.state = "closed"  # closed | open | half_open
        self.consecutive = 0
        self.trips = 0
        self._opened_at = 0.0

    def check(self, now: float) -> None:
        """Gate one submit: raises the fast-fail when open, arms the
        half-open probe when the cooldown has elapsed."""
        if self.state != "open":
            return
        remaining_ms = self.cooldown_ms - (now - self._opened_at) * 1e3
        if remaining_ms > 0:
            raise AdmissionError(
                f"circuit open: {self.consecutive} consecutive worker "
                f"failures; retry after cooldown",
                retry_after_ms=remaining_ms,
            )
        self.state = "half_open"

    def record_failure(self, now: float) -> bool:
        """One failed submit; returns True when this failure trips (or
        re-trips) the breaker open."""
        self.consecutive += 1
        if self.state == "half_open" or self.consecutive >= self.trip_after:
            was_open = self.state == "open"
            self.state = "open"
            self._opened_at = now
            if not was_open:
                self.trips += 1
                return True
        return False

    def record_success(self) -> None:
        self.consecutive = 0
        self.state = "closed"


class _FleetSaturated(Exception):
    """Internal: every healthy worker is in the excluded (saturated) set —
    the brownout ladder takes over.  Never escapes ``submit()``."""


class Supervisor:
    """The serving control plane: registry + health loop + request router."""

    def __init__(self, *,
                 heartbeat_interval_ms: float = 20.0,
                 hang_timeout_ms: float = 2_000.0,
                 heartbeat_floor_ms: float = 25.0,
                 straggler_threshold: float = 4.0,
                 evict_after: int = 3,
                 max_failovers: int = 8,
                 pick_timeout_ms: float = 10_000.0,
                 breaker_trip_after: int = 8,
                 breaker_cooldown_ms: float = 1_000.0):
        self.heartbeat_interval_ms = heartbeat_interval_ms
        self.hang_timeout_ms = hang_timeout_ms
        # heartbeats are floored before the EWMA so an idle worker's ~0 ms
        # round-trips don't make every normally-busy beat look straggling
        self.heartbeat_floor_ms = heartbeat_floor_ms
        self.straggler_threshold = straggler_threshold
        self.evict_after = evict_after
        self.max_failovers = max_failovers
        self.pick_timeout_ms = pick_timeout_ms
        self.breaker_trip_after = breaker_trip_after
        self.breaker_cooldown_ms = breaker_cooldown_ms
        self.workers: dict[str, WorkerHandle] = {}
        self._models: dict[str, _ModelEntry] = {}
        self._metrics = batching.EngineMetrics()  # control-plane counters
        # counters folded in from engines retired by restarts, so the
        # aggregate stays monotone across worker swaps
        self._retired: dict[str, float] = {}
        self.failovers = 0
        self.shed_brownout = 0
        self.process_restarts = 0  # restarts of process-isolated actors
        self._breakers: dict[str, CircuitBreaker] = {}
        self._health_task: asyncio.Task | None = None
        self._rr: dict[str, int] = {}
        self._uid = 0

    # -- registry / lifecycle ----------------------------------------------

    def register(self, name: str, program, *, workers: int = 1,
                 mode: str = "async",
                 warmup: tuple[int, ...] | None = None,
                 warmup_dtype: str = "float32",
                 faults=None, isolation: str = "inproc",
                 program_factory=None, factory_kwargs=None,
                 **engine_kwargs) -> None:
        """Add ``program`` to the registry as model ``name`` with
        ``workers`` engine workers.  ``mode`` picks the serving plane
        (``"async"`` CNN batcher, ``"lm"`` continuous-batching decode).
        ``warmup`` (the per-request input shape) is recorded so every
        worker — including replacements spawned by auto-recovery — is
        warmed before taking traffic (LM engines ignore the shape and warm
        their whole bucket ladder).

        ``isolation="process"`` spawns each worker as a
        :class:`~repro_torch.runtime.actor.WorkerActor` subprocess instead of an
        in-process engine; ``program`` may then be ``None`` and
        ``program_factory`` (a module-level callable, pickled by
        reference) + ``factory_kwargs`` describe how the child rebuilds
        its artifact (on ``factory_kwargs["device"]``, the card by
        default).  ``faults`` must be a declarative
        :class:`~repro_torch.runtime.faults.FaultPlan` (or a
        ``factory(worker_index)`` returning one) — live injectors cannot
        cross the process boundary."""
        if name in self._models:
            raise ValueError(f"model {name!r} already registered")
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        if isolation not in ("inproc", "process"):
            raise ValueError(
                f"isolation must be 'inproc' or 'process', got {isolation!r}")
        if isolation == "process" and program_factory is None:
            raise ValueError(
                "isolation='process' needs program_factory= (the child "
                "rebuilds the artifact; programs don't pickle)")
        entry = _ModelEntry(name=name, program=program, workers=workers,
                            engine_kwargs=dict(engine_kwargs), mode=mode,
                            faults=faults, isolation=isolation,
                            program_factory=program_factory,
                            factory_kwargs=dict(factory_kwargs or {}))
        if warmup is not None:
            entry.warmup_specs.append((tuple(warmup), warmup_dtype))
        self._models[name] = entry

    def _spawn_engine(self, entry: _ModelEntry, index: int) -> AsyncCnnEngine:
        if entry.isolation == "process":
            return self._spawn_actor(entry, index)
        injector = entry.faults
        if injector is not None and not hasattr(injector, "before_compute"):
            injector = injector(index)  # per-worker factory
        return entry.program.serve(mode=entry.mode, faults=injector,
                                   **entry.engine_kwargs)

    def _spawn_actor(self, entry: _ModelEntry, index: int):
        from repro_torch.runtime.actor import (
            ActorSpec, WorkerActor, allocation_plan, factory_platform,
        )

        plan = entry.faults
        if plan is not None and callable(plan) \
                and not isinstance(plan, faults_mod.FaultPlan):
            plan = plan(index)  # per-worker factory
        if isinstance(plan, faults_mod.FaultInjector):
            plan = plan.plan  # keep only the declarative part
        if plan is not None and not isinstance(plan, faults_mod.FaultPlan):
            raise TypeError(
                f"process-isolated faults must be a FaultPlan (or a factory "
                f"returning one), got {plan!r}")
        alloc = allocation_plan(
            entry.workers,
            platform=factory_platform(entry.factory_kwargs))[index]
        spec = ActorSpec(
            name=f"{entry.name}/{index}",
            program_factory=entry.program_factory,
            factory_kwargs=dict(entry.factory_kwargs),
            mode=entry.mode,
            engine_kwargs=dict(entry.engine_kwargs),
            allocation=alloc,
            fault_plan=plan,
            warmup_specs=list(entry.warmup_specs),
        )
        return WorkerActor(spec)

    async def _bring_up(self, wh: WorkerHandle) -> None:
        """Start + warm a (possibly replacement) engine, then open it for
        routing.  Actor warmups are awaitable (an RPC into the child — a
        cache hit when the spec rode along in the actor's birth spec); the
        warm handoff holds either way: the slot reopens only after every
        recorded spec is warm."""
        entry = self._models[wh.model]
        await wh.engine.start()
        for shape, dtype in entry.warmup_specs:
            r = wh.engine.warmup(shape, dtype)
            if inspect.isawaitable(r):
                await r
        wh.watchdog = StragglerWatchdog(threshold=self.straggler_threshold,
                                        evict_after=self.evict_after)
        wh.heartbeats = 0
        wh.state = "healthy"

    async def start(self) -> "Supervisor":
        if self._health_task is not None:
            return self
        if not self._models:
            raise RuntimeError("no models registered")
        for entry in self._models.values():
            for i in range(entry.workers):
                name = f"{entry.name}/{i}"
                wh = WorkerHandle(
                    name=name, model=entry.name, index=i,
                    engine=self._spawn_engine(entry, i),
                    watchdog=StragglerWatchdog(
                        threshold=self.straggler_threshold,
                        evict_after=self.evict_after),
                )
                self.workers[name] = wh
                await self._bring_up(wh)
        self._health_task = asyncio.get_running_loop().create_task(
            self._health_loop()
        )
        return self

    async def stop(self) -> None:
        task, self._health_task = self._health_task, None
        if task is not None:
            # cancel until it sticks: 3.10's wait_for can swallow a cancel
            # that lands on the same loop step a ping completes
            # (bpo-37658), and the heartbeat pings constantly — one cancel
            # is not guaranteed to terminate the loop
            while not task.done():
                task.cancel()
                await asyncio.wait({task}, timeout=0.1)
            if not task.cancelled():
                task.exception()  # consume, so it never logs as unretrieved
        for wh in self.workers.values():
            if wh.engine.is_alive:
                await wh.engine.stop()  # draining stop: flush everything
            wh.state = "stopped"

    async def __aenter__(self) -> "Supervisor":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    # -- routing ------------------------------------------------------------

    def _resolve_model(self, model: str | None) -> str:
        if model is not None:
            if model not in self._models:
                raise KeyError(
                    f"unknown model {model!r}; registered: "
                    f"{sorted(self._models)}"
                )
            return model
        if len(self._models) != 1:
            raise ValueError(
                f"pass model= explicitly; registered: {sorted(self._models)}"
            )
        return next(iter(self._models))

    def healthy_workers(self, model: str | None = None) -> list[WorkerHandle]:
        return [wh for wh in self.workers.values()
                if (model is None or wh.model == model)
                and wh.state == "healthy" and wh.engine.is_alive]

    async def _pick(self, model: str,
                    exclude: frozenset | set = frozenset()) -> WorkerHandle:
        """Least-outstanding over the model's healthy workers (ties rotate
        round-robin, so an idle fleet still alternates); when none is
        healthy (mid-recovery), poll until one comes back or the pick
        timeout expires.  ``exclude`` holds this submit's already-saturated
        workers: when every healthy worker is excluded the fleet is in
        brownout and :class:`_FleetSaturated` hands control to the shedding
        ladder instead of polling."""
        loop = asyncio.get_running_loop()
        deadline = loop.time() + self.pick_timeout_ms / 1e3
        while True:
            healthy = self.healthy_workers(model)
            if healthy:
                avail = [wh for wh in healthy if wh.name not in exclude]
                if not avail:
                    raise _FleetSaturated(model)
                i = self._rr[model] = self._rr.get(model, -1) + 1
                return min(
                    enumerate(avail),
                    key=lambda kv: (
                        getattr(kv[1].engine, "outstanding", 0),
                        (kv[0] - i) % len(avail),
                    ),
                )[1]
            if loop.time() >= deadline:
                raise WorkerUnavailable(
                    f"no healthy worker for model {model!r} within "
                    f"{self.pick_timeout_ms:.0f} ms"
                )
            await asyncio.sleep(self.heartbeat_interval_ms / 1e3)

    def _breaker(self, model: str) -> CircuitBreaker:
        if model not in self._breakers:
            self._breakers[model] = CircuitBreaker(
                trip_after=self.breaker_trip_after,
                cooldown_ms=self.breaker_cooldown_ms)
        return self._breakers[model]

    def _brownout(self, model: str, deadline_ms: float | None,
                  errs: list[AdmissionError]) -> None:
        """Every healthy worker reported saturation: shed or backpressure.

        Lowest-deadline-slack first: a request that cannot possibly wait
        out the estimated drain (its ``deadline_ms`` slack is smaller than
        the smallest ``retry_after_ms`` any worker quoted) sheds now —
        burning queue time on it would only delay requests that *can* still
        make their deadlines.  Everything else surfaces backpressure with
        the workers' own ``retry_after_ms`` hint, honored only here, when
        no sibling could take the request instead."""
        hints = [e.retry_after_ms for e in errs
                 if getattr(e, "retry_after_ms", None) is not None]
        retry_after = min(hints) if hints else None
        if (deadline_ms is not None and retry_after is not None
                and deadline_ms < retry_after):
            self.shed_brownout += 1
            raise AdmissionError(
                f"brownout: model {model!r} fleet saturated and deadline "
                f"slack {deadline_ms:.0f} ms < estimated drain "
                f"{retry_after:.0f} ms",
                retry_after_ms=retry_after,
            )
        if errs:
            raise errs[-1]
        raise AdmissionError(
            f"model {model!r}: all workers saturated",
            retry_after_ms=retry_after,
        )

    async def submit(self, payload, *, model: str | None = None,
                     deadline_ms: float | None = None,
                     **req_kwargs) -> CnnRequest:
        """Route one request to a healthy worker and await its result.

        ``payload`` is whatever the model's plane consumes — an image array
        for ``mode="async"``, a token-id prompt for ``mode="lm"`` (with
        ``max_new_tokens`` / ``eos_id`` forwarded via ``req_kwargs``).

        A worker dying mid-flight (:class:`WorkerUnavailable`) re-routes the
        request — the accepted request survives the crash; LM workers replay
        the full prompt on the replacement, so the re-routed stream is the
        stream the dead worker would have produced.  A worker at admission
        capacity (:class:`AdmissionError`) fails over to the next healthy
        sibling; only when *all* healthy workers are saturated does
        backpressure surface, through the brownout ladder (shed
        lowest-deadline-slack, else honor ``retry_after_ms``).  Genuine
        request failures (compute errors after bisection/eviction, missed
        deadlines) propagate to the caller: retrying those elsewhere would
        just fail again.  The model's circuit breaker gates entry: while
        open, submits fast-fail instead of queueing behind a dying fleet."""
        model = self._resolve_model(model)
        loop = asyncio.get_running_loop()
        breaker = self._breaker(model)
        breaker.check(loop.time())  # AdmissionError fast-fail while open
        uid, self._uid = self._uid, self._uid + 1
        last_err: Exception | None = None
        saturated: set[str] = set()
        admission_errs: list[AdmissionError] = []
        for _ in range(self.max_failovers + 1):
            try:
                wh = await self._pick(model, exclude=saturated)
            except _FleetSaturated:
                self._brownout(model, deadline_ms, admission_errs)  # raises
            except WorkerUnavailable:
                breaker.record_failure(loop.time())
                raise
            try:
                req = await wh.engine.submit(payload, uid=uid,
                                             deadline_ms=deadline_ms,
                                             **req_kwargs)
                breaker.record_success()
                return req
            except WorkerUnavailable as e:
                last_err = e
                self.failovers += 1
            except AdmissionError as e:
                # saturation, not failure: exclude this worker and try a
                # sibling; the breaker never counts overload
                admission_errs.append(e)
                saturated.add(wh.name)
                self.failovers += 1
        breaker.record_failure(loop.time())
        raise WorkerUnavailable(
            f"request uid={uid} still unrouted after "
            f"{self.max_failovers} failovers"
        ) from last_err

    async def submit_wave(self, payloads, *, model: str | None = None,
                          return_exceptions: bool = False,
                          **req_kwargs) -> list:
        return await asyncio.gather(
            *(self.submit(p, model=model, **req_kwargs) for p in payloads),
            return_exceptions=return_exceptions,
        )

    # -- health + recovery --------------------------------------------------

    async def _ping(self, engine: AsyncCnnEngine) -> float | None:
        """Heartbeat round-trip through the worker's compute thread, in ms
        (``None`` = timed out or pool gone: the worker is hung/dead).

        Deliberately built on ``asyncio.wait`` rather than ``wait_for``:
        3.10's ``wait_for`` can swallow the health task's cancellation when
        it races a completing ping (bpo-37658), which would leave ``stop()``
        awaiting a task that never exits."""
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        try:
            p = engine.ping()
        except (WorkerUnavailable, RuntimeError):
            return None
        # in-process engines hand back a concurrent future through the
        # compute thread; actors hand back a coroutine (one RPC round-trip
        # through the child) — same timeout/cancel discipline either way
        fut = (asyncio.ensure_future(p) if inspect.isawaitable(p)
               else asyncio.wrap_future(p))
        try:
            done, _ = await asyncio.wait(
                {fut}, timeout=self.hang_timeout_ms / 1e3
            )
        except asyncio.CancelledError:
            # the health task itself is being cancelled (stop()): propagate
            fut.cancel()
            raise
        if not done:
            fut.cancel()
            return None  # hang timeout
        try:
            fut.result()
        except (asyncio.CancelledError, WorkerUnavailable, RuntimeError):
            # a concurrent kill() shut the pool and cancelled the ping
            return None
        return (loop.time() - t0) * 1e3

    async def _health_loop(self) -> None:
        while True:
            await asyncio.sleep(self.heartbeat_interval_ms / 1e3)
            for wh in list(self.workers.values()):
                if wh.state != "healthy":
                    continue  # draining/restarting workers are off-plane
                if not wh.engine.is_alive:
                    await self._recover(wh, "worker died")
                    continue
                dt_ms = await self._ping(wh.engine)
                if dt_ms is None:
                    await self._recover(wh, "heartbeat timed out (hung)")
                    continue
                wh.heartbeats += 1
                wh.watchdog.observe(
                    wh.heartbeats,
                    max(dt_ms, self.heartbeat_floor_ms) / 1e3,
                )
                if wh.watchdog.should_evict:
                    await self._recover(
                        wh, f"{wh.watchdog.consecutive} consecutive "
                            f"straggling heartbeats"
                    )

    async def _recover(self, wh: WorkerHandle, reason: str) -> None:
        """Auto-recovery: kill the worker (its unresolved futures fail with
        WorkerUnavailable and re-route via submit()), spawn + warm a
        replacement, reopen routing."""
        wh.state = "restarting"
        wh.engine.kill(reason)
        reaped = getattr(wh.engine, "wait_reaped", None)
        if reaped is not None:
            await reaped()  # a frozen child's memory is free before respawn
        self._retire_counters(wh)
        self._replay_specs(wh)
        entry = self._models[wh.model]
        wh.engine = self._spawn_engine(entry, wh.index)
        wh.restarts += 1
        self._metrics.restarts += 1
        if entry.isolation == "process":
            self.process_restarts += 1
        await self._bring_up(wh)

    def _replay_specs(self, wh: WorkerHandle) -> None:
        """Fold the dead engine's actually-warmed specs into the registry so
        the replacement replays them even if the caller warmed ad hoc."""
        entry = self._models[wh.model]
        for spec in wh.engine.compute.warmed:
            if spec not in entry.warmup_specs:
                entry.warmup_specs.append(spec)

    def _retire_counters(self, wh: WorkerHandle) -> None:
        """Keep the retiring engine's counters: a restart must never make
        the aggregate go backwards."""
        snap = wh.engine.metrics()
        for k in self._SUMMED:
            if k in self._GAUGES:
                continue  # gauges, not counters; they die with the engine
            self._retired[k] = self._retired.get(k, 0) + snap.get(k, 0)

    async def restart_worker(self, name: str, *, drain: bool = True) -> None:
        """Hot-swap one worker.  ``drain=True`` (the default) is the
        zero-drop path: close admission, flush every accepted in-flight
        request, then swap — nothing accepted is dropped or re-routed.
        ``drain=False`` is an immediate kill: in-flight requests fail over
        through ``submit()`` instead."""
        wh = self.workers[name]
        if drain:
            wh.state = "draining"  # routing skips it; accepted work finishes
            await wh.engine.stop()
            self._retire_counters(wh)
            self._replay_specs(wh)
            entry = self._models[wh.model]
            wh.engine = self._spawn_engine(entry, wh.index)
            wh.restarts += 1
            self._metrics.restarts += 1
            if entry.isolation == "process":
                self.process_restarts += 1
            wh.state = "restarting"
            await self._bring_up(wh)
        else:
            await self._recover(wh, "restart requested")

    # -- observability ------------------------------------------------------

    # counters: summed across workers, folded into _retired on restart so
    # the aggregate stays monotone (includes the LM plane's token/replay/
    # compile-cache counters; CNN snapshots simply lack those keys -> 0)
    _SUMMED = ("submitted", "completed", "rejected", "batches",
               "deadline_flushes", "full_flushes", "loop_handoffs", "errors",
               "retries", "shed", "deadline_failures",
               "tokens_total", "prefill_tokens", "decode_steps", "replays",
               "compile_hits", "compile_misses", "kv_slot_reuses",
               "queue_depth", "running_sequences", "kv_slots_used",
               "kv_slots_total", "kv_cache_bytes", "tokens_per_s")
    # gauges within _SUMMED: summed across *live* workers for the fleet
    # view but never retired — a dead engine's queue/slots/throughput are
    # gone, not conserved
    _GAUGES = frozenset({"queue_depth", "running_sequences",
                         "kv_slots_used", "kv_slots_total",
                         "kv_cache_bytes", "tokens_per_s"})
    # percentiles: reservoirs don't merge exactly, so the aggregate takes
    # the worst worker (an upper bound); rpc_roundtrip_* only exist on
    # process-isolated workers (parent-measured RPC round-trips)
    _MAXED = ("p50_latency_ms", "p99_latency_ms", "ttft_p50_ms",
              "ttft_p99_ms", "intertoken_p50_ms", "intertoken_p99_ms",
              "rpc_roundtrip_p50_ms", "rpc_roundtrip_p99_ms")

    def metrics(self) -> dict:
        """Per-worker snapshots + the aggregate the fleet dashboards read.

        Counters sum across workers; latency/TTFT/inter-token percentiles
        take the worst worker; the supervisor adds its own ``restarts`` /
        ``failovers``, the healthy-worker gauge, and the derived fleet
        ``kv_slot_occupancy``."""
        per_worker = {}
        for wh in self.workers.values():
            snap = wh.engine.metrics()
            snap["restarts"] = wh.restarts
            snap["state"] = wh.state
            per_worker[wh.name] = snap
        agg: dict = {k: self._retired.get(k, 0) for k in self._SUMMED}
        for snap in per_worker.values():
            for k in self._SUMMED:
                agg[k] += snap.get(k, 0)
        for k in self._MAXED:
            agg[k] = max(
                (s[k] for s in per_worker.values() if k in s), default=0.0)
        agg["kv_slot_occupancy"] = (
            agg["kv_slots_used"] / agg["kv_slots_total"]
            if agg["kv_slots_total"] else 0.0)
        agg["restarts"] = self._metrics.restarts
        agg["failovers"] = self.failovers
        agg["healthy_workers"] = len(self.healthy_workers())
        agg["workers_total"] = len(self.workers)
        # degradation-ladder surface: brownout sheds, process-level
        # restarts, and the breaker state (open count + lifetime trips)
        agg["shed_brownout"] = self.shed_brownout
        agg["worker_process_restarts"] = self.process_restarts
        agg["circuit_open"] = sum(
            1 for b in self._breakers.values() if b.state == "open")
        agg["circuit_trips"] = sum(b.trips for b in self._breakers.values())
        return {"aggregate": agg, "workers": per_worker}

    def prometheus(self) -> str:
        """The whole metrics surface in Prometheus text exposition format:
        aggregate samples unlabelled, per-worker samples labelled
        ``{model=...,worker=...}``, plus a per-worker health gauge."""
        m = self.metrics()
        keys = list(m["aggregate"])
        lines: list[str] = []
        for key in keys:
            lines.append(f"# TYPE marvel_serving_{key} gauge")
            lines.append(f"marvel_serving_{key} {m['aggregate'][key]}")
            for wname, snap in m["workers"].items():
                if key not in snap:
                    continue
                model = self.workers[wname].model
                lines.append(
                    f'marvel_serving_{key}{{model="{model}",'
                    f'worker="{wname}"}} {snap[key]}'
                )
        lines.append("# TYPE marvel_serving_worker_healthy gauge")
        for wname, snap in m["workers"].items():
            model = self.workers[wname].model
            healthy = 1 if snap["state"] == "healthy" else 0
            lines.append(
                f'marvel_serving_worker_healthy{{model="{model}",'
                f'worker="{wname}"}} {healthy}'
            )
        return "\n".join(lines) + "\n"
