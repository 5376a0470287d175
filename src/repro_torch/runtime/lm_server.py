"""Continuous-batching LM serving over slot-indexed KV caches (the
counterpart of the reference's ``runtime/lm_server.py``).

Two planes share one decode core, mirroring
:mod:`repro_torch.runtime.cnn_server`:

* :class:`ContinuousBatchEngine` — the synchronous engine: callers submit
  prompts, then drive ``step()``/``run_until_drained()`` themselves.
* :class:`AsyncLmEngine` — the serving tier: an asyncio request plane
  (bounded admission -> per-request futures) over a background step loop on
  one compute thread, with the same ``start/stop/kill/ping`` worker surface
  the supervisor drives for CNN workers.

Continuous batching
-------------------
The engine admits requests into a *running* decode batch: a new sequence
prefills into any free KV slot and decodes alongside sequences admitted many
steps earlier; a finished sequence (EOS / token budget) evicts mid-flight
and frees its slot for the next arrival.  There is no wave barrier — the
batch never waits for its slowest member.

Slots and buckets come from
:class:`repro_torch.runtime.kvcache.KVCacheManager`; because ``decode_step``
is slot-indexed (per-lane position + kv_len masking), one ``(bucket_len,
slots)`` executable serves every arrival pattern.  PyTorch runs eagerly, so
an "executable" is the table-bound decode step for that bucket, made once
and kept in the exec cache; the engine's ``compile_hits``/
``compile_misses`` counters prove that no new bucket appears after
:meth:`warmup`.  Capturing each bucket as a CUDA graph is later work.

Failure semantics
-----------------
Admission is bounded (:class:`~repro_torch.runtime.batching.AdmissionError`
with a ``retry_after_ms`` hint); queued requests whose deadline expires
fast-fail (:class:`~repro_torch.runtime.batching.DeadlineExceeded`).  A
failing decode step retries with backoff; if it keeps failing with >1
active lane, the engine's *eviction bisection* — the LM analogue of batch
bisection — evicts half the lanes back to the queue head with their **full
prompts replayed** (greedy decode is deterministic, so a replayed request
yields the same tokens), so a poison lane is isolated without losing
innocent co-batched sequences.
:class:`~repro_torch.runtime.faults.WorkerDeath` kills the worker: the async
plane fails every accepted-but-unresolved future with
:class:`~repro_torch.runtime.batching.WorkerUnavailable`, and the supervisor
re-routes those requests — again with full prompts, never a truncated
suffix — to a healthy sibling.
"""
from __future__ import annotations

import asyncio
import concurrent.futures
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, RunConfig
from repro_torch.models import transformer as T
from repro_torch.runtime import batching, faults
from repro_torch.runtime.batching import (  # re-exports  # noqa: F401
    AdmissionError, DeadlineExceeded, RetryPolicy, WorkerUnavailable,
)
from repro_torch.runtime.kvcache import (
    KVCacheManager, SequenceTooLong, length_buckets,
)


def _executable(decode_fn):
    """One bucket's executable: the decode step without autograd."""
    def run(params, state, tokens):
        with torch.inference_mode():
            return decode_fn(params, state, tokens)

    return run


def static_decode(decode_fn, state, prompts, max_new, vocab):
    """The static padded-batch reference the engine's streams are held
    against: every prompt starts at step 0 in its own lane of one
    fixed-shape batch (``state``'s, with one lane per prompt or more),
    teacher-forced through its prompt, then greedy-decoded; a finished lane
    idles.  Returns the token streams."""
    n = len(prompts)
    dev = state["index"].device
    toks = np.zeros((state["index"].shape[0], 1), np.int32)
    for i, p in enumerate(prompts):
        toks[i, 0] = p[0]
    pos = [0] * n
    gen: list[list[int]] = [[] for _ in range(n)]
    with torch.inference_mode():
        while any(len(g) < max_new for g in gen):
            logits, state = decode_fn(state, torch.tensor(toks, device=dev))
            sampled = logits[:, 0, :vocab].argmax(dim=-1).cpu().numpy()
            for i in range(n):
                if len(gen[i]) >= max_new:
                    continue
                pos[i] += 1
                if pos[i] < len(prompts[i]):
                    toks[i, 0] = prompts[i][pos[i]]
                    continue
                gen[i].append(int(sampled[i]))
                toks[i, 0] = sampled[i]
    return gen


@dataclass
class LmRequest:
    uid: int
    prompt: list[int]
    max_new_tokens: int = 16
    eos_id: int = -1  # -1: never
    generated: list[int] = field(default_factory=list)
    done: bool = False
    error: Exception | None = None
    latency_ms: float = 0.0
    ttft_ms: float = 0.0  # time to first generated token
    replays: int = 0  # eviction-bisection requeues (full prompt replayed)
    lane: tuple[int, int] | None = None  # (bucket_len, slot) last admitted to
    _t0: float = 0.0
    _deadline: float | None = None  # absolute perf_counter seconds

    @property
    def total_len(self) -> int:
        return len(self.prompt) + self.max_new_tokens


@dataclass
class _Seq:
    """One running sequence: its request + per-slot decode bookkeeping."""

    req: LmRequest
    pos: int = 0  # prompt tokens consumed (teacher-forced prefill)
    last_t: float = 0.0  # perf_counter of the previous generated token


class ContinuousBatchEngine:
    """Queue -> per-step slot join/leave -> slot-indexed decode_step ->
    per-request token streams (synchronous plane; the caller drives
    ``step()``)."""

    def __init__(self, params, cfg: ArchConfig, run: RunConfig, *,
                 table=None, slots: int = 4, max_len: int = 128,
                 bucket_lens: tuple[int, ...] = (),
                 kv_quant: str | None = None,
                 max_pending: int | None = None,
                 retry: batching.RetryPolicy | None = None,
                 faults: faults.FaultInjector | None = None,
                 exec_cache: dict | None = None):
        self.params = params
        self.cfg = cfg
        self.run = run
        self.slots = int(slots)
        self.kv_quant = kv_quant
        self.retry = retry or batching.RetryPolicy()
        self.faults = faults
        self.device = params["embed"]["table"].device
        if not bucket_lens:
            bucket_lens = length_buckets(max_len)
        # the decode fn of every bucket: table-bound when this engine serves
        # a MarvelProgram (the resolved extension table is active on every
        # call, exactly like the CNN path)
        base = lambda p, s, t: T.decode_step(p, s, t, cfg, run)  # noqa: E731
        self._decode_fn = table.bind(base) if table is not None else base
        self.manager = KVCacheManager(
            lambda batch, cache_len: T.init_decode_state(
                params, cfg, run, batch=batch, max_len=cache_len,
                kv_quant=kv_quant,
            ),
            bucket_lens=tuple(bucket_lens), slots=self.slots,
            kv_quant=kv_quant,
        )
        self.queue = batching.BoundedQueue(capacity=max_pending)
        # (bucket_len, slots, kv_quant) -> decode step.  Shared across every
        # engine of the same program (a replacement engine warms from cache
        # hits).
        self._exec = exec_cache if exec_cache is not None else {}
        self.compile_hits = 0
        self.compile_misses = 0
        self._active: dict[int, dict[int, _Seq]] = {}  # bucket -> slot -> seq
        self._tokens: dict[int, np.ndarray] = {}  # bucket -> (slots,1) int32
        self._metrics = batching.EngineMetrics()
        self._ttft = batching.Reservoir()
        self._intertoken = batching.Reservoir()
        self.tokens_total = 0
        self.prefill_tokens = 0
        self.decode_steps = 0
        self.replays_total = 0
        self._busy_s = 0.0
        # eviction-bisection latch: while isolating a poison lane, evicted
        # requests must NOT rejoin the suspect batch — admission reopens
        # after a successful step (or once the suspects all drain)
        self._isolating = False
        # warmed marker specs, same shape the supervisor replays on
        # replacement workers ((in_shape, dtype) tuples; LM warmup is
        # shape-independent so one marker covers the whole bucket ladder)
        self.warmed: list[tuple[tuple[int, ...], str]] = []

    # -- compile cache -------------------------------------------------------

    def _fn_for(self, bucket_len: int):
        key = (bucket_len, self.slots, self.kv_quant)
        fn = self._exec.get(key)
        if fn is None:
            self.compile_misses += 1
            fn = _executable(self._decode_fn)
            self._exec[key] = fn
        else:
            self.compile_hits += 1
        return fn

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warmup(self, in_shape=None, dtype=None) -> None:
        """Make AND prime every (bucket_len, slots) executable before the
        first request (no new bucket after this — the engine's
        compile-cache counters assert it).  ``in_shape``/``dtype`` are
        accepted for supervisor warmup-replay parity and ignored: LM warmup
        is shape-independent.  The step's result is discarded: the pool
        keeps its index, and the K/V rows it wrote at each lane's index are
        rewritten by that lane's next real step before they are read (a
        recurrent cache comes back in new tensors and the pool's is left as
        it was)."""
        del in_shape, dtype
        toks = torch.zeros((self.slots, 1), dtype=torch.int32,
                           device=self.device)
        for b in self.manager.bucket_lens:
            pool = self.manager._pool(b)
            fn = self._fn_for(b)
            fn(self.params, pool.state, toks)
            self._sync()
        spec = ((), "int32")
        if spec not in self.warmed:
            self.warmed.append(spec)

    # -- request plane -------------------------------------------------------

    def submit(self, prompt, *, uid: int | None = None,
               max_new_tokens: int = 16, eos_id: int = -1,
               deadline_ms: float | None = None) -> LmRequest:
        """Admit one prompt (or raise :class:`AdmissionError` /
        :class:`SequenceTooLong`); the request joins the running batch at
        the next ``step()`` with a free slot."""
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        if not prompt:
            raise ValueError("empty prompt")
        if uid is None:
            uid = self._metrics.submitted
        req = LmRequest(uid=uid, prompt=prompt, max_new_tokens=max_new_tokens,
                        eos_id=eos_id)
        # reject sequences no bucket can ever hold at admission, not after
        # they reach the head of the queue
        self.manager.bucket_for(req.total_len)
        req._t0 = time.perf_counter()
        if deadline_ms is not None:
            req._deadline = req._t0 + deadline_ms / 1e3
        self.queue.push(req)  # AdmissionError surfaces to the caller
        self._metrics.submitted += 1
        return req

    def _fail(self, req: LmRequest, err: Exception,
              finished: list[LmRequest]) -> None:
        req.error = err
        req.done = False
        self._metrics.errors += 1
        finished.append(req)

    def _admit(self, now: float, finished: list[LmRequest]) -> None:
        """Join queued requests into free slots of the running batch."""
        while self.queue:
            req = self.queue.peek()
            if req._deadline is not None and now > req._deadline:
                self.queue.popleft()
                self._metrics.deadline_failures += 1
                self._fail(req, DeadlineExceeded(
                    f"request uid={req.uid} missed its deadline before "
                    f"joining the batch"), finished)
                continue
            if self._isolating:
                break  # bisection in progress: hold arrivals out of it
            try:
                alloc = self.manager.alloc(req.uid, req.total_len)
            except SequenceTooLong as e:
                self.queue.popleft()
                self._fail(req, e, finished)
                continue
            if alloc is None:
                break  # every eligible slot is occupied; stay queued
            self.queue.popleft()
            bucket_len, slot = alloc
            req.lane = alloc
            seq = _Seq(req=req, last_t=now)
            self._active.setdefault(bucket_len, {})[slot] = seq
            tokens = self._tokens.get(bucket_len)
            if tokens is None:
                tokens = self._tokens[bucket_len] = np.zeros(
                    (self.slots, 1), np.int32)
            tokens[slot, 0] = req.prompt[0]

    # -- decode plane --------------------------------------------------------

    def _requeue_evicted(self, bucket_len: int, slots_to_evict: list[int],
                         err: Exception, finished: list[LmRequest]) -> None:
        """Eviction bisection: push evicted lanes back to the queue head for
        a full-prompt replay (greedy decode makes the replay exact), unless
        their split budget ran out — then they fail with the decode error."""
        act = self._active[bucket_len]
        for slot in slots_to_evict:
            seq = act.pop(slot)
            self.manager.release(bucket_len, slot)
            self._tokens[bucket_len][slot, 0] = 0
            req = seq.req
            req.generated = []  # replay from scratch — nothing truncated
            if (self.retry.max_splits is not None
                    and req.replays >= self.retry.max_splits):
                self._fail(req, err, finished)
                continue
            req.replays += 1
            self.replays_total += 1
            self.queue.push_front(req)
        self._isolating = True

    def _step_bucket(self, bucket_len: int,
                     finished: list[LmRequest]) -> bool:
        """Decode one token for this bucket's active lanes; returns True on
        a successful compute (False: lanes were evicted or failed)."""
        act = self._active.get(bucket_len)
        if not act:
            return False
        pool = self.manager.pools[bucket_len]
        tokens = self._tokens[bucket_len]
        fn = self._fn_for(bucket_len)
        uids = tuple(seq.req.uid for seq in act.values())
        err: Exception | None = None
        logits = new_state = None
        for attempt in range(self.retry.max_retries + 1):
            try:
                if self.faults is not None:
                    self.faults.before_compute(uids)
                logits, new_state = fn(
                    self.params, pool.state,
                    torch.tensor(tokens, device=self.device))
                err = None
                break
            except faults.WorkerDeath:
                raise  # the worker is dying, not the batch
            except Exception as e:
                err = e
                if attempt < self.retry.max_retries:
                    self._metrics.retries += 1
                    time.sleep(self.retry.backoff_ms(attempt) / 1e3)
        if err is not None:
            slots_sorted = sorted(act)
            if len(slots_sorted) > 1:
                # evict the back half; the front half retries next step —
                # recursive halving isolates a poison lane in log2 steps
                half = slots_sorted[len(slots_sorted) // 2:]
                self._requeue_evicted(bucket_len, half, err, finished)
            else:
                slot = slots_sorted[0]
                seq = act.pop(slot)
                self.manager.release(bucket_len, slot)
                tokens[slot, 0] = 0
                self._fail(seq.req, err, finished)
            return False
        pool.state = new_state
        self.decode_steps += 1
        self._metrics.observe_batch(len(act), self.slots)
        # argmax takes the first maximum, as jnp.argmax does
        sampled = logits[:, 0, : self.cfg.vocab].argmax(dim=-1).to(
            torch.int32).cpu().numpy()
        now = time.perf_counter()
        for slot, seq in list(act.items()):
            req = seq.req
            seq.pos += 1
            if seq.pos < len(req.prompt):
                # still teacher-forcing the prompt (prefill-by-decode)
                tokens[slot, 0] = req.prompt[seq.pos]
                self.prefill_tokens += 1
                continue
            tok = int(sampled[slot])
            if not req.generated:
                req.ttft_ms = (now - req._t0) * 1e3
                self._ttft.observe(req.ttft_ms)
            else:
                self._intertoken.observe((now - seq.last_t) * 1e3)
            seq.last_t = now
            req.generated.append(tok)
            tokens[slot, 0] = tok
            self.tokens_total += 1
            total = len(req.prompt) + len(req.generated)
            if (tok == req.eos_id
                    or len(req.generated) >= req.max_new_tokens
                    or total >= bucket_len):
                req.done = True
                req.latency_ms = (now - req._t0) * 1e3
                self._metrics.completed += 1
                self._metrics.observe_latency(req.latency_ms)
                act.pop(slot)
                self.manager.release(bucket_len, slot)
                tokens[slot, 0] = 0
                finished.append(req)
        return True

    def step(self) -> list[LmRequest]:
        """One engine step: admit arrivals into free slots, then decode one
        token for every active lane of every live bucket.  Returns the
        requests that finished (``done`` or ``.error`` set) this step.
        Only :class:`~repro_torch.runtime.faults.WorkerDeath` raises — the worker
        itself is gone, which the async plane turns into
        :class:`WorkerUnavailable` failover."""
        t0 = time.perf_counter()
        finished: list[LmRequest] = []
        self._admit(t0, finished)
        ok = False
        for bucket_len in sorted(self._active):
            ok = self._step_bucket(bucket_len, finished) or ok
        if ok or self.running == 0:
            self._isolating = False  # suspects cleared (or all drained)
        self._busy_s += time.perf_counter() - t0
        return finished

    @property
    def running(self) -> int:
        """Sequences currently holding a KV slot."""
        return sum(len(a) for a in self._active.values())

    @property
    def active(self) -> int:
        return self.running + len(self.queue)

    def run_until_drained(self, max_steps: int = 100_000) -> list[LmRequest]:
        out: list[LmRequest] = []
        steps = 0
        while self.active and steps < max_steps:
            out.extend(self.step())
            steps += 1
        return out

    # -- observability -------------------------------------------------------

    def ttft_ms(self, pct: float) -> float:
        return self._ttft.percentile(pct)

    def intertoken_ms(self, pct: float) -> float:
        return self._intertoken.percentile(pct)

    @property
    def tokens_per_s(self) -> float:
        return self.tokens_total / self._busy_s if self._busy_s else 0.0

    def metrics(self) -> dict:
        """The LM serving metrics surface: the shared engine counters plus
        token throughput, TTFT / inter-token percentiles, KV-slot ledger,
        and the compile-cache proof of zero recompiles."""
        self._metrics.rejected = self.queue.rejected
        extra = {
            "tokens_total": self.tokens_total,
            "prefill_tokens": self.prefill_tokens,
            "decode_steps": self.decode_steps,
            "tokens_per_s": self.tokens_per_s,
            "running_sequences": self.running,
            "ttft_p50_ms": self.ttft_ms(50),
            "ttft_p99_ms": self.ttft_ms(99),
            "intertoken_p50_ms": self.intertoken_ms(50),
            "intertoken_p99_ms": self.intertoken_ms(99),
            "compile_hits": self.compile_hits,
            "compile_misses": self.compile_misses,
            "replays": self.replays_total,
        }
        extra.update(self.manager.metrics())
        return self._metrics.snapshot(queue_depth=len(self.queue), **extra)


class AsyncLmEngine:
    """The async LM serving tier: request plane decoupled from the decode
    loop, with the same worker surface the supervisor drives for CNN
    engines (``start/stop/kill/is_alive/submit/ping/warmup/metrics`` and
    ``.compute.warmed``).

    ``submit()`` applies admission control over every accepted-but-
    unresolved request (queued, decoding, or finishing); a background
    stepper drives :meth:`ContinuousBatchEngine.step` on one compute thread
    whenever work exists, so sequences join and leave the running batch with
    no wave barriers and the event loop never blocks on a decode step.
    :meth:`kill` fails every unresolved future with
    :class:`WorkerUnavailable`; because each future carries its request's
    *full* prompt, supervisor failover replays entire prompts on a sibling —
    a crashed worker can never silently truncate a sequence.
    """

    def __init__(self, params, cfg: ArchConfig, run: RunConfig, *,
                 max_pending: int = 1024, **engine_kwargs):
        self.engine = ContinuousBatchEngine(
            params, cfg, run, max_pending=None, **engine_kwargs)
        self.max_pending = max_pending
        self._inbox: list[tuple[LmRequest, asyncio.Future]] = []
        self._futs: dict[int, asyncio.Future] = {}  # uid -> future
        self._unresolved: set = set()
        self._live_reqs = 0
        self._stepper: asyncio.Task | None = None
        self._pool: concurrent.futures.ThreadPoolExecutor | None = None
        self._wake: asyncio.Event | None = None
        self._closing = False
        self._killed: str | None = None
        self._uid = 0

    # -- lifecycle -----------------------------------------------------------

    async def start(self) -> "AsyncLmEngine":
        if self._stepper is None and self._killed is None:
            self._pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="lm-decode"
            )
            self._wake = asyncio.Event()
            self._closing = False
            self._stepper = asyncio.get_running_loop().create_task(
                self._run_stepper()
            )
        return self

    async def stop(self) -> None:
        """Draining stop: close admission, finish every accepted sequence,
        then shut the compute thread down."""
        if self._stepper is not None:
            self._closing = True
            self._wake.set()
            await self._stepper
            self._stepper = None
            self._pool.shutdown(wait=True)
            self._pool = None

    def kill(self, reason: str = "killed") -> None:
        """Abrupt worker death: every accepted-but-unresolved request fails
        with :class:`WorkerUnavailable` so a supervisor re-routes it (full
        prompt, from scratch) to a healthy sibling."""
        if self._killed is not None:
            return
        self._killed = reason
        self._closing = True
        if self._stepper is not None:
            self._stepper.cancel()
            self._stepper = None
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None
        err = WorkerUnavailable(f"worker killed: {reason}")
        for fut in list(self._unresolved):
            if not fut.done():
                fut.set_exception(err)
        self._unresolved.clear()
        self._inbox.clear()
        self._live_reqs = 0

    @property
    def is_alive(self) -> bool:
        return self._stepper is not None and not self._stepper.done()

    async def __aenter__(self) -> "AsyncLmEngine":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    # -- supervisor worker surface ------------------------------------------

    @property
    def compute(self):
        """The supervisor reads ``.compute.warmed`` to replay warmup on
        replacement workers; for the LM tier the sync engine is the compute
        plane."""
        return self.engine

    def warmup(self, in_shape=None, dtype=None) -> None:
        self.engine.warmup(in_shape, dtype)

    def ping(self) -> concurrent.futures.Future:
        """A no-op through the decode thread — the supervisor heartbeat.  It
        queues behind the current decode step, so a hung worker shows up as
        a slow or timed-out beat."""
        if self._pool is None:
            raise WorkerUnavailable(
                f"no compute pool (engine "
                f"{'killed: ' + self._killed if self._killed else 'not started'})"
            )
        return self._pool.submit(lambda: None)

    # -- request plane -------------------------------------------------------

    def _retry_after_hint_ms(self) -> float:
        """Load-shedding hint: the backlog's estimated drain time (queued
        sequences x observed per-request latency over available slots)."""
        per_req = self.engine._metrics.latency_ms(50) or 10.0
        lanes = max(self.engine.slots, 1)
        backlog = -(-max(self._live_reqs, 1) // lanes)
        return per_req * backlog

    def submit_nowait(self, prompt, *, uid: int | None = None,
                      max_new_tokens: int = 16, eos_id: int = -1,
                      deadline_ms: float | None = None) -> asyncio.Future:
        """Admit one prompt (or raise :class:`AdmissionError` /
        :class:`SequenceTooLong`); returns the future resolving to its
        finished :class:`LmRequest`."""
        if self._wake is None or self._closing:
            raise RuntimeError(
                "engine not started: use `async with engine:` or "
                "`await engine.start()`"
            )
        try:
            batching.admit_or_raise(self._live_reqs, self.max_pending,
                                    retry_after_ms=self._retry_after_hint_ms())
        except AdmissionError:
            self.engine._metrics.rejected += 1
            self.engine._metrics.shed += 1
            raise
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        if not prompt:
            raise ValueError("empty prompt")
        if uid is None:
            uid = self._uid
        self._uid = max(self._uid, uid) + 1
        req = LmRequest(uid=uid, prompt=prompt,
                        max_new_tokens=max_new_tokens, eos_id=eos_id)
        self.engine.manager.bucket_for(req.total_len)  # SequenceTooLong now
        req._t0 = time.perf_counter()
        if deadline_ms is not None:
            req._deadline = req._t0 + deadline_ms / 1e3
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        self._inbox.append((req, fut))
        self._live_reqs += 1
        self._futs[uid] = fut
        self._unresolved.add(fut)
        fut.add_done_callback(self._unresolved.discard)
        self.engine._metrics.submitted += 1
        self._wake.set()
        return fut

    async def submit(self, prompt, *, uid: int | None = None,
                     max_new_tokens: int = 16, eos_id: int = -1,
                     deadline_ms: float | None = None) -> LmRequest:
        """Admit one prompt and await its finished request."""
        return await self.submit_nowait(
            prompt, uid=uid, max_new_tokens=max_new_tokens, eos_id=eos_id,
            deadline_ms=deadline_ms,
        )

    async def submit_wave(self, prompts, **kw) -> list[LmRequest]:
        return await asyncio.gather(
            *(self.submit(p, **kw) for p in prompts)
        )

    # -- stepper -------------------------------------------------------------

    def _drain_inbox(self) -> None:
        inbox, self._inbox = self._inbox, []
        for req, fut in inbox:
            if fut.done():
                self._live_reqs -= 1  # killed while queued
                continue
            # bypass engine.submit: admission + deadline were set at the
            # request plane, the sync queue is unbounded here
            self.engine.queue.push(req)

    def _resolve(self, finished: list[LmRequest]) -> None:
        for req in finished:
            fut = self._futs.pop(req.uid, None)
            if fut is None:
                continue
            self._live_reqs -= 1
            self.engine._metrics.loop_handoffs += 1
            if fut.done():
                continue
            if req.error is not None:
                fut.set_exception(req.error)
            else:
                fut.set_result(req)

    async def _run_stepper(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            if not self._inbox and not self.engine.active:
                if self._closing:
                    break
                await self._wake.wait()
                self._wake.clear()
                continue
            self._drain_inbox()
            try:
                finished = await loop.run_in_executor(
                    self._pool, self.engine.step
                )
            except faults.WorkerDeath as e:
                self.kill(str(e))
                return
            except RuntimeError:
                if self._killed is not None:
                    return  # pool shut down mid-step by kill()
                raise
            if self._killed is not None:
                return
            self._resolve(finished)
            # yield to the event loop so submits land between steps
            await asyncio.sleep(0)

    # -- observability -------------------------------------------------------

    @property
    def pending(self) -> int:
        return len(self._inbox) + len(self.engine.queue)

    @property
    def outstanding(self) -> int:
        """Admitted-but-unresolved sequences — the supervisor's
        least-outstanding routing signal."""
        return self._live_reqs

    def metrics(self) -> dict:
        return self.engine.metrics()
