"""Process-isolated worker actors: the crash-only worker tier (the port's
counterpart of the reference's ``runtime/actor.py``).

An in-process engine (:class:`~repro_torch.runtime.cnn_server.AsyncCnnEngine`
/ :class:`~repro_torch.runtime.lm_server.AsyncLmEngine`) shares its fate
with the supervisor — a segfault, an out-of-memory or a wedged device call
in one worker takes down the whole control plane.  A :class:`WorkerActor`
moves the engine into a real OS process (``multiprocessing``'s *spawn*
context: a clean interpreter with no inherited CUDA state — a forked child
of a process with a live CUDA context cannot use the card) and gives the
parent a client with the exact engine surface the supervisor already
drives (``start/stop/kill/is_alive/submit/ping/warmup/metrics/outstanding``
and ``.compute.warmed``), so ``Supervisor(isolation="process")`` is a
routing detail, not a new control plane.

Topology and protocol::

    Supervisor ──(engine surface)── WorkerActor ──┐ unix socket,
                                                  │ length-prefixed frames
    child process:  _child_main ── program.serve()┘ (repro_torch.runtime.rpc)

* The **child** applies its :class:`DeviceAllocation` (``torch.cuda.
  set_device`` on its granted card; a grant of ``cuda`` with no card
  visible raises — the child never carries on on the CPU), loads the
  kernel library, rebuilds its ``MarvelProgram`` from a picklable
  *factory* reference (programs hold device tensors and never cross the
  pipe), starts its engine, warms the recorded specs, then HELLOs with its
  pid, device and bring-up times.  From then on it serves ``submit /
  submit_wave / ping / metrics / warmup / drain / stop`` frames;
  heartbeats are PINGs on the same channel, each carrying the engine's
  metrics, the device's peak allocation and the warmed specs.
* The **parent** multiplexes concurrent calls by ``req_id`` over one
  connection, watches the process *sentinel* (crash detection the instant
  the OS reaps the child), and on any death — sentinel, truncated frame,
  protocol error — fails every in-flight call with
  :class:`~repro_torch.runtime.batching.WorkerUnavailable` so the
  supervisor's failover replays the requests (CNN payloads and LM full
  prompts alike) on a sibling.  Exceptions raised in the child
  (``AdmissionError`` with its ``retry_after_ms``, ``DeadlineExceeded``,
  compute errors) pickle across and re-raise in the parent unchanged.

Crash-only by construction: the parent never repairs a child.  Any anomaly
escalates to SIGKILL (which also fells SIGSTOPped children) and the
supervisor's warm-handoff respawn takes over once the dead child is
reaped: the replacement warms from the recorded specs *before* the routing
slot reopens and reports ``recompiles_after_warmup=0``.
"""
from __future__ import annotations

import asyncio
import multiprocessing
import os
import signal
import tempfile
import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.runtime import batching, faults, rpc
from repro_torch.runtime.batching import WorkerUnavailable

OP = rpc.OPCODES


# -- device allocation --------------------------------------------------------


@dataclass(frozen=True)
class DeviceAllocation:
    """One actor's device grant: CUDA device *indices* plus the platform
    they index into (``"cuda"``; ``"cpu"`` grants the host, index 0).  The
    child calls ``torch.cuda.set_device`` on its first grant."""

    indices: tuple[int, ...] = (0,)
    platform: str | None = None


def allocation_plan(workers: int, n_devices: int | None = None,
                    platform: str | None = None) -> list[DeviceAllocation]:
    """Partition the local devices across ``workers`` actors.

    With devices to spare, each worker gets a contiguous slice (remainder
    devices go to the lowest-indexed workers); with more workers than
    devices, workers share round-robin — one device each, oversubscribed
    (two workers on one card both get card 0).  Deterministic in ``index``,
    so a replacement actor always inherits the dead one's exact slice.
    ``platform`` defaults to ``"cuda"``, ``n_devices`` to the cards
    visible (the host counts as one device).
    """
    if workers < 1:
        raise ValueError(f"workers must be >= 1, got {workers}")
    if platform is None:
        platform = "cuda"
    if n_devices is None:
        import torch
        n_devices = torch.cuda.device_count() if platform == "cuda" else 1
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    if n_devices < workers:
        return [DeviceAllocation((i % n_devices,), platform)
                for i in range(workers)]
    base, extra = divmod(n_devices, workers)
    plan, start = [], 0
    for i in range(workers):
        width = base + (1 if i < extra else 0)
        plan.append(DeviceAllocation(tuple(range(start, start + width)),
                                     platform))
        start += width
    return plan


def factory_platform(factory_kwargs: dict) -> str:
    """The platform a program factory builds on: its ``device`` argument's
    type, the card when it names none (the entry points' default)."""
    import torch
    return torch.device(factory_kwargs.get("device") or "cuda").type


def _apply_allocation(alloc: DeviceAllocation | None) -> list:
    """Child-side: pin this process to its granted card; returns the
    granted devices.  A ``cuda`` grant with no card visible raises."""
    import torch
    if alloc is None or alloc.platform in (None, "cpu"):
        return [torch.device("cpu")]
    if alloc.platform != "cuda":
        raise ValueError(f"unknown platform {alloc.platform!r}")
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    granted = [torch.device("cuda", i) for i in alloc.indices if i < n]
    if not granted:
        raise RuntimeError(
            f"allocation {alloc} grants no device (only {n} CUDA "
            f"device(s) visible); the worker does not fall back to the CPU"
        )
    torch.cuda.set_device(granted[0])
    return granted


# -- program factories (module-level: picklable by reference) -----------------


def cnn_program_factory(model: str = "lenet5", level: str = "v4",
                        seed: int = 0, device=None):
    """A CNN compiled at ``level`` with random weights from ``seed``, drawn
    on ``device`` (the card by default): the launcher's CNN program, rebuilt
    inside the actor process."""
    import torch

    from repro_torch import marvel
    from repro_torch.models.cnn import get_cnn

    init, apply, in_shape = get_cnn(model)
    dev = marvel.resolve_device(device)
    params = init(torch.Generator().manual_seed(seed), device=dev)
    x = np.zeros((1, *in_shape), np.float32)
    return marvel.compile(apply, x, params=params, level=level, device=dev)


def lm_program_factory(arch: str, smoke: bool = True, seed: int = 0,
                       seq_len: int = 32, global_batch: int = 4,
                       attn_chunk: int = 16, device=None):
    """An LM compiled at v4 with random weights from ``seed``, drawn on
    ``device`` (the card by default); returns ``(program,
    extra_engine_kwargs)`` — the child-built ``cfg``/``run`` merge into the
    engine kwargs."""
    import torch

    from repro_torch import marvel
    from repro_torch.configs import RunConfig, get_arch, smoke_variant
    from repro_torch.models import transformer as T

    cfg = get_arch(arch)
    if smoke:
        cfg = smoke_variant(cfg)
    dev = marvel.resolve_device(device)
    run = RunConfig(seq_len=seq_len, global_batch=global_batch,
                    mode="decode", attn_chunk=attn_chunk)
    params = T.init_params(torch.Generator(device=dev).manual_seed(seed), cfg)
    tokens = np.ones((1, 8), np.int32)
    prog = marvel.compile(lambda p, t: T.forward_lm(p, t, cfg, run)[0],
                          tokens, params=params, level="v4", device=dev)
    return prog, dict(cfg=cfg, run=run)


# -- the actor spec (everything a child needs, all picklable) -----------------


@dataclass
class ActorSpec:
    """The complete, picklable description of one worker actor.

    ``program_factory`` is a module-level callable (pickled by reference)
    returning either a program or ``(program, extra_engine_kwargs)`` —
    the artifact itself is rebuilt child-side.  ``fault_plan`` is the
    declarative plan (never a live injector: injectors carry RNG state and
    counters that belong to exactly one process).
    """

    name: str
    program_factory: object
    factory_kwargs: dict = field(default_factory=dict)
    mode: str = "async"
    engine_kwargs: dict = field(default_factory=dict)
    allocation: DeviceAllocation | None = None
    fault_plan: faults.FaultPlan | None = None
    warmup_specs: list = field(default_factory=list)
    max_frame_bytes: int = rpc.MAX_FRAME_BYTES


# -- child process ------------------------------------------------------------


def child_entry(spec: ActorSpec, sock_path: str) -> None:
    """The spawned process's target (module-level: spawn pickles it by
    reference).  ``slow_start_ms`` sleeps *before* anything else — the
    parent sees a late HELLO, exactly like a cold cache or slow device
    init."""
    slow = getattr(spec.fault_plan, "slow_start_ms", 0.0) or 0.0
    if slow:
        time.sleep(slow / 1e3)
    asyncio.run(_child_main(spec, sock_path))


async def _child_main(spec: ActorSpec, sock_path: str) -> None:
    import torch

    t0 = time.perf_counter()
    granted = _apply_allocation(spec.allocation)
    dev = granted[0]
    factory_kwargs = dict(spec.factory_kwargs)
    times = {"kernel_load_s": None}
    if dev.type == "cuda":
        from repro_torch.kernels import build

        factory_kwargs["device"] = str(dev)  # this process's card, by index
        t = time.perf_counter()
        build.lib()  # a cached build is loaded; a missing one is built
        times["kernel_load_s"] = time.perf_counter() - t
    t = time.perf_counter()
    built = spec.program_factory(**factory_kwargs)
    program, extra_kwargs = (built if isinstance(built, tuple)
                             else (built, {}))
    times["program_s"] = time.perf_counter() - t
    injector = faults.make_injector(spec.fault_plan)
    engine = program.serve(mode=spec.mode, faults=injector,
                           **{**spec.engine_kwargs, **extra_kwargs})
    await engine.start()
    t = time.perf_counter()
    for shape, dtype in spec.warmup_specs:
        engine.warmup(tuple(shape), dtype)
    times["warmup_s"] = time.perf_counter() - t
    times["bring_up_s"] = time.perf_counter() - t0
    # compiles from here on are recompiles: the warm-handoff acceptance
    # metric the supervisor reads off every PING
    snap = engine.metrics()
    warm_base = snap.get("cache_misses", 0) + snap.get("compile_misses", 0)

    def device_metrics() -> dict:
        if dev.type != "cuda":
            return {}
        return {"device_memory_peak_bytes":
                torch.cuda.max_memory_allocated(dev)}

    reader, writer = await asyncio.open_unix_connection(sock_path)
    write_lock = asyncio.Lock()
    loop = asyncio.get_running_loop()
    stopping = asyncio.Event()

    async def reply(opcode: int, rid: int, obj) -> None:
        corrupt = (injector.reply_corruption()
                   if isinstance(injector, faults.ProcessFaultInjector)
                   else None)
        async with write_lock:
            if corrupt is not None:
                # corrupt THEN close: the parent must fail deterministically
                # with a ProtocolError, never hang on a half-frame
                if corrupt == "garbage":
                    writer.write(b"\xff" * rpc.HEADER.size)
                else:  # truncate: header promises more payload than arrives
                    frame = rpc.encode_frame(opcode, rid, obj)
                    writer.write(frame[: max(len(frame) // 2,
                                             rpc.HEADER.size)])
                await writer.drain()
                writer.close()
                stopping.set()
                return
            try:
                await rpc.write_frame(writer, opcode, rid, obj,)
            except (ConnectionError, RuntimeError):
                stopping.set()

    def sendable(exc: BaseException) -> BaseException:
        import pickle
        try:
            pickle.dumps(exc)
            return exc
        except Exception:
            return RuntimeError(f"{type(exc).__name__}: {exc}")

    async def handle(opcode: int, rid: int, obj) -> None:
        try:
            if opcode == OP["submit"]:
                req = await engine.submit(
                    obj["payload"], uid=obj.get("uid"),
                    deadline_ms=obj.get("deadline_ms"),
                    **obj.get("kwargs", {}))
                await reply(OP["reply_ok"], rid, req)
            elif opcode == OP["submit_wave"]:
                results = await asyncio.gather(
                    *(engine.submit(p, **obj.get("kwargs", {}))
                      for p in obj["payloads"]),
                    return_exceptions=True)
                await reply(OP["reply_ok"], rid,
                            [sendable(r) if isinstance(r, BaseException)
                             else r for r in results])
            elif opcode == OP["ping"]:
                snap = engine.metrics()
                snap["recompiles_after_warmup"] = (
                    snap.get("cache_misses", 0)
                    + snap.get("compile_misses", 0) - warm_base)
                snap.update(device_metrics())
                await reply(OP["reply_ok"], rid, {
                    "pid": os.getpid(),
                    "alive": engine.is_alive,
                    "metrics": snap,
                    "warmed": list(engine.compute.warmed),
                })
            elif opcode == OP["metrics"]:
                await reply(OP["reply_ok"], rid, engine.metrics())
            elif opcode == OP["warmup"]:
                shape, dtype = obj
                await loop.run_in_executor(
                    None, engine.warmup, tuple(shape), dtype)
                await reply(OP["reply_ok"], rid, True)
            elif opcode == OP["drain"]:
                await engine.stop()
                await reply(OP["reply_ok"], rid, True)
            elif opcode == OP["stop"]:
                await reply(OP["reply_ok"], rid, True)
                stopping.set()
            else:
                await reply(OP["reply_err"], rid, rpc.ProtocolError(
                    f"opcode {opcode} is not servable by an actor"))
        except asyncio.CancelledError:
            raise
        except BaseException as e:  # noqa: BLE001 — every error must reply
            await reply(OP["reply_err"], rid, sendable(e))

    await rpc.write_frame(writer, OP["hello"], 0, {
        "pid": os.getpid(),
        "devices": [str(d) for d in granted],
        "mode": spec.mode,
        **times, **device_metrics(),
    })

    tasks: set[asyncio.Task] = set()
    read_task: asyncio.Task | None = None
    try:
        while not stopping.is_set():
            read_task = asyncio.ensure_future(
                rpc.read_frame(reader, spec.max_frame_bytes))
            stop_wait = asyncio.ensure_future(stopping.wait())
            done, _ = await asyncio.wait(
                {read_task, stop_wait},
                return_when=asyncio.FIRST_COMPLETED)
            stop_wait.cancel()
            if read_task not in done:
                read_task.cancel()
                break
            try:
                opcode, rid, obj = read_task.result()
            except (EOFError, rpc.ProtocolError, ConnectionError):
                break  # parent went away: crash-only, just exit
            t = asyncio.ensure_future(handle(opcode, rid, obj))
            tasks.add(t)
            t.add_done_callback(tasks.discard)
    finally:
        for t in list(tasks):
            t.cancel()
        if engine.is_alive:
            engine.kill("actor shutting down")
        writer.close()


# -- parent-side client -------------------------------------------------------


class _ComputeMirror:
    """Parent-side stand-in for ``engine.compute``: the supervisor reads
    ``.warmed`` to replay warmup on replacements; PING replies keep it
    fresh across the process boundary."""

    def __init__(self):
        self.warmed: list = []


class WorkerActor:
    """Parent-side client for one actor process, presenting the same
    surface as the in-process async engines so the supervisor cannot tell
    the difference.  Every RPC is multiplexed over one unix-socket
    connection by ``req_id``; process death (sentinel), connection loss,
    and protocol violations all collapse to the same crash-only path:
    SIGKILL + every in-flight call failing with
    :class:`WorkerUnavailable` for the supervisor to re-route."""

    def __init__(self, spec: ActorSpec, *, hello_timeout_s: float = 120.0,
                 stop_timeout_s: float = 60.0):
        self.spec = spec
        self.name = spec.name
        self.hello_timeout_s = hello_timeout_s
        self.stop_timeout_s = stop_timeout_s
        self.pid: int | None = None
        self._proc: multiprocessing.process.BaseProcess | None = None
        self._server: asyncio.AbstractServer | None = None
        self._writer: asyncio.StreamWriter | None = None
        self._read_task: asyncio.Task | None = None
        self._hello: asyncio.Future | None = None
        self._pending: dict[int, asyncio.Future] = {}
        self._req_id = 0
        self._outstanding = 0  # submit RPCs in flight (routing signal)
        self._killed: str | None = None
        self._stopping = False
        self._sentinel_watched = False
        self._sock_dir: tempfile.TemporaryDirectory | None = None
        self._compute = _ComputeMirror()
        self._cached_metrics: dict = {}
        self._rtt = batching.Reservoir()
        # the child's HELLO (pid, devices, bring-up times) and the parent's
        # clock from spawn to HELLO
        self.hello: dict = {}
        self.spawn_to_hello_s: float | None = None

    # -- lifecycle ----------------------------------------------------------

    async def start(self) -> "WorkerActor":
        if self._proc is not None or self._killed is not None:
            return self
        loop = asyncio.get_running_loop()
        self._hello = loop.create_future()
        # a private tempdir keeps the socket path short (AF_UNIX ~108-byte
        # limit) and lets teardown remove everything in one call
        self._sock_dir = tempfile.TemporaryDirectory(prefix="marvel-actor-")
        sock_path = os.path.join(self._sock_dir.name, "rpc.sock")
        self._server = await asyncio.start_unix_server(
            self._on_connection, path=sock_path)
        # CUDA needs a clean interpreter: a forked child of a process with
        # a live CUDA context cannot use the card
        ctx = multiprocessing.get_context("spawn")
        assert ctx.get_start_method() == "spawn"
        t0 = time.perf_counter()
        self._proc = ctx.Process(target=child_entry,
                                 args=(self.spec, sock_path),
                                 name=f"marvel-actor-{self.name}",
                                 daemon=True)
        self._proc.start()
        loop.add_reader(self._proc.sentinel, self._on_sentinel)
        self._sentinel_watched = True
        done, _ = await asyncio.wait({self._hello},
                                     timeout=self.hello_timeout_s)
        if not done:
            self.kill(f"no HELLO within {self.hello_timeout_s:.0f}s")
            raise WorkerUnavailable(
                f"actor {self.name!r} never came up "
                f"(no HELLO within {self.hello_timeout_s:.0f}s)"
            )
        hello = self._hello.result()  # raises WorkerUnavailable if it died
        self.spawn_to_hello_s = time.perf_counter() - t0
        self.hello = dict(hello)
        self.pid = hello.get("pid")
        return self

    async def wait_reaped(self, timeout_s: float = 120.0) -> None:
        """Return once the child process has exited and been reaped (its
        device memory is free); a SIGKILLed child that outlives
        ``timeout_s`` raises."""
        if self._proc is None:
            return
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout_s
        while self._proc.is_alive():
            if loop.time() >= deadline:
                raise RuntimeError(
                    f"actor {self.name!r} (pid {self._proc.pid}) not reaped "
                    f"within {timeout_s:.0f} s of its kill")
            await asyncio.sleep(0.05)

    async def stop(self) -> None:
        """Draining stop across the process boundary: DRAIN flushes every
        accepted request child-side, STOP lets it exit cleanly; any
        failure escalates to the crash path (nothing accepted is lost —
        a supervisor re-routes what the child could not flush)."""
        if self._proc is None or self._killed is not None:
            return
        self._stopping = True
        try:
            await asyncio.wait_for(self._call("drain", None),
                                   timeout=self.stop_timeout_s)
            await asyncio.wait_for(self._call("stop", None),
                                   timeout=self.stop_timeout_s)
        except (Exception, asyncio.TimeoutError):
            self._stopping = False
            self.kill("drain/stop RPC failed")
            return
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(None, self._proc.join,
                                   self.stop_timeout_s)
        if self._proc.is_alive():
            self._stopping = False
            self.kill("child ignored STOP")
            return
        self._teardown_io()

    def kill(self, reason: str = "killed") -> None:
        """Crash-only teardown: SIGKILL the child (fells SIGSTOPped/hung
        processes too) and fail every in-flight call with
        :class:`WorkerUnavailable` so the supervisor re-routes them."""
        if self._killed is not None:
            return
        self._killed = reason
        if self._proc is not None and self._proc.is_alive():
            try:
                os.kill(self._proc.pid, signal.SIGKILL)
            except (ProcessLookupError, OSError):
                pass
        if self._proc is not None:
            self._proc.join(timeout=5.0)
        self._teardown_io()
        err = WorkerUnavailable(f"worker actor killed: {reason}")
        if self._hello is not None and not self._hello.done():
            self._hello.set_exception(err)
            # the bring-up path consumes this via .result(); if it already
            # gave up (timeout), retrieve so the loop never logs it
            self._hello.exception()
        for fut in list(self._pending.values()):
            if not fut.done():
                fut.set_exception(err)
        self._pending.clear()

    def _teardown_io(self) -> None:
        if self._sentinel_watched and self._proc is not None:
            try:
                asyncio.get_event_loop().remove_reader(self._proc.sentinel)
            except (RuntimeError, ValueError, OSError):
                pass
            self._sentinel_watched = False
        if self._read_task is not None:
            self._read_task.cancel()
            self._read_task = None
        if self._writer is not None:
            self._writer.close()
            self._writer = None
        if self._server is not None:
            self._server.close()
            self._server = None
        if self._sock_dir is not None:
            try:
                self._sock_dir.cleanup()
            except OSError:
                pass
            self._sock_dir = None

    @property
    def is_alive(self) -> bool:
        return (self._killed is None and not self._stopping
                and self._proc is not None and self._proc.is_alive())

    @property
    def exitcode(self) -> int | None:
        return None if self._proc is None else self._proc.exitcode

    async def __aenter__(self) -> "WorkerActor":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    # -- death detection ----------------------------------------------------

    def _on_sentinel(self) -> None:
        """The OS reaped the child: instant crash detection, no heartbeat
        round needed.  In-flight calls fail immediately and re-route."""
        if self._proc is None or self._proc.is_alive():
            return
        code = self._proc.exitcode
        if self._stopping or self._killed is not None:
            self._teardown_io()  # expected exit; just stop watching
            return
        self.kill(f"process died (exit code {code})")

    def _on_connection(self, reader: asyncio.StreamReader,
                       writer: asyncio.StreamWriter) -> None:
        if self._writer is not None or self._killed is not None:
            writer.close()  # one child, one connection
            return
        self._writer = writer
        self._read_task = asyncio.ensure_future(self._read_loop(reader))

    async def _read_loop(self, reader: asyncio.StreamReader) -> None:
        try:
            while True:
                opcode, rid, obj = await rpc.read_frame(
                    reader, self.spec.max_frame_bytes)
                if opcode == OP["hello"]:
                    if self._hello is not None and not self._hello.done():
                        self._hello.set_result(obj)
                    continue
                fut = self._pending.pop(rid, None)
                if fut is None or fut.done():
                    continue  # caller gave up (timed out / cancelled)
                if opcode == OP["reply_ok"]:
                    fut.set_result(obj)
                elif opcode == OP["reply_err"]:
                    fut.set_exception(
                        obj if isinstance(obj, BaseException)
                        else RuntimeError(f"actor error: {obj!r}"))
                else:
                    raise rpc.ProtocolError(
                        f"unexpected opcode {opcode} in a reply stream")
        except asyncio.CancelledError:
            raise
        except rpc.ProtocolError as e:
            self.kill(f"protocol error: {e}")
        except (EOFError, ConnectionError, OSError) as e:
            if not self._stopping and self._killed is None:
                self.kill(f"connection lost: {e}")

    # -- RPC plumbing -------------------------------------------------------

    async def _call(self, opname: str, obj):
        if self._killed is not None:
            raise WorkerUnavailable(
                f"actor {self.name!r} killed: {self._killed}")
        if self._writer is None:
            raise WorkerUnavailable(f"actor {self.name!r} not connected")
        self._req_id += 1
        rid = self._req_id
        fut = asyncio.get_running_loop().create_future()
        self._pending[rid] = fut
        try:
            await rpc.write_frame(self._writer, OP[opname], rid, obj)
        except (ConnectionError, RuntimeError, OSError) as e:
            self._pending.pop(rid, None)
            raise WorkerUnavailable(
                f"actor {self.name!r} send failed: {e}") from e
        try:
            return await fut
        finally:
            self._pending.pop(rid, None)

    # -- engine surface (what the supervisor drives) ------------------------

    async def submit(self, payload, *, uid: int | None = None,
                     deadline_ms: float | None = None, **kwargs):
        self._outstanding += 1
        try:
            return await self._call("submit", {
                "payload": payload, "uid": uid,
                "deadline_ms": deadline_ms, "kwargs": kwargs,
            })
        finally:
            self._outstanding -= 1

    async def submit_wave(self, payloads, **kwargs) -> list:
        n = len(payloads)
        self._outstanding += n
        try:
            results = await self._call("submit_wave", {
                "payloads": list(payloads), "kwargs": kwargs,
            })
        finally:
            self._outstanding -= n
        for r in results:
            if isinstance(r, BaseException):
                raise r
        return results

    @property
    def outstanding(self) -> int:
        """Requests in flight on this actor — the least-outstanding
        routing signal (pings/metrics don't count)."""
        return self._outstanding

    def ping(self):
        """One PING round-trip (a coroutine — the supervisor awaits it like
        the in-process engines' compute-thread futures).  The reply
        multiplexes the heartbeat with the child's metrics and warmed
        specs, so the parent-side caches stay fresh for free."""
        if not self.is_alive:
            raise WorkerUnavailable(
                f"actor {self.name!r} is not alive "
                f"({self._killed or 'stopped'})")
        return self._ping_rpc()

    async def _ping_rpc(self) -> None:
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        reply = await self._call("ping", None)
        self._rtt.observe((loop.time() - t0) * 1e3)
        self._cached_metrics = dict(reply.get("metrics", {}))
        self._compute.warmed = [
            (tuple(shape), dtype) for shape, dtype in reply.get("warmed", [])
        ]
        if not reply.get("alive", True):
            raise WorkerUnavailable(
                f"actor {self.name!r}: child engine is dead")

    def warmup(self, in_shape, dtype="float32"):
        """Returns a coroutine (the supervisor awaits warmups when they are
        awaitable): replays one warmup spec child-side — a cache hit when
        the spec was already in the actor's birth warmup."""
        shape = () if in_shape is None else tuple(in_shape)
        return self._call("warmup", (shape, str(dtype)))

    @property
    def compute(self) -> _ComputeMirror:
        return self._compute

    def metrics(self) -> dict:
        """The last child snapshot (refreshed by every heartbeat) plus the
        parent-side RPC round-trip percentiles.  Survives the child: after
        a crash the cache still holds the last-known counters, which is
        what the supervisor folds into its monotone aggregate."""
        snap = dict(self._cached_metrics)
        if len(self._rtt):
            snap["rpc_roundtrip_p50_ms"] = self._rtt.percentile(50)
            snap["rpc_roundtrip_p99_ms"] = self._rtt.percentile(99)
        if self.pid is not None:
            snap["pid"] = self.pid
        return snap

    async def fetch_metrics(self) -> dict:
        """A fresh child snapshot via an explicit METRICS RPC (the cached
        path is :meth:`metrics`)."""
        snap = await self._call("metrics", None)
        self._cached_metrics = dict(snap)
        return self.metrics()
