"""The port's process-isolated worker actors (``repro_torch.runtime.actor``)
under its supervisor, against the reference's where both compute the same.

* Pure units: ``allocation_plan`` agrees with the reference's over a grid
  of (workers, devices); ``ActorSpec`` and ``ProcessFaultPlan`` pickle (the
  spawn boundary is a pickle hop); the ``ProcessFaultInjector`` thresholds
  fire as the reference's with ``os.kill`` / ``os._exit`` stubbed out; a
  child granted ``cuda`` with no card raises instead of carrying on on the
  CPU.
* Default lane, two process tests on LeNet-5*: a submit round trip over the
  unix-socket RPC, and the acceptance scenario — SIGKILL a worker mid-wave:
  zero lost requests, the fleet heals, and the replacement is warm
  (``recompiles_after_warmup == 0``).
* Slow lane, as the reference's: the LM's full-prompt replay after a
  SIGKILL (qwen3-8b smoke variant), SIGSTOP hang recovery, a nonzero exit,
  corrupt and truncated RPC replies (fail fast, never hang), a slow start,
  a child granted a card that is not there, and a multi-fault chaos soak.

Every process test carries a hard ``timeout`` marker and every wait loop is
bounded, so a hung RPC fails the test instead of wedging the job.  Workers
build their programs on the CPU (``factory_kwargs=dict(device="cpu")``).
"""
import asyncio
import os
import pickle
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.runtime import actor as jactor  # noqa: E402
from repro.runtime import faults as jfaults  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.serve import LM_SUPERVISOR  # noqa: E402
from repro_torch.runtime import actor as tactor  # noqa: E402
from repro_torch.runtime import faults as tfaults  # noqa: E402
from repro_torch.runtime.actor import (  # noqa: E402
    ActorSpec, DeviceAllocation, WorkerActor, allocation_plan,
    cnn_program_factory, lm_program_factory,
)
from repro_torch.runtime.batching import WorkerUnavailable  # noqa: E402
from repro_torch.runtime.faults import (  # noqa: E402
    FaultInjector, FaultPlan, ProcessFaultInjector, ProcessFaultPlan,
    make_injector,
)
from repro_torch.runtime.supervisor import Supervisor  # noqa: E402

IN_SHAPE = (28, 28, 1)  # lenet5
CPU = dict(device="cpu")


def _images(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(IN_SHAPE).astype(np.float32)
            for _ in range(n)]


def _mk_supervisor(**kw):
    kw.setdefault("heartbeat_interval_ms", 50.0)
    kw.setdefault("pick_timeout_ms", 60_000.0)
    return Supervisor(**kw)


def _register_cnn(sup, *, workers=2, **kw):
    sup.register("lenet5", None, workers=workers, isolation="process",
                 program_factory=cnn_program_factory,
                 factory_kwargs=dict(model="lenet5", **CPU),
                 warmup=IN_SHAPE, max_batch=8, **kw)


async def _converged(sup, n, *, tries=1200):
    for _ in range(tries):
        if len(sup.healthy_workers()) == n:
            return True
        await asyncio.sleep(0.05)
    return False


def _first_incarnation_only(plan, index=0):
    """Arm ``plan`` for worker ``index``'s first incarnation only, so the
    replacement spawns clean and recovery converges."""
    armed = []

    def factory(i):
        if i == index and not armed:
            armed.append(True)
            return plan
        return None

    return factory


# ---------------------------------------------------------------------------
# pure units
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("workers", [1, 2, 3, 5, 8])
def test_allocation_plan_agrees_with_the_reference(workers):
    for n_devices in (1, 2, 3, 4, 8):
        got = allocation_plan(workers, n_devices=n_devices, platform="cuda")
        want = jactor.allocation_plan(workers, n_devices=n_devices,
                                      platform="cuda")
        assert [(a.indices, a.platform) for a in got] == [
            (a.indices, a.platform) for a in want], n_devices
        # deterministic: a respawned worker i always gets slice i
        assert got == allocation_plan(workers, n_devices=n_devices,
                                      platform="cuda")
    # more workers than cards: all share the one card
    assert [a.indices for a in allocation_plan(workers, 1, "cuda")] == [
        (0,)] * workers
    with pytest.raises(ValueError, match="workers"):
        allocation_plan(0, n_devices=2, platform="cuda")
    with pytest.raises(ValueError, match="n_devices"):
        allocation_plan(workers, n_devices=0, platform="cuda")


def test_allocation_defaults_and_a_cuda_grant_without_a_card():
    """The plan defaults to the card; the host is one device; a grant of a
    card that is not there raises (the child never carries on on the CPU);
    the platform follows the factory's device."""
    assert allocation_plan(3, platform="cpu") == [
        DeviceAllocation((0,), "cpu")] * 3
    assert tactor.factory_platform({}) == "cuda"
    assert tactor.factory_platform(CPU) == "cpu"
    assert tactor._apply_allocation(DeviceAllocation((0,), "cpu")) == [
        torch.device("cpu")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="grants no device"):
            tactor._apply_allocation(DeviceAllocation((0,), "cuda"))


def test_actor_spec_pickles_with_factory_by_reference():
    spec = ActorSpec(
        name="lm/0", program_factory=lm_program_factory,
        factory_kwargs=dict(arch="qwen3-8b", smoke=True), mode="lm",
        engine_kwargs=dict(slots=4, max_len=64),
        allocation=DeviceAllocation((1, 2), "cuda"),
        fault_plan=ProcessFaultPlan(sigkill_after_attempts=3,
                                    corrupt_reply_after=5,
                                    corrupt_mode="garbage"),
        warmup_specs=[((28, 28, 1), "float32")])
    out = pickle.loads(pickle.dumps(spec))
    assert out.program_factory is lm_program_factory  # by reference
    assert out.allocation == DeviceAllocation((1, 2), "cuda")
    assert out.fault_plan.sigkill_after_attempts == 3
    assert out.fault_plan.corrupt_mode == "garbage"
    assert out.engine_kwargs == dict(slots=4, max_len=64)


def _fire(pkg, monkeypatch, plan_kwargs, attempts=3):
    """Drive ``attempts`` compute attempts of ``pkg``'s process injector
    with the process-killing calls stubbed: (calls, exits, injected)."""
    calls, exits = [], []
    monkeypatch.setattr(pkg.os, "kill",
                        lambda pid, sig: calls.append((pid == os.getpid(),
                                                       sig)))
    monkeypatch.setattr(pkg.os, "_exit", lambda code: exits.append(code))
    inj = pkg.ProcessFaultInjector(**plan_kwargs)
    for uid in range(attempts):
        inj.before_compute((uid,))
    return calls, exits, inj.injected


@pytest.mark.parametrize("plan", [
    dict(sigkill_after_attempts=2), dict(sigstop_after_attempts=1),
    dict(exit_after_attempts=1, exit_code=5)],
    ids=["sigkill", "sigstop", "exit"])
def test_process_fault_thresholds_fire_as_the_references(plan, monkeypatch):
    got = _fire(tfaults, monkeypatch, plan)
    assert got == _fire(jfaults, monkeypatch, plan)
    calls, exits, injected = got
    if "sigkill_after_attempts" in plan:
        assert calls == [(True, signal.SIGKILL)]  # attempts 1..2 run clean
    elif "sigstop_after_attempts" in plan:
        assert calls == [(True, signal.SIGSTOP)] * 2
    else:
        assert exits == [5, 5] and injected["exit"] == 2


def test_reply_corruption_fires_once_and_injectors_normalise():
    for pkg in (tfaults, jfaults):
        inj = pkg.ProcessFaultInjector(corrupt_reply_after=2,
                                       corrupt_mode="garbage")
        assert [inj.reply_corruption() for _ in range(4)] == [
            None, "garbage", None, None]
        assert inj.injected["corrupt_reply"] == 1
    assert make_injector(None) is None
    live = FaultInjector(FaultPlan(fail_next=1))
    assert make_injector(live) is live
    assert isinstance(make_injector(ProcessFaultPlan(exit_after_attempts=1)),
                      ProcessFaultInjector)
    plain = make_injector(FaultPlan(fail_next=1))
    assert type(plain) is FaultInjector
    with pytest.raises(TypeError):
        make_injector("not a plan")
    assert [f.name for f in tfaults.ProcessFaultPlan.__dataclass_fields__
            .values()] == [f.name for f in jfaults.ProcessFaultPlan
                           .__dataclass_fields__.values()]


# ---------------------------------------------------------------------------
# default lane: a real CNN actor fleet
# ---------------------------------------------------------------------------


@pytest.mark.timeout(300)
def test_process_worker_roundtrip_and_rpc_metrics():
    async def main():
        sup = _mk_supervisor()
        _register_cnn(sup, workers=1)
        async with sup:
            wh = sup.workers["lenet5/0"]
            assert wh.engine.pid is not None and wh.engine.pid != os.getpid()
            assert wh.engine.hello["devices"] == ["cpu"]
            assert wh.engine.hello["kernel_load_s"] is None  # no card
            assert wh.engine.spawn_to_hello_s > 0
            results = await sup.submit_wave(_images(8))
            assert len(results) == 8
            assert all(r.done and r.error is None for r in results)
            assert len({r.uid for r in results}) == 8
            # the child's labels are the same program's in this process
            prog = cnn_program_factory("lenet5", **CPU)
            want = prog(torch.from_numpy(np.stack(_images(8)))).argmax(-1)
            assert [r.label for r in results] == want.tolist()
            for _ in range(200):  # a heartbeat gives the RPC round trip
                if sup.metrics()["aggregate"]["rpc_roundtrip_p50_ms"] > 0:
                    break
                await asyncio.sleep(0.02)
            agg = sup.metrics()["aggregate"]
            assert agg["rpc_roundtrip_p50_ms"] > 0.0
            assert agg["worker_process_restarts"] == 0
            assert wh.engine.metrics()["pid"] == wh.engine.pid
    asyncio.run(main())


@pytest.mark.timeout(300)
def test_cnn_sigkill_mid_wave_loses_nothing():
    """The acceptance scenario: ``kill -9`` one worker while a wave is in
    flight.  Every accepted request still resolves exactly once, the fleet
    heals to full strength once the dead child is reaped, and the
    replacement is warm: zero recompiles after its warmup replay."""
    async def main():
        sup = _mk_supervisor()
        _register_cnn(sup, workers=2)
        async with sup:
            w0 = sup.workers["lenet5/0"]
            pid0 = w0.engine.pid
            old = w0.engine

            async def killer():
                for _ in range(2000):  # until worker 0 owns requests
                    if w0.engine.outstanding > 0:
                        break
                    await asyncio.sleep(0.001)
                os.kill(pid0, signal.SIGKILL)

            kt = asyncio.ensure_future(killer())
            results = await sup.submit_wave(_images(48))
            await kt
            assert len(results) == 48
            assert all(r.done and r.error is None for r in results)
            assert len({r.uid for r in results}) == 48

            assert await _converged(sup, 2), "fleet never healed"
            replacement = sup.workers["lenet5/0"].engine
            assert replacement.pid != pid0
            assert old.exitcode == -signal.SIGKILL  # reaped before respawn
            agg = sup.metrics()["aggregate"]
            assert agg["worker_process_restarts"] >= 1
            assert agg["restarts"] >= 1 and agg["failovers"] >= 1

            results2 = await sup.submit_wave(_images(16, seed=1))
            assert all(r.done for r in results2)
            await replacement.ping()
            assert replacement.metrics()["recompiles_after_warmup"] == 0
    asyncio.run(main())


# ---------------------------------------------------------------------------
# slow lane: the full process-fault taxonomy + chaos soak
# ---------------------------------------------------------------------------


@pytest.mark.slow
@pytest.mark.timeout(600)
def test_lm_sigkill_mid_wave_replays_full_prompts():
    """Worker 0 SIGKILLs itself mid-decode; its sequences fail over and
    replay their full prompts on a sibling, so every stream completes at
    full length and equals the stream of a fault-free fleet."""
    prompts = [[(u * 7 + i) % 97 + 1 for i in range(5)] for u in range(8)]

    async def wave(faults):
        sup = _mk_supervisor(**LM_SUPERVISOR)
        sup.register(
            "tiny-lm", None, workers=2, mode="lm", isolation="process",
            program_factory=lm_program_factory,
            factory_kwargs=dict(arch="qwen3-8b", smoke=True, **CPU),
            warmup=(), slots=4, max_len=64, faults=faults)
        async with sup:
            results = await sup.submit_wave(prompts, max_new_tokens=6)
            assert await _converged(sup, 2)
            return results, sup.metrics()["aggregate"]

    results, agg = asyncio.run(wave(_first_incarnation_only(
        ProcessFaultPlan(sigkill_after_attempts=3))))
    assert len(results) == 8 and all(r.error is None for r in results)
    assert all(len(r.generated) == 6 for r in results)
    assert agg["failovers"] >= 1 and agg["worker_process_restarts"] >= 1
    # the streams of the same program (same seed) in this process, clean
    prog, ctx = lm_program_factory("qwen3-8b", smoke=True, **CPU)
    engine = prog.serve(mode="lm_sync", slots=4, max_len=64, **ctx)
    clean = [engine.submit(p, max_new_tokens=6) for p in prompts]
    engine.run_until_drained()
    assert [r.generated for r in results] == [r.generated for r in clean]


@pytest.mark.slow
@pytest.mark.timeout(600)
@pytest.mark.parametrize("fault", [
    pytest.param(dict(sigstop_after_attempts=1), id="sigstop"),
    pytest.param(dict(exit_after_attempts=1, exit_code=5), id="exit"),
    pytest.param(dict(corrupt_reply_after=2, corrupt_mode="truncate"),
                 id="truncate"),
    pytest.param(dict(corrupt_reply_after=2, corrupt_mode="garbage"),
                 id="garbage")])
def test_process_fault_is_recovered_with_nothing_lost(fault):
    """A SIGSTOPped child answers nothing (heartbeats time out and the
    supervisor SIGKILLs it), a child exits nonzero (the sentinel sees the
    code), or a reply comes back truncated or garbled (a ProtocolError,
    never a hang): the worker is replaced and every request resolves."""
    async def main():
        sup = _mk_supervisor(hang_timeout_ms=1_500.0)
        _register_cnn(sup, workers=2, faults=_first_incarnation_only(
            ProcessFaultPlan(**fault)))
        async with sup:
            old = sup.workers["lenet5/0"].engine
            results = await sup.submit_wave(_images(24))
            assert all(r.done and r.error is None for r in results)
            assert len({r.uid for r in results}) == 24
            assert await _converged(sup, 2)
            assert sup.workers["lenet5/0"].engine.pid != old.pid
            assert sup.workers["lenet5/0"].restarts >= 1
            if "sigstop_after_attempts" in fault:
                assert old.exitcode == -signal.SIGKILL  # the parent felled it
            if "exit_after_attempts" in fault:
                assert old.exitcode == 5  # the sentinel saw the real code
            assert sup.metrics()["aggregate"]["worker_process_restarts"] >= 1
    asyncio.run(main())


@pytest.mark.slow
@pytest.mark.timeout(600)
def test_slow_start_still_brings_the_fleet_up():
    async def main():
        loop = asyncio.get_running_loop()
        sup = _mk_supervisor()
        _register_cnn(sup, workers=1, faults=_first_incarnation_only(
            ProcessFaultPlan(slow_start_ms=1_500.0)))
        t0 = loop.time()
        async with sup:
            assert loop.time() - t0 >= 1.5  # the delay really happened
            results = await sup.submit_wave(_images(4))
            assert all(r.done for r in results)
    asyncio.run(main())


@pytest.mark.slow
@pytest.mark.timeout(300)
def test_launcher_serves_process_isolated_workers_on_cpu(capsys):
    m = tserve.main(["--cnn", "lenet5", "--supervised", "--workers", "2",
                     "--isolation", "process", "--device", "cpu",
                     "--requests", "12"])
    out = capsys.readouterr().out
    assert "served 12 requests across 2 supervised process worker(s)" in out
    assert "# TYPE marvel_serving_worker_process_restarts gauge" in out
    assert m["aggregate"]["worker_process_restarts"] == 0
    assert sorted(m["workers"]) == ["lenet5/0", "lenet5/1"]


@pytest.mark.slow
@pytest.mark.timeout(300)
def test_child_granted_a_missing_card_raises_and_never_says_hello():
    """A child granted ``cuda`` where no card is visible raises at its
    allocation: no HELLO, a nonzero exit, the parent's bring-up fails."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the grant is real here")
    spec = ActorSpec(name="cnn/0", program_factory=cnn_program_factory,
                     factory_kwargs=dict(model="lenet5"),
                     allocation=DeviceAllocation((0,), "cuda"))

    async def main():
        actor = WorkerActor(spec, hello_timeout_s=120.0)
        with pytest.raises(WorkerUnavailable):
            await actor.start()
        await actor.wait_reaped()
        return actor.exitcode

    assert asyncio.run(main()) not in (0, None)


@pytest.mark.slow
@pytest.mark.timeout(600)
def test_process_chaos_soak_every_request_resolves_exactly_once():
    """Three workers, three process faults (self-SIGKILL, nonzero exit,
    SIGSTOP freeze) armed on their first incarnations, three waves: every
    request resolves exactly once, the fleet converges back to full
    strength, and the aggregate counters stay monotone."""
    plans = {0: ProcessFaultPlan(sigkill_after_attempts=2),
             1: ProcessFaultPlan(exit_after_attempts=3, exit_code=7),
             2: ProcessFaultPlan(sigstop_after_attempts=4)}
    armed: set[int] = set()

    def chaos(index):
        if index in plans and index not in armed:
            armed.add(index)
            return plans[index]
        return None

    async def main():
        sup = _mk_supervisor(hang_timeout_ms=1_500.0)
        _register_cnn(sup, workers=3, faults=chaos)
        async with sup:
            all_results, completed_seen = [], 0
            for wave in range(3):
                results = await sup.submit_wave(_images(24, seed=wave))
                assert len(results) == 24
                assert all(r.done and r.error is None for r in results)
                all_results.extend(results)
                agg = sup.metrics()["aggregate"]
                assert agg["completed"] >= completed_seen  # monotone
                completed_seen = agg["completed"]
            assert len({r.uid for r in all_results}) == len(all_results)
            assert await _converged(sup, 3), "fleet never healed"
            agg = sup.metrics()["aggregate"]
            assert agg["worker_process_restarts"] >= 3
            assert agg["healthy_workers"] == 3 and agg["failovers"] >= 1
    asyncio.run(main())
