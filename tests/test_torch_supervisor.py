"""The port's supervisor (``repro_torch.runtime.supervisor``), its
watchdog and the legacy wave loop (``repro_torch.runtime.server``) against
the reference's, on the CPU.

* The degradation ladder at the routing layer, with scripted worker engines
  (no compute): the same scripted fleet goes through both supervisors and
  must give the same picks (least-outstanding, ties round-robin, saturated
  workers excluded), the same admission failovers and brownout sheds, the
  same circuit-breaker trips and the same Prometheus text, metric names and
  values alike.
* The supervisor over real engines of LeNet-5* and the qwen3-8b smoke
  variant (the engines' forwards are held against the reference's in
  ``test_torch_serving.py`` / ``test_torch_lm.py``): auto-recovery of a
  worker killed mid-wave with zero lost requests (an LM request replays its
  full prompt to the stream a fault-free worker gives), the draining
  restart, the health loop's eviction of dead, hung and straggling workers
  with the warmup replayed and no new bucket, and the Prometheus export.
* The legacy ``ServeEngine`` on the qwen3-8b smoke variant with the
  reference's own weights (f32, so bf16 ties cannot decide an argmax): its
  greedy streams are the reference loop's, token for token.
"""
import asyncio
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.runtime import batching as jbatching  # noqa: E402
from repro.runtime import supervisor as jsup  # noqa: E402
from repro.runtime import watchdog as jwatchdog  # noqa: E402
from repro_torch import marvel  # noqa: E402
from repro_torch.launch.serve import lm_prompts, random_images  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402
from repro_torch.runtime import batching as tbatching  # noqa: E402
from repro_torch.runtime import supervisor as tsup  # noqa: E402
from repro_torch.runtime import watchdog as twatchdog  # noqa: E402
from repro_torch.runtime.actor import lm_program_factory  # noqa: E402
from repro_torch.runtime.batching import RetryPolicy  # noqa: E402
from repro_torch.runtime.faults import FaultInjector  # noqa: E402

PKGS = {
    "port": types.SimpleNamespace(sup=tsup, batching=tbatching,
                                  watchdog=twatchdog),
    "reference": types.SimpleNamespace(sup=jsup, batching=jbatching,
                                       watchdog=jwatchdog),
}
FAST_RETRY = dict(backoff_base_ms=0.1, jitter=0.0)


# ---------------------------------------------------------------------------
# the degradation ladder, scripted: both supervisors on the same fleet
# ---------------------------------------------------------------------------


class ScriptedEngine:
    """A worker engine whose submit() plays back a script of outcomes:
    "ok", ("admission", retry_after_ms) or "unavailable", raised as the
    given package's own exception classes."""

    def __init__(self, pkg, script=(), outstanding=0):
        self.pkg = pkg
        self.script = list(script)
        self.outstanding = outstanding
        self.is_alive = True
        self.calls: list[int] = []

    async def submit(self, payload, *, uid=None, deadline_ms=None, **kw):
        self.calls.append(uid)
        action = self.script.pop(0) if self.script else "ok"
        if action == "unavailable":
            raise self.pkg.batching.WorkerUnavailable("gone")
        if isinstance(action, tuple):
            raise self.pkg.batching.AdmissionError(
                "full", retry_after_ms=action[1])
        return action

    def kill(self, reason=""):
        self.is_alive = False

    def metrics(self):
        return {"submitted": len(self.calls)}


def _fleet(pkg, sup, specs, model="m"):
    """Wire scripted engines (``(script, outstanding)`` each) in as healthy
    workers; returns the engines."""
    engines = [ScriptedEngine(pkg, script, out) for script, out in specs]
    sup._models[model] = pkg.sup._ModelEntry(
        name=model, program=None, workers=len(engines), engine_kwargs={})
    for i, eng in enumerate(engines):
        sup.workers[f"{model}/{i}"] = pkg.sup.WorkerHandle(
            name=f"{model}/{i}", model=model, index=i, engine=eng,
            watchdog=pkg.watchdog.StragglerWatchdog(), state="healthy")
    return engines


def _outcome(coro_fn):
    async def main():
        try:
            return ("ok", await coro_fn())
        except Exception as e:  # noqa: BLE001 — the outcome is compared
            hint = getattr(e, "retry_after_ms", None)
            if "circuit open" in str(e):  # the cooldown left: clock-bound
                hint = 0.0 < hint <= 60_000.0
            return (type(e).__name__, str(e), hint)
    return asyncio.run(main())


def _observe(pkg, scenario):
    """One scripted scenario through ``pkg``'s supervisor: everything the
    caller can see (results, exception types, messages and hints, picks,
    counters, calls per engine, the Prometheus text)."""
    S = pkg.sup.Supervisor
    kw = dict(pick_timeout_ms=100.0, max_failovers=4)
    if scenario == "picks":
        sup = S(**kw)
        _fleet(pkg, sup, [((), 3), ((), 0)], "busy")
        _fleet(pkg, sup, [((), 0), ((), 0)], "idle")
        _fleet(pkg, sup, [((), 0), ((), 9)], "excl")

        async def main():
            return ([(await sup._pick("busy")).name for _ in range(4)],
                    [(await sup._pick("idle")).name for _ in range(4)],
                    (await sup._pick("excl", exclude={"excl/0"})).name)
        return asyncio.run(main())
    if scenario == "admission_failover":
        sup = S(**kw)
        engines = _fleet(pkg, sup, [([("admission", 50.0)], 0), ((), 1)])
    elif scenario == "all_saturated":
        sup = S(**kw)
        engines = _fleet(pkg, sup, [([("admission", 40.0)], 0),
                                    ([("admission", 25.0)], 0)])
    elif scenario in ("brownout_shed", "brownout_spared"):
        sup = S(**kw)
        hints = (500.0, 800.0) if scenario == "brownout_shed" else (5.0, 5.0)
        engines = _fleet(pkg, sup, [([("admission", h)], 0) for h in hints])
    elif scenario == "breaker_trips":
        sup = S(pick_timeout_ms=100.0, max_failovers=0, breaker_trip_after=2,
                breaker_cooldown_ms=60_000.0)
        engines = _fleet(pkg, sup, [(["unavailable"] * 10, 0)])
    elif scenario == "breaker_resets":
        sup = S(pick_timeout_ms=100.0, max_failovers=0, breaker_trip_after=3)
        engines = _fleet(pkg, sup, [(["unavailable", "ok"] * 6, 0)])
    deadline = {"brownout_shed": 10.0, "brownout_spared": 10_000.0}.get(
        scenario)
    submits = {"breaker_trips": 3, "breaker_resets": 8}.get(scenario, 1)
    outcomes = [_outcome(lambda: sup.submit(object(), model="m",
                                            deadline_ms=deadline))
                for _ in range(submits)]
    agg = sup.metrics()["aggregate"]
    return (outcomes, [e.calls for e in engines], sup.failovers,
            sup.shed_brownout, agg["circuit_open"], agg["circuit_trips"],
            sup.prometheus())


SCENARIOS = ["picks", "admission_failover", "all_saturated", "brownout_shed",
             "brownout_spared", "breaker_trips", "breaker_resets"]


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_scripted_fleet_goes_as_through_the_reference(scenario):
    got = _observe(PKGS["port"], scenario)
    assert got == _observe(PKGS["reference"], scenario)
    if scenario == "picks":
        busy, idle, excl = got
        assert busy == ["busy/1"] * 4  # the idle worker, every time
        assert set(idle) == {"idle/0", "idle/1"}
        assert idle[0] != idle[1] and idle[2] != idle[3]
        assert excl == "excl/1"  # excluded beats least-outstanding
        return
    outcomes, calls, failovers, shed, open_, trips, text = got
    if scenario == "admission_failover":
        assert outcomes == [("ok", "ok")] and calls[1] and failovers == 1
    elif scenario == "all_saturated":
        assert outcomes[0][0] == "AdmissionError" and shed == 0
        assert outcomes[0][2] is not None
    elif scenario == "brownout_shed":
        assert "brownout" in outcomes[0][1] and shed == 1
        assert "marvel_serving_shed_brownout 1" in text.splitlines()
    elif scenario == "brownout_spared":
        assert "brownout" not in outcomes[0][1] and shed == 0
    elif scenario == "breaker_trips":
        assert [o[0] for o in outcomes] == ["WorkerUnavailable"] * 2 + [
            "AdmissionError"]
        assert "circuit open" in outcomes[2][1] and len(calls[0]) == 2
        assert (open_, trips) == (1, 1)
    elif scenario == "breaker_resets":
        assert [o[0] for o in outcomes] == ["WorkerUnavailable", "ok"] * 4
        assert open_ == 0


def test_circuit_breaker_and_watchdog_step_as_the_reference():
    def breaker(pkg):
        cb = pkg.sup.CircuitBreaker(trip_after=2, cooldown_ms=100.0)
        trace, now = [], 10.0
        for t, op in [(0, "check"), (0, "fail"), (0, "fail"), (0.05, "check"),
                      (0.2, "check"), (0.2, "fail"), (0.4, "check"),
                      (0.4, "ok")]:
            try:
                r = {"check": lambda: cb.check(now + t),
                     "fail": lambda: cb.record_failure(now + t),
                     "ok": cb.record_success}[op]()
            except pkg.batching.AdmissionError as e:
                r = ("open", round(e.retry_after_ms, 6))
            trace.append((op, r, cb.state, cb.trips, cb.consecutive))
        return trace

    def watchdog(pkg):
        wd = pkg.watchdog.StragglerWatchdog(threshold=4.0, evict_after=3)
        dts = [0.025, 0.03, 0.2, 0.025, 0.15, 0.2, 0.3, 0.025]
        return [(wd.observe(i, dt), wd.consecutive, wd.should_evict,
                 wd.ewma_s) for i, dt in enumerate(dts)]

    for fn in (breaker, watchdog):
        assert fn(PKGS["port"]) == fn(PKGS["reference"])
    trace = breaker(PKGS["port"])
    assert trace[2][1] is True and trace[3][1][0] == "open"
    assert trace[-1][2:] == ("closed", 2, 0)


def test_supervisor_defaults_are_the_references():
    import inspect

    for name in ("Supervisor", "CircuitBreaker"):
        t = inspect.signature(getattr(tsup, name)).parameters
        j = inspect.signature(getattr(jsup, name)).parameters
        assert {k: p.default for k, p in t.items()} == {
            k: p.default for k, p in j.items()}
    assert tsup.Supervisor._SUMMED == jsup.Supervisor._SUMMED
    assert tsup.Supervisor._GAUGES == jsup.Supervisor._GAUGES
    assert tsup.Supervisor._MAXED == jsup.Supervisor._MAXED


# ---------------------------------------------------------------------------
# the supervisor over real engines on the CPU
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lenet():
    init, apply, in_shape = tcnn.get_cnn("lenet5")
    params = init(torch.Generator().manual_seed(0))
    prog = marvel.compile(apply, np.zeros((1, *in_shape), np.float32),
                          params=params, level="v4", device="cpu")
    return prog, in_shape


@pytest.fixture(scope="module")
def qwen():
    prog, ctx = lm_program_factory("qwen3-8b", smoke=True, device="cpu")
    return prog, ctx


def _mk_supervisor(**kw):
    kw.setdefault("heartbeat_interval_ms", 10.0)
    kw.setdefault("pick_timeout_ms", 20_000.0)
    return tsup.Supervisor(**kw)


async def _converged(sup, n, tries=1000):
    for _ in range(tries):
        if len(sup.healthy_workers()) == n:
            return True
        await asyncio.sleep(0.01)
    return False


def _register(sup, which, lenet, qwen, **kw):
    """Register 2 workers of LeNet-5* or the qwen3-8b smoke variant; returns
    the wave to serve and the submit kwargs."""
    if which == "lenet5":
        prog, in_shape = lenet
        sup.register("m", prog, workers=2, warmup=in_shape, max_batch=4,
                     max_delay_ms=1.0, **kw)
        return random_images(in_shape, 32), {}
    prog, ctx = qwen
    sup.register("m", prog, workers=2, mode="lm", warmup=(), slots=4,
                 max_len=64, **ctx, **kw)
    return lm_prompts(ctx["cfg"].vocab, 12), {"max_new_tokens": 6}


def _fault_free(which, lenet, qwen):
    """What one clean worker answers for the wave (labels or streams)."""
    sup = _mk_supervisor()
    wave, kw = _register(sup, which, lenet, qwen)

    async def main():
        async with sup:
            return await sup.submit_wave(wave, **kw)

    return [_answer(r) for r in asyncio.run(main())]


def _answer(r):
    return r.label if hasattr(r, "label") else r.generated


@pytest.mark.parametrize("which", ["lenet5", "qwen3-8b"])
def test_killed_worker_recovers_with_zero_lost_requests(which, lenet, qwen):
    """Worker 0's first incarnation dies after 2 compute attempts (the
    fault layer's death hook); every accepted request still resolves,
    exactly once and with the answer a fault-free fleet gives (an LM
    request replays its full prompt), and the fleet heals to 2."""
    spawned = []

    def factory(index):
        if index == 0 and not spawned:
            spawned.append(0)
            return FaultInjector(die_after_attempts=2)
        return None

    sup = _mk_supervisor()
    wave, kw = _register(sup, which, lenet, qwen, faults=factory)

    async def main():
        async with sup:
            results = await sup.submit_wave(wave, **kw)
            assert await _converged(sup, 2)
            return results, sup.metrics()

    results, m = asyncio.run(main())
    assert len(results) == len(wave)
    assert all(r.done and r.error is None for r in results)
    assert len({r.uid for r in results}) == len(wave)  # no lost, no dups
    assert [_answer(r) for r in results] == _fault_free(which, lenet, qwen)
    agg = m["aggregate"]
    assert agg["healthy_workers"] == 2
    assert agg["restarts"] >= 1 and agg["failovers"] >= 1
    assert sup.workers["m/0"].restarts >= 1


@pytest.mark.parametrize("which", ["lenet5", "qwen3-8b"])
def test_draining_restart_drops_nothing(which, lenet, qwen):
    sup = _mk_supervisor()
    wave, kw = _register(sup, which, lenet, qwen)

    async def main():
        async with sup:
            fut = asyncio.ensure_future(sup.submit_wave(wave, **kw))
            await asyncio.sleep(0)  # the wave admitted, partly in flight
            await sup.restart_worker("m/0", drain=True)
            results = await fut
            return results, sup.metrics(), sup.workers["m/0"].state

    results, m, state = asyncio.run(main())
    assert len(results) == len(wave)
    assert all(r.done and r.error is None for r in results)
    assert [_answer(r) for r in results] == _fault_free(which, lenet, qwen)
    assert m["aggregate"]["restarts"] == 1 and m["aggregate"]["failovers"] == 0
    assert state == "healthy"


def _straggling_watchdog():
    class AlwaysStraggling:
        consecutive = 99

        def observe(self, step, dt):
            return True

        @property
        def should_evict(self):
            return True

    return AlwaysStraggling()


@pytest.mark.parametrize("how", ["killed", "hung", "straggling"])
def test_health_loop_replaces_a_worker_with_its_warmup_replayed(how, lenet):
    """A worker killed outside any request, one whose heartbeat times out
    behind a straggling compute (the requests stuck on it fail over), or
    one whose watchdog says evict: the health loop replaces it, the
    replacement replays the recorded warmup from the program's bucket
    cache (no new bucket) and gets a real watchdog again."""
    prog, in_shape = lenet
    faults = None
    if how == "hung":
        def faults(index):
            return (FaultInjector(straggle_next=1, straggle_ms=400.0)
                    if index == 0 else None)
    sup = _mk_supervisor(hang_timeout_ms=60.0)
    sup.register("lenet5", prog, workers=2, warmup=in_shape, max_batch=4,
                 max_delay_ms=1.0, faults=faults)

    async def main():
        async with sup:
            misses = prog.cache_misses
            w0 = sup.workers["lenet5/0"]
            if how == "killed":
                w0.engine.kill("test chaos")
            elif how == "straggling":
                w0.watchdog = _straggling_watchdog()
            results = await sup.submit_wave(random_images(in_shape, 16))
            for _ in range(1000):
                if sup.metrics()["aggregate"]["restarts"] >= 1:
                    break
                await asyncio.sleep(0.01)
            assert await _converged(sup, 2)
            r = await sup.submit(random_images(in_shape, 1)[0])
            return misses, results, r, sup.metrics()

    misses, results, r, m = asyncio.run(main())
    assert all(x.done and x.error is None for x in results) and r.done
    assert m["aggregate"]["restarts"] >= 1
    assert m["aggregate"]["healthy_workers"] == 2
    assert prog.cache_misses == misses  # the replay hit the bucket cache
    w0 = sup.workers["lenet5/0"]
    assert (tuple(in_shape), "float32") in w0.engine.compute.warmed
    assert isinstance(w0.watchdog, twatchdog.StragglerWatchdog)
    assert w0.state == "stopped"  # the supervisor stopped cleanly


def test_registry_validation_and_prometheus_export(lenet):
    prog, in_shape = lenet
    sup = _mk_supervisor()
    sup.register("lenet5", prog, workers=2, warmup=in_shape, max_batch=4,
                 retry=RetryPolicy(max_retries=1, **FAST_RETRY))
    with pytest.raises(ValueError, match="already registered"):
        sup.register("lenet5", prog)
    with pytest.raises(ValueError, match="workers"):
        sup.register("m2", prog, workers=0)
    with pytest.raises(ValueError, match="program_factory"):
        sup.register("m3", None, isolation="process")

    async def main():
        async with sup:
            with pytest.raises(KeyError, match="unknown model"):
                await sup.submit(random_images(in_shape, 1)[0], model="nope")
            await sup.submit_wave(random_images(in_shape, 8))
            return sup.prometheus()

    lines = asyncio.run(main()).splitlines()
    assert "# TYPE marvel_serving_completed gauge" in lines
    assert "marvel_serving_completed 8" in lines  # the aggregate sample
    labelled = [ln for ln in lines if 'worker="lenet5/0"' in ln]
    assert any(ln.startswith("marvel_serving_completed{") for ln in labelled)
    assert ('marvel_serving_worker_healthy{model="lenet5",'
            'worker="lenet5/0"} 1') in lines
    for ln in lines:  # every sample parses as "name[{labels}] value"
        if not ln.startswith("#"):
            name, value = ln.rsplit(" ", 1)
            assert name.startswith("marvel_serving_")
            float(value)


# ---------------------------------------------------------------------------
# the legacy wave loop against the reference's
# ---------------------------------------------------------------------------


def test_legacy_wave_loop_streams_match_the_reference():
    """More requests than slots through both packages' ``ServeEngine`` on
    the same weights: every request drains, each stream is the
    reference's, and the same prompt gives the same tokens in any lane."""
    from repro.configs.base import RunConfig as JRun
    from repro.configs.registry import get_arch as jget_arch
    from repro.configs.registry import smoke_variant as jsmoke
    from repro.models import transformer as JT
    from repro.runtime.server import Request as JRequest
    from repro.runtime.server import ServeEngine as JServeEngine
    from repro_torch.configs import RunConfig, get_arch, smoke_variant
    from repro_torch.models import transformer as T
    from repro_torch.runtime.server import Request, ServeEngine

    run = dict(seq_len=64, global_batch=2, mode="decode", attn_chunk=16)
    jcfg = jsmoke(jget_arch("qwen3-8b")).replace(param_dtype="float32")
    cfg = smoke_variant(get_arch("qwen3-8b")).replace(param_dtype="float32")
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    params = T.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                               cfg)
    prompts = [[1 + i, 2 + i] for i in range(4)] + [[3, 5, 7], [3, 5, 7]]

    def serve(engine, make):
        reqs = [make(uid=i, prompt=p, max_new_tokens=4)
                for i, p in enumerate(prompts)]
        for r in reqs:
            engine.submit(r)
        engine.run_until_drained(max_steps=200)
        return reqs, engine.metrics()

    jreqs, _ = serve(JServeEngine(jparams, jcfg, JRun(**run), batch_slots=2,
                                  max_len=32), JRequest)
    treqs, m = serve(ServeEngine(params, cfg, RunConfig(**run),
                                 batch_slots=2, max_len=32), Request)
    assert all(r.done and len(r.generated) == 4 for r in treqs)
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert treqs[-1].generated == treqs[-2].generated
    assert m["completed"] == len(prompts) and m["submitted"] == len(prompts)


@pytest.mark.parametrize("argv", [
    ["--cnn", "lenet5", "--requests", "10", "--max-batch", "4"],
    ["--arch", "qwen3-8b", "--smoke", "--lm", "--requests", "5",
     "--max-new", "3", "--slots", "2", "--kv-quant", "int8"]],
    ids=["cnn", "lm"])
def test_launcher_serves_supervised_in_process_workers(argv, capsys):
    from repro_torch.launch import serve as tserve

    m = tserve.main([*argv, "--supervised", "--workers", "2",
                     "--device", "cpu"])
    out = capsys.readouterr().out
    assert "across 2 supervised inproc" in out
    assert "# TYPE marvel_serving_completed gauge" in out
    agg = m["aggregate"]
    want = 10 if argv[0] == "--cnn" else 5
    assert agg["completed"] == want and agg["errors"] == 0
    assert agg["restarts"] == 0 and agg["healthy_workers"] == 2
    if argv[0] == "--arch":
        assert agg["tokens_total"] == 15
