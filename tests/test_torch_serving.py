"""The port's front door and serving tier, on the CPU.

``marvel.compile(..., backend="cuda", device="cpu")`` binds the kernel
table with every wrapper on its plain version; the async engine serves
through it with no new bucket after warmup.  Entry points refuse to run
without a card unless the caller asks for the CPU.  The resolved tables
equal the reference's for the patterns ported so far (``pallas`` ->
``cuda``), and neither the package nor ``chip_smoke.py`` imports JAX or the
reference package.
"""
import ast
import asyncio
import pathlib

import pytest

torch = pytest.importorskip("torch")

from repro.core.extensions import CLASS_LADDERS as JLADDERS  # noqa: E402
from repro.core.extensions import resolve_table as jresolve  # noqa: E402
from repro_torch import marvel  # noqa: E402
from repro_torch.core import dispatch as tdispatch  # noqa: E402
from repro_torch.core.extensions import resolve_table as tresolve  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402
from repro_torch.runtime.faults import FaultInjector  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORTED = ("fused_conv", "matmul_epilogue", "pool", "depthwise_conv",
          "sep_block", "residual_rmsnorm", "flash_attention",
          "mac_matmul_int8", "wkv_chunk")


def _lenet_program(**kw):
    init, apply, in_shape = tcnn.get_cnn("lenet5")
    params = init(torch.Generator().manual_seed(0))
    x = torch.zeros((1, *in_shape))
    return marvel.compile(apply, x, params=params, level="v4",
                          device="cpu", **kw), in_shape


def test_compile_binds_cuda_table_and_serves_async_on_cpu():
    prog, in_shape = _lenet_program(backend="cuda")
    assert prog.model_class == "cnn"
    assert prog.extensions == ["mac", "conv_mac", "fusedmac"]
    assert prog.resolved_extensions == {"mac_matmul_int8": "cuda",
                                        "fused_conv": "cuda",
                                        "matmul_epilogue": "cuda",
                                        "sep_block": "cuda"}
    engine = prog.serve(mode="async", max_batch=4)
    images = tserve.random_images(in_shape, 11)

    async def main():
        async with engine:
            engine.warmup(in_shape)
            misses = prog.cache_misses
            done = await engine.submit_wave(images)
            return done, misses

    done, misses = asyncio.run(main())
    assert len(done) == 11 and all(r.done and r.error is None for r in done)
    assert prog.cache_misses == misses  # no new bucket after warmup
    m = engine.metrics()
    assert m["completed"] == 11 and m["errors"] == 0
    assert m["loop_handoffs"] == m["batches"]
    # the served answers are the program's own on the same image
    logits = prog(torch.from_numpy(images[3][None]))
    assert done[3].label == int(logits.argmax())


def test_sync_engine_isolates_a_poison_pill():
    prog, in_shape = _lenet_program(backend="cuda")
    engine = prog.serve(mode="sync", max_batch=4,
                        faults=FaultInjector(poison_uids=[2]))
    for uid, im in enumerate(tserve.random_images(in_shape, 4)):
        engine.submit(uid, im)
    results = engine.run_until_drained()
    assert [results[u].done for u in range(4)] == [True, True, False, True]
    assert engine.metrics()["errors"] == 1


def test_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    init, apply, in_shape = tcnn.get_cnn("lenet5")
    x = torch.zeros((1, *in_shape))
    params = init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        marvel.compile(apply, x, params=params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.main(["--cnn", "lenet5", "--requests", "2"])
    # auto resolves to the baseline off the card
    prog = marvel.compile(apply, x, params=params, device="cpu")
    assert prog.resolved_extensions == {}


def test_launcher_serves_on_cpu_when_asked(capsys):
    tserve.main(["--cnn", "lenet5", "--requests", "6", "--max-batch", "4",
                 "--device", "cpu"])
    assert '"completed": 6' in capsys.readouterr().out


def test_lm_launcher_serves_the_smoke_variant_on_cpu(capsys, monkeypatch):
    m = tserve.main(["--arch", "qwen3-8b", "--smoke", "--lm", "--requests",
                     "5", "--max-new", "3", "--slots", "2", "--kv-quant",
                     "int8", "--device", "cpu"])
    assert m["completed"] == 5 and m["tokens_total"] == 15
    assert m["kv_quant"] == "int8" and m["errors"] == 0
    assert "0 new buckets after warmup" in capsys.readouterr().out
    # --arch without --lm: the legacy wave loop, as the reference's launcher
    m = tserve.main(["--arch", "qwen3-8b", "--smoke", "--requests", "3",
                     "--max-new", "2", "--slots", "2", "--device", "cpu"])
    assert m["completed"] == 3 and m["submitted"] == 3
    with pytest.raises(SystemExit):  # --isolation process needs supervision
        tserve.main(["--cnn", "lenet5", "--isolation", "process",
                     "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.main(["--arch", "qwen3-8b", "--smoke", "--lm"])


def test_dropped_program_is_freed_without_a_collection():
    """A compiled program sits in no reference cycle: once the caller drops
    it (its buckets built, its report made), it and its bound parameters
    go at once, not at the garbage collector's next pass, so a model's
    device memory is back before the next one is drawn."""
    import gc
    import weakref

    import numpy as np
    from repro_torch.configs import RunConfig, get_arch, smoke_variant
    from repro_torch.models import transformer as T

    cfg = smoke_variant(get_arch("qwen3-8b"))
    run = RunConfig(seq_len=8, global_batch=1)
    params = T.init_params(torch.Generator().manual_seed(0), cfg)

    def compiled():
        return marvel.compile(
            lambda p, t: T.forward_lm(p, t, cfg, run)[0],
            np.ones((1, 8), np.int32), params=params, level="v4",
            device="cpu")

    # the process's first profile imports inside torch's FakeTensorMode,
    # whose import frames (the first compile's among them) torch keeps
    compiled()
    enabled = gc.isenabled()
    gc.disable()
    try:
        prog = compiled()
        prog(np.ones((2, 8), np.int32))  # a second bucket
        assert prog.cache_misses == 2
        ref = weakref.ref(prog)
        del prog
        assert ref() is None
    finally:
        if enabled:
            gc.enable()


def test_arch_registry_serves_the_dense_family_only():
    """The served archs (the dense family, whisper-tiny, internvl2-26b,
    hymba and rwkv6); an arch of a family the port does not serve yet is
    refused with its family named."""
    from repro_torch.configs import get_arch, list_archs

    assert list_archs() == ["whisper-tiny", "internvl2-26b", "granite-3-2b",
                            "granite-34b", "qwen3-8b", "starcoder2-3b",
                            "hymba-1.5b", "rwkv6-1.6b"]
    assert get_arch("qwen3-8b").family == "dense"
    assert get_arch("granite-34b").family == "dense"
    assert get_arch("rwkv6-1.6b").family == "rwkv"
    assert get_arch("hymba-1.5b").family == "hybrid"
    assert get_arch("whisper-tiny").family == "enc_dec"
    assert get_arch("internvl2-26b").family == "vlm"
    with pytest.raises(NotImplementedError, match="moe"):
        get_arch("llama4-maverick-400b-a17b")
    with pytest.raises(KeyError):
        get_arch("no-such-arch")


def test_lm_launcher_serves_hymba_smoke_on_cpu(capsys):
    """hymba-1.5b's smoke variant through the continuous-batching tier with
    int8 KV (its SSM state passed through), supervised, and the legacy wave
    loop."""
    m = tserve.main(["--arch", "hymba-1.5b", "--smoke", "--lm", "--requests",
                     "5", "--max-new", "3", "--slots", "2", "--kv-quant",
                     "int8", "--device", "cpu"])
    assert m["completed"] == 5 and m["tokens_total"] == 15
    assert m["kv_quant"] == "int8" and m["errors"] == 0
    assert m["kv_slot_reuses"] > 0
    assert "0 new buckets after warmup" in capsys.readouterr().out
    m = tserve.main(["--arch", "hymba-1.5b", "--smoke", "--lm",
                     "--supervised", "--workers", "2", "--requests", "4",
                     "--max-new", "2", "--slots", "2", "--device", "cpu"])
    assert m["aggregate"]["healthy_workers"] == 2
    assert "served 4 sequences (8 tokens)" in capsys.readouterr().out
    m = tserve.main(["--arch", "hymba-1.5b", "--smoke", "--requests", "3",
                     "--max-new", "2", "--slots", "2", "--device", "cpu"])
    assert m["completed"] == 3 and m["submitted"] == 3


def test_lm_launcher_serves_rwkv_smoke_on_cpu(capsys):
    m = tserve.main(["--arch", "rwkv6-1.6b", "--smoke", "--lm", "--requests",
                     "6", "--max-new", "3", "--slots", "2", "--device",
                     "cpu"])
    assert m["completed"] == 6 and m["tokens_total"] == 18
    assert m["kv_quant"] == "none" and m["errors"] == 0
    assert m["kv_slot_reuses"] > 0
    assert "0 new buckets after warmup" in capsys.readouterr().out


def test_lm_launcher_refuses_int8_kv_for_rwkv():
    """rwkv's recurrent state has no {'k','v'} layout: the reference's
    message."""
    with pytest.raises(ValueError, match=r"needs a \{'k','v'\} cache layout; "
                       r"this family caches \['cm_prev', 's', 'tm_prev'\]"):
        tserve.main(["--arch", "rwkv6-1.6b", "--smoke", "--lm", "--requests",
                     "1", "--max-new", "1", "--slots", "1", "--kv-quant",
                     "int8", "--device", "cpu"])


@pytest.mark.parametrize("level", ["v0", "v1", "v2", "v3", "v4"])
def test_resolved_tables_equal_reference_for_ported_patterns(level):
    for cls in JLADDERS:
        want = {p: "cuda" for p, impl in
                jresolve(level, "pallas", model_class=cls).items()
                if p in PORTED and impl == "pallas"}
        assert dict(tresolve(level, "cuda", model_class=cls)) == want, cls
        auto = jresolve(level, "auto", platform="tpu", model_class=cls)
        want_auto = {p: "cuda" for p in auto if p in PORTED}
        assert dict(tresolve(level, "auto", platform="cuda",
                             model_class=cls)) == want_auto, cls
        assert tresolve(level, "auto", platform="cpu",
                        model_class=cls) == tdispatch.EMPTY_TABLE


def test_port_registry_is_its_own():
    from repro.core import dispatch as jdispatch

    tresolve("v4", "cuda", model_class="cnn")  # registers the cuda impls
    assert "cuda" not in jdispatch.registered_backends()
    assert "pallas" not in tdispatch.registered_backends()
    with pytest.raises(ValueError, match="unknown backend"):
        tresolve("v4", "pallas", model_class="cnn")


def _imports(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_port_and_chip_smoke_import_no_jax_and_nothing_of_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (f.name, name)
