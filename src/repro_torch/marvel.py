"""marvel.compile — one front door that turns a model into a deployable
MarvelProgram artifact, on the CUDA card by default.

    profile -> classify -> class-aware extension selection -> chess_rewrite
    -> (optional int8 PTQ) -> pattern->impl resolution bound into the
    program -> a shape/dtype-bucketed executable cache, and per bucket the
    rewritten graph (kernels as opaque ``marvel::`` nodes) to inspect

::

    from repro_torch import marvel
    prog = marvel.compile(apply, x, params=params, level="v4",
                          quantize=True)                       # on cuda
    y = prog(x)                    # same shape bucket -> cache hit
    print(prog.report.summary())   # v0..v4 cycle/energy tables (Figs 11/12)
    prog.resolved_extensions       # the bound pattern -> impl table
    prog.cost("v2")                # per-level modelled cost
    prog.baked_graph(x)            # this bucket's rewritten graph
    async with prog.serve(mode="async", max_batch=8) as engine:
        engine.warmup(in_shape)
        result = await engine.submit(image)

An LM compiles the same way (``fn(params, tokens)`` -> logits) and serves
through the continuous-batching tier::

    prog = marvel.compile(lambda p, t: T.forward_lm(p, t, cfg, run)[0],
                          tokens, params=params, level="v4")
    async with prog.serve(mode="lm", cfg=cfg, run=run, slots=8,
                          max_len=64, kv_quant="int8") as engine:
        engine.warmup()
        req = await engine.submit(prompt, max_new_tokens=16)

``device=None`` means ``"cuda"``; without a card, compile raises unless the
caller asks for ``device="cpu"``, where ``backend="cuda"`` runs every kernel
wrapper's plain version (what the CPU tests use).  The report's numbers
are models, not measurements (``core/costmodel.py``), and equal whether the
program was compiled on the CPU or on the card.  Each bucket runs the
bound function eagerly: its rewritten graph computes the same (the fused
instructions replay the ATen ops they replace) but runs slower on the
host, op by op through the dispatcher, so it is there to inspect and to
start CUDA-graph capture from.  Tile tuning, ``shard()`` and that capture
come with later slices.
"""
from __future__ import annotations

import time
import warnings
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from repro_torch.core import classes as classes_mod
from repro_torch.core import costmodel, dispatch, profiler
from repro_torch.core import rewrite as rewrite_mod
from repro_torch.core.extensions import KERNEL_BACKEND, resolve_table
from repro_torch.core.pipeline import MarvelReport, build_report
from repro_torch.quant.ptq import fake_quantize_tree


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU.  Raises when CUDA is asked for (or implied) and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions "
            "on the CPU")
    return dev


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(tree)).to(device)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


def _bucket_key(args: tuple) -> tuple:
    """Shape/dtype bucket for the executable cache (a non-tensor argument
    by value: a traced graph is specialized to it)."""
    return tuple((tuple(a.shape), str(a.dtype)) if isinstance(a, torch.Tensor)
                 else (type(a).__name__, repr(a)) for a in args)


@dataclass
class MarvelProgram:
    """The deployable artifact: a table-bound callable on one device, the
    executable per shape bucket, and the analysis that produced them.

    ``__call__`` moves its arguments to the program's device, looks up (or
    builds) the executable for their shape/dtype bucket and runs it: the
    bound function under ``inference_mode``.  ``cache_hits`` /
    ``cache_misses`` count bucket reuse, the serving-facing signal that no
    new bucket appeared after warmup.  With ``rewrite_baked``,
    :meth:`baked_graph` gives the chess_rewritten graph traced at a
    bucket's shapes; ``rewrite_fallbacks`` counts buckets whose rewrite
    failed there (each one warns).
    """

    fn: Callable  # table-bound (and optionally fake-quantized) callable
    level: str
    backend: str  # as requested (possibly "auto")
    table: dispatch.ResolvedTable
    report: MarvelReport
    device: torch.device = torch.device("cuda")
    chips: int = 1
    quantized: bool = False
    quant_stats: dict = field(default_factory=dict)
    # a chess_rewritten graph per bucket (set by compile() when the pass
    # succeeded on the example args)
    rewrite_baked: bool = False
    rewrite_fallbacks: int = 0
    cache_hits: int = 0
    cache_misses: int = 0
    dp_shards: int = 1  # one card is one shard
    # the bound parameter tree, kept so serve(mode="lm") can build decode
    # engines without re-threading params
    bound_params: object = field(default=None, repr=False)
    _cache: dict = field(default_factory=dict, repr=False)
    _graphs: dict = field(default_factory=dict, repr=False)  # bucket -> gm
    # (bucket_len, slots, kv_quant) -> decode step, shared by every LM
    # engine of this program so a replacement engine warms from cache hits
    _lm_exec_cache: dict = field(default_factory=dict, repr=False)

    @property
    def model_class(self) -> str:
        return self.report.model_class

    @property
    def extensions(self) -> list[str]:
        return self.report.recommended_extensions

    @property
    def profile(self) -> profiler.PatternProfile:
        return self.report.profile

    @property
    def resolved_extensions(self) -> dict[str, str]:
        """The bound pattern -> impl mapping (empty means pure baseline)."""
        return dict(self.table)

    def cost(self, level: str | None = None) -> dict[str, float]:
        """Modelled per-inference cost at ``level`` (default: the compiled
        level): rv32 / gpu cycles and energy and device-memory bytes (the
        Fig 11/12 rows)."""
        level = level or self.level
        if level not in costmodel.LEVELS:
            raise ValueError(f"unknown processor version {level!r}; "
                             f"known levels: {costmodel.LEVELS}")
        r = self.report
        return {"rv32_cycles": r.rv32_cycles[level],
                "rv32_energy_j": r.rv32_energy_j[level],
                "gpu_cycles": r.gpu_cycles[level],
                "gpu_energy_j": r.gpu_energy_j[level],
                "hbm_bytes": r.hbm_bytes[level]}

    def _build(self, args) -> Callable:
        """The executable of ``args``'s bucket: the bound function under
        ``inference_mode``, the kernels built first."""
        if self.device.type == "cuda" and KERNEL_BACKEND in self.table.values():
            from repro_torch.kernels import build

            build.lib()  # kernels compile at deploy, not on a live request
        fn = self.fn  # not self: the cache holding ``run`` is the program's

        def run(*a):
            with torch.inference_mode():
                return fn(*a)

        return run

    def baked_graph(self, *args) -> torch.fx.GraphModule | None:
        """The chess_rewritten graph of ``args``'s bucket, traced at its
        shapes, ``marvel::`` instructions and kernels visible (Fig 5's
        v0-vs-v4 assembly analogue).  Called under ``full_f32()`` (a trace
        does not record the scopes in which the plain versions run their
        f32 products), it computes what the program does.  None without
        ``rewrite_baked`` or where the bucket's rewrite fails (counted in
        ``rewrite_fallbacks``, with a warning)."""
        if not self.rewrite_baked:
            return None
        args = _to_device(args, self.device)
        key = _bucket_key(args)
        if key not in self._graphs:
            try:
                self._graphs[key], _ = rewrite_mod.rewrite(self.fn, *args)
            except Exception as e:  # the artifact survives the optimizer
                self.rewrite_fallbacks += 1
                self._graphs[key] = None
                warnings.warn(
                    f"chess_rewrite failed for bucket {key} ({e!r}); it has "
                    f"no rewritten graph", RuntimeWarning, stacklevel=2)
        return self._graphs[key]

    def executable_for(self, *args) -> Callable:
        """The executable for this shape/dtype bucket (built on a miss)."""
        key = _bucket_key(args)
        exe = self._cache.get(key)
        if exe is None:
            self.cache_misses += 1
            exe = self._build(args)
            self._cache[key] = exe
        else:
            self.cache_hits += 1
        return exe

    def __call__(self, *args):
        args = _to_device(args, self.device)
        return self.executable_for(*args)(*args)

    @property
    def cache_size(self) -> int:
        return len(self._cache)

    def serve(self, mode: str = "sync", **engine_kwargs):
        """A serving engine over this artifact.

        CNN classifiers: ``mode="sync"`` returns
        :class:`~repro_torch.runtime.cnn_server.CnnBatchEngine`,
        ``mode="async"`` the :class:`~repro_torch.runtime.cnn_server.
        AsyncCnnEngine` tier (``await engine.submit(x)``).

        LM classes (``*_lm``): ``mode="lm"`` returns the continuous-batching
        :class:`~repro_torch.runtime.lm_server.AsyncLmEngine` (``await
        engine.submit(prompt)``), ``mode="lm_sync"`` the caller-driven
        :class:`~repro_torch.runtime.lm_server.ContinuousBatchEngine`.  Both
        need ``cfg=``/``run=`` and take ``slots``, ``max_len`` or
        ``bucket_lens``, ``kv_quant="int8"``, ``retry=`` and ``faults=``;
        the program's table is bound into every decode step, and engines
        share the program's LM exec cache."""
        if mode in ("lm", "lm_sync"):
            if not (self.model_class.endswith("_lm")
                    or self.model_class == "unknown"):
                raise NotImplementedError(
                    f"serve(mode={mode!r}) is the LM tier; this program is "
                    f"{self.model_class!r}")
            from repro_torch.runtime.lm_server import (
                AsyncLmEngine, ContinuousBatchEngine,
            )

            params = engine_kwargs.pop("params", None)
            if params is None:
                params = self.bound_params
            if params is None:
                raise ValueError(
                    "serve(mode='lm') needs the parameter tree: pass params= "
                    "to marvel.compile() or to serve()")
            cls = AsyncLmEngine if mode == "lm" else ContinuousBatchEngine
            return cls(params, engine_kwargs.pop("cfg"),
                       engine_kwargs.pop("run"), table=self.table,
                       exec_cache=self._lm_exec_cache, **engine_kwargs)
        if self.model_class != "cnn":
            raise NotImplementedError(
                f"serve() covers the cnn class (mode='sync'/'async') and LM "
                f"classes (mode='lm'/'lm_sync'); this program is "
                f"{self.model_class!r}")
        from repro_torch.runtime.cnn_server import (
            AsyncCnnEngine, CnnBatchEngine,
        )

        engines = {"sync": CnnBatchEngine, "async": AsyncCnnEngine}
        if mode not in engines:
            raise ValueError(
                f"unknown serve mode {mode!r}; choose from {sorted(engines)}")
        return engines[mode](self, **engine_kwargs)

    def metrics(self) -> dict:
        """Cache + shard counters, the program's slice of the serving
        metrics surface (the engines merge this into theirs)."""
        return {
            "cache_hits": self.cache_hits,
            "cache_misses": self.cache_misses,
            "cache_size": self.cache_size,
            "dp_shards": self.dp_shards,
        }

    def summary(self) -> str:
        return (f"MarvelProgram(level={self.level}, backend={self.backend}, "
                f"device={self.device}, quantized={self.quantized}, "
                f"rewrite_baked={self.rewrite_baked}, "
                f"impls={self.resolved_extensions or 'baseline'})\n"
                + self.report.summary())


def compile(fn: Callable, *example_args, level: str = "v4",
            backend: str = "auto", quantize: bool = False, params=None,
            device=None, chips: int = 1, do_rewrite: bool = True,
            precompile: bool = True) -> MarvelProgram:
    """Run the MARVEL flow on ``fn`` and return the deployable artifact.

    Args:
      fn: the model callable: ``fn(*example_args)``, or, when ``params`` is
        given, ``fn(params, *example_args)``.
      example_args: example inputs (tensors or numpy arrays).
      level: processor version to bind (``v0``..``v4``).
      backend: ``"auto"`` (``cuda`` per pattern on a CUDA device, baseline
        elsewhere), ``"ref"``/``"baseline"``, or ``"cuda"`` (forced: on the
        CPU the kernel wrappers run their plain versions).
      quantize: int8 PTQ of ``params`` (``fake_quantize_tree``: every >= 2-D
        floating leaf quantized and dequantized in place); needs ``params``.
      params: optional parameter tree, moved to ``device`` and bound.
      device: ``None`` means ``"cuda"`` (raises without a card).
      chips: the cost model's chip count.
      do_rewrite: run the chess_rewrite pass at compile (its stats go to the
        report; its graph is the example bucket's ``baked_graph``).
      precompile: build the kernels and the example bucket now.
    """
    dev = resolve_device(device)
    quant_stats: dict = {}
    if params is not None:
        bound_params = _to_device(params, dev)
        if quantize:
            bound_params, quant_stats = fake_quantize_tree(bound_params)
        model_fn = lambda *a: fn(bound_params, *a)  # noqa: E731
    else:
        if quantize:
            raise ValueError(
                "quantize=True needs the parameter tree: pass params=...")
        model_fn = fn
    example_args = _to_device(example_args, dev)

    # 1-2) profile on the baseline + model-class detection
    prof = profiler.profile_fn(model_fn, *example_args)
    model_class, exts = classes_mod.recommend(prof)

    # 3) class-aware selection -> one resolved table, bound by closure
    table = resolve_table(level, backend, extensions=exts,
                          platform=dev.type, model_class=model_class)
    bound_fn = table.bind(model_fn)

    # 4) chess_rewrite of the bound program, traced at the example bucket:
    # the report counts what the rewritten graph carries; a failure warns
    rewrite_stats: dict = {}
    rewrite_ok = True
    graph = None
    if do_rewrite:
        try:
            graph, rewrite_stats = rewrite_mod.rewrite(bound_fn,
                                                       *example_args)
        except Exception as e:  # rewriting is an optimization, never fatal
            rewrite_stats = {"error": str(e)}
            rewrite_ok = False
            warnings.warn(
                f"chess_rewrite failed ({e!r}); continuing without graph "
                f"fusion — see MarvelReport.rewrite_ok", RuntimeWarning,
                stacklevel=2)

    report = build_report(prof, model_class, exts, rewrite_stats,
                          rewrite_ok=rewrite_ok, chips=chips)
    program = MarvelProgram(
        fn=bound_fn, level=level, backend=backend, table=table,
        report=report, device=dev, chips=chips, quantized=bool(quantize),
        quant_stats=quant_stats, rewrite_baked=do_rewrite and rewrite_ok,
        bound_params=bound_params if params is not None else None,
    )
    if graph is not None:
        program._graphs[_bucket_key(example_args)] = graph
    # 5) the example bucket now (deploy-time build counts as the first
    # cache miss)
    if precompile:
        program.cache_misses += 1
        program._cache[_bucket_key(example_args)] = program._build(
            example_args)
    return program


def compile_timed(fn: Callable, *example_args, **kwargs
                  ) -> tuple[MarvelProgram, float]:
    """compile() plus wall-clock seconds spent — benchmark convenience."""
    t0 = time.perf_counter()
    prog = compile(fn, *example_args, **kwargs)
    return prog, time.perf_counter() - t0
