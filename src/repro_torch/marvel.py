"""marvel.compile — one front door that turns a model into a deployable
MarvelProgram artifact, on the CUDA card by default.

    profile -> classify -> class-aware extension selection
    -> pattern->impl resolution bound into the program
    -> shape/dtype-bucketed executable cache

::

    from repro_torch import marvel
    prog = marvel.compile(apply, x, params=params, level="v4")   # on cuda
    y = prog(x)                    # same shape bucket -> cache hit
    prog.resolved_extensions       # the bound pattern -> impl table
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
wrapper's plain version (what the CPU tests use).  The per-level report
(cost model), the chess_rewrite pass, int8 PTQ of the params, tuning,
``shard()`` and CUDA-graph capture per bucket come with later slices.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from repro_torch.core import classes as classes_mod
from repro_torch.core import dispatch, profiler
from repro_torch.core.extensions import KERNEL_BACKEND, resolve_table


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
    """Shape/dtype bucket for the executable cache."""
    return tuple((tuple(a.shape), str(a.dtype)) if isinstance(a, torch.Tensor)
                 else (type(a).__name__,) for a in args)


@dataclass
class MarvelProgram:
    """The deployable artifact: a table-bound callable on one device plus
    the analysis that produced it.

    ``__call__`` moves its arguments to the program's device, looks up (or
    builds) the executable for their shape/dtype bucket and runs it.
    ``cache_hits`` / ``cache_misses`` count bucket reuse, the serving-facing
    signal that no new bucket appeared after warmup.
    """

    fn: Callable  # table-bound callable
    level: str
    backend: str  # as requested (possibly "auto")
    table: dispatch.ResolvedTable
    model_class: str
    extensions: list[str]
    profile: profiler.PatternProfile = field(repr=False)
    device: torch.device = torch.device("cuda")
    cache_hits: int = 0
    cache_misses: int = 0
    dp_shards: int = 1  # one card is one shard
    # the bound parameter tree, kept so serve(mode="lm") can build decode
    # engines without re-threading params
    bound_params: object = field(default=None, repr=False)
    _cache: dict = field(default_factory=dict, repr=False)
    # (bucket_len, slots, kv_quant) -> decode step, shared by every LM
    # engine of this program so a replacement engine warms from cache hits
    _lm_exec_cache: dict = field(default_factory=dict, repr=False)

    @property
    def resolved_extensions(self) -> dict[str, str]:
        """The bound pattern -> impl mapping (empty means pure baseline)."""
        return dict(self.table)

    def _build(self) -> Callable:
        if self.device.type == "cuda" and KERNEL_BACKEND in self.table.values():
            from repro_torch.kernels import build

            build.lib()  # kernels compile at deploy, not on a live request

        def run(*args):
            with torch.inference_mode():
                return self.fn(*args)

        return run

    def executable_for(self, *args) -> Callable:
        """The executable for this shape/dtype bucket (built on a miss)."""
        key = _bucket_key(args)
        exe = self._cache.get(key)
        if exe is None:
            self.cache_misses += 1
            exe = self._build()
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
                f"device={self.device}, class={self.model_class}, "
                f"extensions={self.extensions}, "
                f"impls={self.resolved_extensions or 'baseline'})")


def compile(fn: Callable, *example_args, level: str = "v4",
            backend: str = "auto", params=None, device=None,
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
      params: optional parameter tree, moved to ``device`` and bound.
      device: ``None`` means ``"cuda"`` (raises without a card).
      precompile: build the kernels and the example bucket now.
    """
    dev = resolve_device(device)
    if params is not None:
        bound_params = _to_device(params, dev)
        model_fn = lambda *a: fn(bound_params, *a)  # noqa: E731
    else:
        model_fn = fn
    example_args = _to_device(example_args, dev)

    # 1-2) profile on the baseline + model-class detection
    prof = profiler.profile_fn(model_fn, *example_args)
    model_class, exts = classes_mod.recommend(prof)

    # 3) class-aware selection -> one resolved table, bound by closure
    table = resolve_table(level, backend, extensions=exts,
                          platform=dev.type, model_class=model_class)
    program = MarvelProgram(
        fn=table.bind(model_fn), level=level, backend=backend, table=table,
        model_class=model_class, extensions=exts, profile=prof, device=dev,
        bound_params=bound_params if params is not None else None,
    )
    if precompile:
        program.executable_for(*example_args)
    return program

