"""End-to-end MARVEL flow (paper Fig 1/2 analogue), the reference's
``core/pipeline.py``.

model (Python) -> fake-tensor run ("TVM->C") -> profile on the baseline
("simulator") -> class detection + extension selection -> rewrite
("chess_rewrite") -> per-version cost/energy report (Figs 11/12) -> the
deployable program ("RTL+bitfile").

The single front door is :func:`repro_torch.marvel.compile`, which returns
the ``MarvelProgram`` artifact and its :class:`MarvelReport`;
:func:`run_marvel_flow` is the report-only entry point and delegates to it.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

from repro_torch.core import costmodel, profiler


@dataclass
class MarvelReport:
    model_class: str
    recommended_extensions: list[str]
    profile: profiler.PatternProfile
    rewrite_stats: dict
    # did the chess_rewrite pass succeed? (False => rewrite_stats["error"])
    rewrite_ok: bool = True
    # per processor-version modelled metrics (Fig 11/12 analogues):
    # rv32_* is the faithful reproduction (the paper's issue-slot
    # accounting and FPGA power); gpu_* is the roofline model with the
    # H100 constants of costmodel.py (the reference's tpu_*)
    rv32_cycles: dict[str, float] = field(default_factory=dict)
    rv32_energy_j: dict[str, float] = field(default_factory=dict)
    gpu_cycles: dict[str, float] = field(default_factory=dict)
    gpu_energy_j: dict[str, float] = field(default_factory=dict)
    hbm_bytes: dict[str, float] = field(default_factory=dict)
    rv32_speedup_v4: float = 0.0
    gpu_speedup_v4: float = 0.0

    def summary(self) -> str:
        rw = self.rewrite_stats if self.rewrite_ok else (
            f"FAILED: {self.rewrite_stats.get('error', '?')}"
        )
        lines = [
            f"model class: {self.model_class}",
            f"extensions:  {', '.join(self.recommended_extensions) or '(none)'}",
            f"rewrites:    {rw}",
            f"{'ver':<4} {'rv32 cycles':>14} {'rv32 E(J)':>11}"
            f" {'gpu cycles':>12} {'gpu E(J)':>10} {'HBM bytes':>12}",
        ]
        for lvl in costmodel.LEVELS:
            lines.append(
                f"{lvl:<4} {self.rv32_cycles[lvl]:>14.3e}"
                f" {self.rv32_energy_j[lvl]:>11.4f}"
                f" {self.gpu_cycles[lvl]:>12.3e}"
                f" {self.gpu_energy_j[lvl]:>10.2e}"
                f" {self.hbm_bytes[lvl]:>12.3e}"
            )
        lines.append(
            f"v0->v4 speedup: rv32 {self.rv32_speedup_v4:.2f}x"
            f" (paper claims ~2x), gpu {self.gpu_speedup_v4:.2f}x (modelled)"
        )
        return "\n".join(lines)


def build_report(prof: profiler.PatternProfile, model_class: str,
                 exts: list[str], rewrite_stats: dict, *,
                 rewrite_ok: bool = True, chips: int = 1) -> MarvelReport:
    """Fill the per-version cost/energy tables from a profile (Figs 11/12)."""
    report = MarvelReport(
        model_class=model_class,
        recommended_extensions=exts,
        profile=prof,
        rewrite_stats=rewrite_stats,
        rewrite_ok=rewrite_ok,
    )
    base = prof.as_costmodel_inputs()
    for lvl in costmodel.LEVELS:
        adj = costmodel.apply_level(base, lvl)
        terms = costmodel.roofline(
            adj["flops"], adj["hbm_bytes"], 0.0, chips,
            int8_fraction=adj["int8_fraction"],
        )
        cyc = costmodel.cycles(terms, adj["loop_iters"])
        report.gpu_cycles[lvl] = cyc
        report.gpu_energy_j[lvl] = costmodel.energy_j(cyc, chips)
        report.hbm_bytes[lvl] = adj["hbm_bytes"]
        rcyc = costmodel.rv32_cycles(base, lvl)
        report.rv32_cycles[lvl] = rcyc
        report.rv32_energy_j[lvl] = costmodel.rv32_energy_j(rcyc, lvl)
    report.rv32_speedup_v4 = report.rv32_cycles["v0"] / max(
        report.rv32_cycles["v4"], 1e-30
    )
    report.gpu_speedup_v4 = report.gpu_cycles["v0"] / max(
        report.gpu_cycles["v4"], 1e-30
    )
    return report


def run_marvel_flow(fn: Callable, *example_args, chips: int = 1,
                    do_rewrite: bool = True, device=None) -> MarvelReport:
    """Profile ``fn`` at the given example args, select class-aware
    extensions, and produce the per-version report.

    Report-only front: delegates to :func:`repro_torch.marvel.compile` with
    the baseline backend and nothing built, and returns its report.
    ``device`` as every entry point takes it (``None``: the card)."""
    from repro_torch import marvel  # marvel imports this module

    prog = marvel.compile(
        fn, *example_args, level="v4", backend="ref", chips=chips,
        do_rewrite=do_rewrite, precompile=False, device=device,
    )
    return prog.report
