"""Analytic cost model: the Fig 11/12 (cycles, energy) analogue.

Two models, as in the reference's ``core/costmodel.py``:

* the **rv32 issue-slot model** (:func:`rv32_cycles`, :func:`rv32_energy_j`)
  is the paper's own accounting on its FPGA core (3-stage in-order RV32IM
  at 100 MHz, the Table 8 powers), copied verbatim: its v0..v4 ladder is the
  faithful reproduction of the paper's ~2x;
* the **roofline model** (:func:`roofline`, :func:`cycles`,
  :func:`energy_j`) is the hardware-adapted one.  The reference fills it
  with its accelerator's constants; here they are one NVIDIA H100's, and
  the numbers it gives are MODELLED, not measured.  Fields the reference
  names ``tpu_*`` are ``gpu_*`` here (``MarvelReport.gpu_cycles``,
  ``gpu_energy_j``, ``gpu_speedup_v4``); the reference's per-loop-iteration
  dispatch cycles become :data:`LOOP_OVERHEAD_S`, seconds of one kernel
  launch, times the clock.

The structure is the reference's: a bf16 base rate that ``int8_fraction``
doubles, so :func:`apply_level` reads the same in both packages.  The
constants are fixed here and never read at run time, so a report compiled
on the CPU equals one compiled on the card.
"""
from __future__ import annotations

from dataclasses import dataclass

# --- NVIDIA H100 (target), MODELLED ----------------------------------------
# The card: NVIDIA H100 80GB HBM3, power limit 700.00 W, max SM clock
# 1980 MHz (nvidia-smi --query-gpu=name,power.limit,clocks.max.sm).
# Rates: NVIDIA's data sheet for the SXM part, dense (no sparsity), at the
# full 700 W limit: the figures chip_smoke.py's bounds use.
PEAK_FLOPS_BF16 = 989e12  # tensor cores
PEAK_FLOPS_INT8 = 1979e12  # int8 tensor cores = 2x bf16
HBM_BW = 3.35e12  # bytes/s
NVLINK_BW = 450e9  # bytes/s, one direction
CLOCK_HZ = 1.98e9  # max SM clock
CHIP_POWER_W = 700.0  # the power limit (paper measures 830-852 mW FPGA)
# per loop iteration: one kernel launch, the pool kernel's empty launch
# measured back to back (1.85-2.16 us; PERF.md, tools/bisect_pool_kernel.py)
LOOP_OVERHEAD_S = 2.0e-6


@dataclass(frozen=True)
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        # overlap model: compute/memory pipelined with collectives;
        # lower bound is the max term
        return max(self.compute_s, self.memory_s, self.collective_s)


def roofline(flops: float, hbm_bytes: float, coll_bytes: float, chips: int,
             int8_fraction: float = 0.0) -> RooflineTerms:
    peak = PEAK_FLOPS_BF16 * (1.0 + int8_fraction)  # int8 doubles the rate
    return RooflineTerms(
        compute_s=flops / (chips * peak),
        memory_s=hbm_bytes / (chips * HBM_BW),
        collective_s=coll_bytes / (chips * NVLINK_BW),
    )


def cycles(terms: RooflineTerms, loop_iters: float = 0.0) -> float:
    return (terms.step_s + loop_iters * LOOP_OVERHEAD_S) * CLOCK_HZ


def energy_j(cyc: float, chips: int = 1) -> float:
    """Paper eq. (1): E = P * C / f, per chip * chips."""
    return CHIP_POWER_W * chips * cyc / CLOCK_HZ


# ---------------------------------------------------------------------------
# Per-extension deltas applied to a PatternProfile (see profiler.py), the
# reference's, level by level:
#
# v1 mac + conv_mac: weight bytes halve (bf16 -> int8) and the weight-bearing
#   matmul flops (GEMMs and convs) run at the int8 rate via int8_fraction
# v2 add2i: the res + x sum stays in-register (rmsnorm_epilogue_bytes);
#   dw_mac: depthwise flops join the int8 rate and keep their epilogue
#   in-register (dw_epilogue_bytes); pool: int8 pooled activations and the
#   avg rescale in-register (pool_saved_bytes), half the rv32 window slots
# v3 fusedmac: GEMM epilogue (epilogue_bytes), conv epilogue
#   (conv_epilogue_bytes), the separable block's intermediate
#   (sep_intermediate_bytes); acc_mac: skip-adds in the epilogue
#   (acc_bytes_saved, acc_flops)
# v4 zol: loop dispatch mostly gone, no materialized attention scores
#   (attn_score_bytes), and the weight-less matmuls (attention, wkv state;
#   attn_flops / wkv_flops) join the int8 rate with the int8-KV path
# ---------------------------------------------------------------------------

LEVELS = ["v0", "v1", "v2", "v3", "v4"]


def apply_level(profile: "dict", level: str) -> dict:
    """Take raw v0 profile dict -> adjusted terms inputs for a level.

    profile keys: flops, matmul_flops, hbm_bytes, weight_bytes,
    rmsnorm_epilogue_bytes, epilogue_bytes, conv_epilogue_bytes, dw_flops,
    dw_epilogue_bytes, sep_intermediate_bytes, acc_bytes_saved, acc_flops,
    pool_flops, pool_saved_bytes, attn_score_bytes, attn_flops, wkv_flops,
    loop_iters.  (conv_flops / residual_norm_bytes are informational only;
    dw_flops, attn_flops and wkv_flops are *subsets* of matmul_flops used to
    stage the int8 rate — do not add them to a delta or their flops would be
    double-counted.)
    """
    p = dict(profile)
    out = {
        "flops": p["flops"],
        "hbm_bytes": p["hbm_bytes"],
        "loop_iters": p["loop_iters"],
        "int8_fraction": 0.0,
    }
    idx = LEVELS.index(level)
    mm_flops = p.get("matmul_flops", 0.0)
    dw_flops = min(p.get("dw_flops", 0.0), mm_flops)
    # Weight-less matmul share: attention QK^T/PV and wkv state
    # contractions multiply two ACTIVATION tensors, so the v1/v2 int8
    # weight quantization has nothing to quantize there — they join the
    # int8 rate only when the int8-KV dequant path lands with zol.
    nw_flops = min(p.get("attn_flops", 0.0) + p.get("wkv_flops", 0.0),
                   max(mm_flops - dw_flops, 0.0))
    # GEMM-form MACs — dense layers and the 1x1 convs rerouted to
    # matmul_epilogue — ride the v1 `mac` credit (the paper's int8 MAC GEMM
    # instruction); fusedmac at v3 adds only their epilogue fusion.  ONLY
    # the depthwise share is staged to v2, because its per-channel loop
    # needs the separate dw_mac extension.
    if idx >= 1:  # mac: int8 weights; depthwise MACs stay f32 until dw_mac
        out["hbm_bytes"] -= p.get("weight_bytes", 0.0) * 0.5
        out["int8_fraction"] = (
            (mm_flops - dw_flops - nw_flops) / max(p["flops"], 1.0)
        )
    if idx >= 2:  # add2i: fused residual+rmsnorm; dw_mac: int8 depthwise;
        # pool: int8 pooled activations + in-register avg rescale
        out["hbm_bytes"] -= p.get("rmsnorm_epilogue_bytes", 0.0)
        out["hbm_bytes"] -= p.get("dw_epilogue_bytes", 0.0)
        out["hbm_bytes"] -= p.get("pool_saved_bytes", 0.0)
        out["int8_fraction"] = (mm_flops - nw_flops) / max(p["flops"], 1.0)
    if idx >= 3:  # fusedmac + conv_mac epilogue: bias/BN/act fusion;
        # sep_block: the depthwise intermediate never touches HBM;
        # acc_mac: skip-adds accumulate in-register
        out["hbm_bytes"] -= p.get("epilogue_bytes", 0.0)
        out["hbm_bytes"] -= p.get("conv_epilogue_bytes", 0.0)
        out["hbm_bytes"] -= p.get("sep_intermediate_bytes", 0.0)
        out["hbm_bytes"] -= p.get("acc_bytes_saved", 0.0)
    if idx >= 4:  # zol: grid loops + streaming attention/scan kernels;
        # int8-KV brings the weight-less matmuls onto the int8 rate
        out["hbm_bytes"] -= p.get("attn_score_bytes", 0.0)
        out["int8_fraction"] = mm_flops / max(p["flops"], 1.0)
        out["loop_iters"] = p["loop_iters"] * 0.05  # grid seqencer handles rest
    out["hbm_bytes"] = max(out["hbm_bytes"], p["hbm_bytes"] * 0.1)
    return out


# ---------------------------------------------------------------------------
# RV32 issue-slot model — the FAITHFUL Fig 11/12 reproduction.
#
# The paper's baseline executes int8-quantized C on a 3-stage in-order RV32IM
# core: every scalar instruction costs ~1 issue slot, so speedups come from
# *instruction-count* reduction.  We reconstruct the per-MAC instruction mix
# of the generated inner conv loops (exactly the patterns of Fig 3/5) from
# our profiled counts and apply each extension's fusion:
#
#   per inner-product MAC step (v0): lh/lh loads (2) + mul (1) + add (1)
#     + addi;addi pointer bumps (2) + amortized blt (1/unroll)
#   v1 mac:      mul+add        -> 1 slot   (paper §II.C.1: "half the cycles")
#   v2 add2i:    addi;addi      -> 1 slot, for the covered fraction (Fig 4)
#   v3 fusedmac: mac+add2i      -> 1 slot
#   v4 zol:      blt eliminated (paper §II.C.4)
# ---------------------------------------------------------------------------

RV32_CLOCK_HZ = 100e6  # paper: 100 MHz on ZCU104
RV32_LOADS_PER_MAC = 2.0
RV32_BLT_AMORTIZED = 0.25  # TVM unrolls ~4x before the blt
# FPGA power per processor version, paper Table 8 (watts)
RV32_POWER_W = {"v0": 0.830, "v1": 0.852, "v2": 0.850, "v3": 0.847, "v4": 0.849}


def rv32_cycles_per_mac(level: str, add2i_coverage: float = 0.86) -> float:
    loads = RV32_LOADS_PER_MAC
    blt = RV32_BLT_AMORTIZED
    mul_add = 2.0
    addi = 2.0
    idx = LEVELS.index(level)
    if idx >= 1:
        mul_add = 1.0
    if idx >= 2:
        addi = 2.0 - add2i_coverage  # covered pairs collapse to 1 slot
    if idx >= 3:
        # fusedmac folds the (already fused) mac + add2i into one slot
        folded = mul_add + addi
        mul_add, addi = 1.0, 0.0
        if folded < 1.0:
            mul_add = folded
    if idx >= 4:
        blt = 0.0
    return loads + mul_add + addi + blt


def rv32_cycles(profile_inputs: dict, level: str,
                add2i_coverage: float = 0.86) -> float:
    """Modeled inference cycles on the RV32 variant (Fig 11 analogue).

    Depthwise MACs (``dw_flops``) pick up the mac fusion one level later
    than dense MACs: the v1 ``mac`` instruction is the GEMM inner-product
    form, and the per-channel depthwise loop only gains its fused MAC when
    ``dw_mac`` lands at v2.  Weight-less MACs (``attn_flops`` +
    ``wkv_flops`` — attention scores/readout and wkv state contractions)
    stage even later: int8 MAC issue needs int8 operands, and the KV/state
    stream only quantizes when the int8-KV ``zol`` path lands at v4.  Pool
    window ops (``pool_flops``, one compare/add slot per window element at
    v0) halve when the fused windowed-reduce instruction lands at v2;
    standalone skip-adds (``acc_flops``, inside ``other_ops``) fold into
    the acc_mac writeback at v3.
    """
    idx = LEVELS.index(level)
    mm_flops = profile_inputs.get("matmul_flops", 0.0)
    dw_macs = min(profile_inputs.get("dw_flops", 0.0), mm_flops) / 2.0
    nw_macs = min(profile_inputs.get("attn_flops", 0.0)
                  + profile_inputs.get("wkv_flops", 0.0),
                  max(mm_flops - 2.0 * dw_macs, 0.0)) / 2.0
    dense_macs = mm_flops / 2.0 - dw_macs - nw_macs
    other_ops = max(profile_inputs["flops"] - mm_flops, 0.0)
    if idx >= 3:  # acc_mac: the skip-add rides the mac writeback slot
        other_ops = max(other_ops - profile_inputs.get("acc_flops", 0.0), 0.0)
    pool_ops = profile_inputs.get("pool_flops", 0.0) * (0.5 if idx >= 2
                                                        else 1.0)
    dw_level = "v0" if level == "v1" else level
    nw_level = level if idx >= 4 else "v0"
    return (dense_macs * rv32_cycles_per_mac(level, add2i_coverage)
            + dw_macs * rv32_cycles_per_mac(dw_level, add2i_coverage)
            + nw_macs * rv32_cycles_per_mac(nw_level, add2i_coverage)
            + other_ops + pool_ops)


def rv32_energy_j(cyc: float, level: str) -> float:
    """Paper eq. (1) with the paper's own FPGA power numbers."""
    return RV32_POWER_W[level] * cyc / RV32_CLOCK_HZ
