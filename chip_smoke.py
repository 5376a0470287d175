#!/usr/bin/env python3
"""The port's quickest proof on one CUDA card: build the kernels, hold each
against its plain PyTorch version, then serve ResNet50, MobileNetV2,
qwen3-8b, rwkv6-1.6b, hymba-1.5b and granite-34b (its depth cut) at v4,
whisper-tiny and internvl2-26b through the wave loop, and ResNet50 and
qwen3-8b supervised, with workers killed mid-wave.

    python3 chip_smoke.py

Phases (any failure ends the run with a traceback and a non-zero exit):

1. the card's name and power limit (nvidia-smi);
2. build the CUDA kernels of ``src/repro_torch/csrc`` (one nvcc per
   source, in parallel, and the link); one int8 tensor-core tile per
   staged column width through ``imma.cuh``'s fragment maps against the
   exact product (``imma_selftest``);
3a. before the script sets any TF32 flag: ResNet50 at v0 (the plain
   baselines) on the card with both TF32 flags on (cuDNN's default) must
   match the same forward on the CPU within relative L2 1e-4 and leave the
   flags as they were; the same forward with the baselines' full-f32 guard
   taken out is printed beside it, to show what TF32 does;
3. compile ResNet50 (full width, 64x64x3, random weights from seed 0) at v4
   with ``repro_torch.marvel.compile`` and run one batch-8 forward that
   records every kernel launch's inputs; every launch, plus the extra
   case of a conv with ``residual=``, is run through the kernel and its
   plain version on the same inputs and compared within the stated
   tolerance; the first launch of each shape is
   timed (device time from CUDA events, median of trials after warmup, L2
   left warm) beside the one PyTorch call that computes the core op
   (``library_ms``, a yardstick the port never calls) and the bound (max
   of bytes / 3.35 TB/s and operations / the peak rate of their type; a
   forward's bound is the sum of its launches' bounds, the least time of
   the launches run one after another, with the sums of the two terms
   beside it);
   the f32 GEMM with its operands rounded to TF32 (planted) must be
   flagged by the unchanged per-launch hold on at least half of the 34
   GEMM launches;
3b. the same recorded batch-8 forward for MobileNetV2 at v4 (every kernel
   timed), MobileNetV2 at v2 (the standalone depthwise kernel and the 18
   int8 convs timed), MobileNetV1 at v4 (its separable blocks and its
   global-average pool timed), DenseNet121 at v4 (its pools, its 62 GEMM
   and its 59 int8 conv launches timed), VGG16 at v4 (13 int8 convs, 2
   GEMMs, its 5 max pools timed) and LeNet-5* at v4 (28x28x1: 2 int8
   convs, 1 GEMM); each forward's GEMM, conv and pool totals are printed,
   the conv's beside cuDNN's f32 conv, the pools' beside
   ``F.max_pool2d`` / ``F.avg_pool2d`` on the channels-last view and
   ``x.mean``.  Every pool launch of every recorded forward (ResNet50's
   included) must take its vector form (``DEFAULT_FORMS``, read from the
   wrappers' ``launches_by_form``).  Each mobile net's separable-block
   total is printed on a line of its own beside the unfused library pair
   at the same shapes
   (``sep_pair_ms``: cuDNN's depthwise conv in f32, then ``torch.matmul``;
   a yardstick the port never calls).  Each
   forward runs with every launch counter set to 0 just before and read
   just after, and must launch each kernel as often as the reference
   dispatches it.  The per-launch tolerance must flag more separable-block
   launches than the 2 the old ``8*C*eps`` tolerance did when the
   contraction runs on TF32 operands (a planted fault).  The logits of the
   v2, MobileNetV1, DenseNet121, VGG16 and LeNet-5* forwards must match
   the same program on the CPU within the limits of ``E2E_LIMIT`` (noise
   responses printed
   beside), and a planted dropped act in the depthwise stage must exceed
   the limit of each mobile net's forward;
3c. each of the six CNNs compiled at v4 with int8 PTQ of its parameters
   (``marvel.compile(..., quantize=True)``): its summary printed (class,
   extensions, rewrite stats, the v0..v4 rv32 and modelled GPU ladders and
   speedups) and its report held number for number against the same
   compile on the CPU; one batch-8 forward of the program recorded, with
   launch counts equal to ``PER_FORWARD`` and every launch held against
   its plain version, and its logits against the CPU program within
   ``E2E_LIMIT`` (the noise response printed beside it); the bucket's
   rewritten graph (``baked_graph``) traced, run with the same launch
   counts (the rewrite adds and removes no launch), and its logits held
   against the same program without the rewrite (``do_rewrite=False``:
   the largest difference printed, expected 0); the trace time, and the
   wall and device-busy time (``torch.profiler``, every kernel of the
   forward) of the graph and of the program's eager executable;
4. serve 32 ResNet50 requests through the async engine with every launch
   counter set to 0 just before: each batch must launch 20 fused_conv, 34
   matmul_epilogue, 1 windowed pool and 1 global-average pool kernels, take
   no plain fallback and add no bucket; one batch's logits must match the
   same program on the CPU (plain versions) within relative L2 2e-2 (the
   int8 path's response to 1-ulp noise, on the input and on every site's
   input, is printed beside it);
4b. the same for 32 MobileNetV2 requests at v4: 17 sep_block, 18
   matmul_epilogue, 1 fused_conv and 1 global-average pool launches per
   batch, logits within relative L2 1e-1 of the CPU program (its logits are
   ~1e-3 and cancel in the head, so one flipped int8 code moves them by a
   few 1e-2; the per-site noise response printed beside it shows how far).
   Planted faults in the separable block (its depthwise act dropped; its
   contraction on TF32 operands) are read against the same limit, and the
   first must exceed it;
6a. qwen3-8b at full width and depth in bf16 (7.568 B parameters, drawn on
   the card from a CUDA generator, seed 0), compiled at v4: class
   ``dense_lm``, flash_attention, residual_rmsnorm and matmul_epilogue bound
   to ``cuda``;
6b. one recorded prefill forward at B = 4, S = 512: exactly 36
   flash_attention, 36 residual_rmsnorm and 216 matmul_epilogue launches,
   the GEMMs and attention all through their tensor-core ("wgmma") forms
   (``FORWARD_FORMS``) and the norm through its rows form, every one held,
   each shape timed beside its bound, its library call
   (``F.scaled_dot_product_attention``, ``torch.matmul``; none for the
   norm, timed beside ``torch.add`` then ``F.rms_norm``) and the same
   launch in the
   CUDA-core ("fma") form, and the forward's wall time beside its kernels'
   device time; two planted tensor-core faults read against the unchanged
   holds on every launch (``lm_fault_holds``): a GEMM whose f32
   accumulator is rounded to bf16 after every 64-deep K tile must be
   flagged on at least half, a flash kernel whose PV partial sums are
   rounded to bf16 per key tile is read and printed; then every flash
   launch is read over the launch (``flash_launch_reading``: the RMS of its
   difference from the honest kernel's rounding schedule, per element in
   units of what that schedule leaves to chance, limit 1): the kernel must
   read at most 1 on every launch and the PV-rounding kernel above 1 on at
   least half;
6c. one recorded decode step at 8 slots: 0 / 36 / 216 launches, the GEMMs
   through the "decode" form (decode attention is the plain path, as in
   the reference), every one held and timed beside the fma form; the
   wrapper's host time per GEMM launch in the decode and fma forms; the
   step's wall time against its kernels' device time;
6d. 32 requests (``lm_prompts``, 16 new tokens each) served through
   ``prog.serve(mode="lm", kv_quant="int8", slots=8, max_len=64)`` with
   the counts from 0: 36 residual_rmsnorm and 216 matmul_epilogue launches
   per decode step, 0 compile misses after warmup, and all 32 streams equal
   to a static padded-batch decode of the same prompts from a fresh state,
   each in the lane (slot) it had in the engine, through the same program;
   tokens/s, TTFT and inter-token p50/p99 printed;
6e. the same model with its depth cut to 2 layers (a 36-layer CPU forward
   of 15 GB is out of reach): the v4 prefill logits (B = 1, S = 64) on the
   card against the same program on the CPU within ``E2E_LIMIT``, two to
   three times the card program's response to one-ulp noise on every
   site's input; the flash kernel with its causal mask dropped (planted)
   must exceed it;
8a. rwkv6-1.6b at full width and depth in bf16 (24 layers, d_model 2048,
   32 heads of 64, d_ff 7168, vocab 65536; 1.45 B parameters drawn on the
   card from a CUDA generator, seed 0), compiled at v4: class ``rnn_lm``,
   wkv_chunk, matmul_epilogue and mac_matmul_int8 bound to ``cuda``, no
   residual_rmsnorm;
8b. one recorded prefill forward at B = 4, S = 512 (8 chunks of 64):
   exactly 24 wkv_chunk and 48 matmul_epilogue launches (the GEMMs in the
   wgmma form, timed beside the fma form), every one held
   (``wkv_tol``: the error carried through the chunks from each column's
   own decay sum, beside the recurrence on |r|, |k|, |v|, |u|, |s0|; the
   first launch's distance from ``wkv_split_model``, the plain mirror of
   the kernel's decomposition that the CPU tests hold against the
   reference, is printed beside it), each
   shape timed beside its bound and library call (none for the
   recurrence), the forward's wall time beside its kernels' device time;
   every launch must be flagged when the kernel's bonus term is dropped or
   its contractions take bf16 operands, and most when they take TF32
   operands (planted);
8c. one recorded decode step at 8 slots: 0 launches (the reference's
   decode runs mac_matmul and plain ops only); its wall time;
8d. 32 requests through ``prog.serve(mode="lm", kv_quant=None, slots=8,
   max_len=64)`` with the counts from 0: 0 launches per decode step, 0
   compile misses after warmup, the recurrent rows of every slot zero at
   admission, and all 32 streams equal to a static decode of the same
   prompts from a fresh state in the same lanes; tokens/s, TTFT and
   inter-token p50/p99 printed;
8e. the same model cut to 2 layers: v4 prefill logits (B = 1, S = 64) on
   the card against the same program on the CPU within ``E2E_LIMIT``; the
   wkv kernel without its decay (lw = 0, planted) must exceed it, and the
   wkv with bf16 and with TF32 contractions is read against it;
8f. mac_matmul_int8, which no model path reaches: ``kernel_cases.GRID``'s
   three cases and rwkv6-1.6b's GEMM shapes at M = 8 and 2048 through the
   wrapper, and ``layers.mac_matmul(x, None, quant=quantize_weight(w))``
   under the v4 rnn_lm table, each equal to the plain int32 sum; each case
   timed beside ``torch._int_mm`` and the scale (its operands zero-padded
   to what ``_int_mm`` takes) and its bound;
11a. hymba-1.5b at full width and depth in bf16 (32 layers, d_model
   1600, 25 heads of 64 over 5 KV heads, a 1024-token window, SSM d_inner
   3200 x 16 states, d_ff 5504; ~1.6 B parameters drawn on the card, seed
   0), compiled at v4: class ``hybrid_lm``, flash_attention,
   residual_rmsnorm and matmul_epilogue bound to ``cuda``, ``ssm_chunk``
   on its plain version (no kernel in either package);
11b. one recorded prefill at B = 1, S = 2048 (two SWA blocks, sixteen SSM
   chunks a layer): exactly 224 matmul_epilogue (wgmma form, N = 1600 and
   320 ending in half a column tile) and 32 residual_rmsnorm launches, the
   report's site counts times the layers, every one held (``gemm_tol``,
   the norm's bound), each shape timed beside its bound, cuBLAS and the fma
   form; flash attention 0 launches (the window takes the plain path, as
   in the reference); the forward's wall against its kernels' time;
11c. its v4 logits against the same model at v0 on the card within
   ``HYMBA_V0_TIMES_NOISE`` times the v4 program's response to one-ulp
   noise on every site's input; a GEMM kernel that drops its residual
   (planted) must exceed that limit;
11d. 8 requests (prompts of 8-24 tokens, 16 new tokens) through
   ``prog.serve(mode="lm", kv_quant="int8", slots=8, max_len=64)``: 224
   GEMM (decode form) and 32 norm launches a step, 0 compile misses after
   warmup, every admitted slot's h/conv rows zero, all streams equal to a
   static decode in their lanes; tokens/s, TTFT; a recorded decode step
   at 8 slots held and timed, its wall against its kernels' time;
11e. the f32 smoke variant on the card: 64 decode steps (two 32-token
   windows, four SSM chunks of 16) against the v4 forward within the
   reference's atol 2e-3 / rtol 1e-3;
11f. the pure-SSM stack (``models/ssm.py::ssm_stack_forward``) compiled on
   the card: class ``ssm_lm``, 3 GEMM and 1 norm launches a layer;
12a. whisper-tiny at full width and depth in bf16 (4 encoder and 4 decoder
   layers, d_model 384, 6 heads of 64, d_ff 1536 with gelu, biases drawn
   N(0, 0.02^2) over the init's zeros so every GEMM launch carries one;
   seed 0 on the card), ``forward_lm(params, tokens, cfg, run, frames=)``
   compiled at v4 with tokens and frames as example args: class
   ``dense_lm`` (the reference's ``classify`` never returns
   ``enc_dec_lm``), its report equal number for number to the CPU
   compile's;
12b. one recorded prefill at B = 4, 1500 frames, S = 448 (Whisper's text
   context): 64 GEMM (wgmma), 8 norm and 4 flash launches (the decoder's
   causal self-attention, wgmma at d = 64; the encoder's and the
   cross-attention over 1500 frames take the plain path in both
   packages), every one held, each shape timed beside its bound and its
   library call (cuBLAS, SDPA); the forward's wall and device busy time
   against its kernels' time;
12c. its v4 logits against the same model at v0 on the card within
   ``WHISPER_V0_TIMES_NOISE`` times the response to one-ulp noise on every
   site's input; a GEMM kernel that drops its bias (planted) must exceed
   it;
12d. ``init_decode_state`` with frames for 8 slots under the v4 table (the
   encoder and each layer's cross K/V: 32 GEMM and 4 norm launches, every
   one held), then one recorded decode step (32 GEMM in the decode form, 4
   norm launches; cross-attention plain, as in the reference) held and
   timed, its wall against its kernels' time;
12e. the legacy wave loop (``ServeEngine(frames=)``, the plain versions)
   serves 8 requests with each lane's own frames: 0 launches, every stream
   equal to a static greedy decode with the same frames, tokens/s
   printed; ``python -m repro_torch.launch.serve --arch whisper-tiny``
   serves on the card, and ``--lm`` is refused;
12f. full depth at B = 1, S = 64: the card against the CPU program within
   ``E2E_LIMIT``; the smoke variant (2 + 2 layers, 16 frames) recorded at
   B = 2, S = 32: 32 GEMM, 4 norm and 6 flash launches (fma form at d =
   32), the encoder's and the cross-attention's non-causal, the latter
   with 32 queries over 16 keys, every one held;
13a. internvl2-26b at full width and depth in bf16 (48 layers, d_model
   6144, 48 heads of 128 over 8 KV heads, d_ff 16384, vocab 92553 padded
   to 92672; 19.3 B parameters drawn on the card, seed 0), ``forward_lm``
   with patches compiled at v4 with tokens and patches as example args:
   class ``dense_lm``, the three LM kernels bound to ``cuda``, the
   ``mac_matmul`` site (the patch projection and the MLP's up projection)
   on its plain version, no kernel in either package;
13b. one recorded prefill at B = 4, 256 patches + 256 tokens (S = 512):
   288 GEMM (wgmma), 48 norm (rows form, 6144 wide) and 48 flash launches
   (wgmma, d = 128, 6 query heads a KV head, causal over the prefix and
   the text), the report's site counts times the layers, every one held,
   each shape timed beside its bound, its library call and the fma form;
   the forward's wall and device busy time against its kernels' time;
13c. its v4 logits against the same model at v0 on the card (the two
   programs share the params) within ``VLM_V0_TIMES_NOISE`` times the
   response to one-ulp noise on every site's input; a GEMM kernel that
   drops its residual (planted) must exceed it;
13d. the decode state for 8 slots and one recorded decode step (288 GEMM
   in the decode form, 48 norm launches), held and timed, its wall and
   device busy time against its kernels' time;
13e. the legacy wave loop (the plain versions, from tokens alone as the
   reference's loop serves a vlm arch) serves 8 requests: 0 launches,
   every stream equal to a static greedy decode, tokens/s printed; once
   the phase's model is freed, ``python -m repro_torch.launch.serve --arch
   internvl2-26b`` serves on the card, and ``--lm`` is refused;
13f. the depth cut to 2 layers at full width: the card's logits at B = 1,
   64 patches + 64 tokens against the CPU program within ``E2E_LIMIT``; the
   flash kernel without its causal mask (planted) must exceed it;
14a. granite-34b at full width (d_model 6144, 48 heads of 128 over one KV
   head, d_ff 24576, vocab 49152) with its depth cut to ``MQA_LAYERS``
   (all 88 layers, 47 B parameters, do not fit the card), compiled at v4:
   class ``dense_lm``;
14b. one recorded prefill at B = 4, S = 512: flash with 48 query heads over
   one KV head, GEMMs with N = 128 (wk, wv) and K = 24576 (the down
   projection), every launch held and timed, the wall against the
   kernels' time;
14c. v4 against v0 on the card within ``MQA_V0_TIMES_NOISE`` times the
   noise response, the planted GEMM without its residual above it;
14d. 8 requests through ``prog.serve(mode="lm", kv_quant="int8", slots=8,
   max_len=64)`` (the int8 KV's scale planes over one head): 0 compile
   misses after warmup, every stream equal to a static decode in its lane,
   tokens/s and TTFT; one recorded decode step held and timed.
   Phases 13 and 14 print the device's peak allocation after each step
   and free their models before the next;
10a. supervised serving, in process: a ``Supervisor`` over 2 workers of the
   ResNet50 v4 program (``max_batch=8``).  A recorded 32-request wave
   (``BatchRecorder`` at the program boundary: each batch's counts from 0,
   ``PER_FORWARD``, every launch held, its logits and the probabilities
   delivered to its requests against the CPU program on the same batch
   within ``E2E_LIMIT``); a concurrent wave on the supervisor's defaults
   with the counts from 0 (the counters are bumped from both compute
   threads: the totals must come to batches x per-forward) and 0 restarts;
   a wave with worker 0 killed (``kill()``) once it owns requests: all 32
   resolved exactly once, at least one failover, the fleet healed to 2, and
   the replacement's warmup replay adds no bucket; ``prometheus()``
   printed;
10b. two process-isolated ResNet50 v4 workers (``WorkerActor``, spawned)
   sharing the card: each child's pid, kernel-library load time, bring-up
   times and peak allocation printed; a fault-free 32-request wave (0
   restarts; how many labels agree with 10a's fleet on the same images,
   the int8 activation scale being per batch); a 48-request wave with
   worker 0's pid SIGKILLed once it owns requests: all resolved exactly
   once, a process restart after the dead child is reaped, the fleet
   healed, and a 16-request wave through the replacement with 0 recompiles
   after its warmup;
10c. two process-isolated qwen3-8b v4 workers at full width and depth
   (bf16, int8 KV, 8 slots, ``max_len=64``; ``LM_SUPERVISOR``'s heartbeat
   floor) on the one card: a fault-free 32-request wave of 16 tokens each
   with 0 restarts (tokens/s, TTFT, inter-token p50/p99 printed), then the
   same wave with worker 0 SIGKILLed mid-decode: every request finishes
   with its full prompt replayed on a sibling; once the fleet is stopped,
   the same program is built here and every stream of both waves must
   equal a static decode from a fresh state in the lane it had;
9. no compiled program failed to rewrite a bucket whose graph was asked
   for (``rewrite_fallbacks``); the
   ``{"kernels": [...]}`` line (each kernel on the forward its entry
   names; the GEMM's and flash attention's tensor-core forms on the LM
   forwards under ``tensor_core_forms``, internvl2-26b's and granite-34b's
   among them; the norm on those two under ``vlm_and_mqa_forwards``) and
   the ``{"ok": true, ...}`` last line.

Per-launch tolerances.  The GEMM-shaped holds (``matmul_epilogue``, the
separable block's pointwise contraction, both products of flash attention)
bound each output element by K * eps32 times the magnitude of its products
(``gemm_tol``, ``flash_tol``: the plain products run on |a|, |b|), plus the
epilogue's roundings and, for bf16 results, one rounding to bf16 (the
tensor-core GEMM forms' bf16 output is held against the plain version's
f32 result, ``gemm_hold_tol``); the
integer kernels agree within 1e-5 (exact int32 sums; mac_matmul_int8
exactly), the pools exactly or within 1e-6, the norm within the bound of
its mean of squares (``rmsnorm_case``), and the wkv recurrence within
``wkv_tol``.

Every program runs its bound function eagerly per shape bucket; its
chess_rewritten graph (``repro_torch.core.rewrite``, the kernels as
``marvel::`` ops that reach each kernel through its module's attribute at
call time, so the recorders below see every launch) is traced and run in
phase 3c.

After phase 3a, TF32 is off for every f32 product and convolution of the
plain versions and yardsticks (``torch.backends.cuda.matmul.allow_tf32``
and ``torch.backends.cudnn.allow_tf32``), so they run in full f32.
"""
from __future__ import annotations

import asyncio
import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"int8": 1979e12, "f32": 67e12, "bf16": 989e12}
BATCH = 8
N_REQUESTS = 32
F32_EPS = 1.1920929e-07  # f32 machine epsilon, 2**-23
# unit roundoff of an output type: a result rounded to it moves by at most
# this much relative (bf16 keeps 8 significant bits)
UNIT_ROUNDOFF = {"torch.float32": 2.0**-24, "torch.bfloat16": 2.0**-8}
# logits on the card vs the same program on the CPU, per forward: two to
# three times the card's response to 1e-7 noise on every site's input
# (PERF.md)
E2E_LIMIT = {"resnet50 v4": 2e-2, "mobilenetv2 v4": 1e-1,
             "mobilenetv2 v2": 2e-1, "mobilenetv1 v4": 2e-2,
             "densenet121 v4": 1e-2, "vgg16 v4": 6e-2, "lenet5 v4": 5e-7,
             "qwen3-8b 2-layer v4": 5e-2,
             "rwkv6-1.6b 2-layer v4": 4e-2, "whisper-tiny v4": 5e-2,
             "internvl2-26b 2-layer v4": 5e-2}
V0_LIMIT = 1e-4  # the v0 forward on the card vs the CPU


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 20, trials: int = 5) -> float:
    """Device time of one call: the median over ``trials`` of the CUDA-event
    time of ``reps`` back-to-back calls, divided by ``reps``.  Each trial
    first queues a sleep kernel, so the host has enqueued the calls before
    the device reaches them and the events see device time, not the
    wrapper's Python overhead."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def bound(nbytes: float, ops: dict[str, float]):
    """(bound ms, what bounds it, bytes ms, operations ms) of one call whose
    operations are ``{type: count}`` at the peak rate of each type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = sum(n / PEAK_OPS_PER_S[kind] for kind, n in ops.items()) * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, t_bytes, t_ops


def abs_product(a, b):
    """sum_k |a_mk| |b_kn| in full f32: the magnitude a product's rounding
    error is bounded by."""
    from repro_torch.kernels.ref import full_f32

    with full_f32():
        return a.float().abs() @ b.float().abs()


def gemm_tol(k, mag, want, es=None, eb=None, res=None):
    """Per-element bound on the difference between two f32 evaluations of
    ``act(sum_k a_k b_k * es + eb [+ res])`` that sum K products in another
    order: each sum is within K * eps/2 * mag of the exact one (mag =
    sum_k |a_k b_k|), so the two within K * eps * mag; the epilogue's three
    roundings add eps/2 of each term on each side, and the act (slope <=
    1.13 for gelu's tanh form and silu) scales it; its own evaluation adds
    a few ulp of the result.  Tight enough to see TF32 operands (2**-11
    relative per product) wherever they move a sum by more than K * 2**-23
    of its magnitude."""
    es_mag = mag if es is None else mag * es.abs()
    extra = es_mag * 0
    if eb is not None:
        extra = extra + eb.abs()
    if res is not None:
        extra = extra + res.float().abs()
    return 1.2 * F32_EPS * ((k + 2) * es_mag + 2 * extra) + 4 * F32_EPS * (
        want.abs())


def held(got, want, tol):
    """(max |got - want|, max |got - want| / tol) over the elements."""
    err = (got.float() - want.float()).abs()
    return err.max().item(), (err / tol).max().item()


# ---------------------------------------------------------------------------
# one case per kernel call: wrapper vs plain, times, bound
# ---------------------------------------------------------------------------


def one_slice_ms(module, fn) -> float:
    """Time ``fn`` with the module's split-K policy forced to one slice of
    K: the GEMM-shaped kernels as they would run without split-K."""
    policy = module.split_k
    module.split_k = lambda tiles, k_iters, sms: 1
    try:
        return time_ms(fn)
    finally:
        module.split_k = policy


def untimed(label, err, tol, b):
    return label, err, tol, None, None, None, b


def conv_case(args, timed=True):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import fused_conv as fc

    x, w, es, eb, res, stride, padding, act = args
    kw = dict(stride=stride, padding=padding, act=act)
    got = fc.fused_conv_int8(x, w, es, eb, res, **kw)
    want = fc.fused_conv_int8_plain(x, w, es, eb, res, **kw)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    err = (got - want).abs().max().item()
    m = got.numel() // got.shape[-1]
    k_red = w.shape[0] * w.shape[1] * w.shape[2]
    nbytes = (x.numel() + w.numel() + 8 * w.shape[-1] + 4 * got.numel()
              + (0 if res is None else 4 * res.numel()))
    b = bound(nbytes, {"int8": 2 * m * w.shape[-1] * k_red})
    tile, splits = fc.conv_plan(
        m, w.shape[-1], k_red,
        torch.cuda.get_device_properties(x.device).multi_processor_count,
        w.shape[2])
    label = (f"fused_conv x{tuple(x.shape)} w{tuple(w.shape)} s{stride} "
             f"{padding} {act}{' +res' if res is not None else ''} "
             f"(M={m} K={k_red} N={w.shape[-1]}, tile "
             f"{fc.IMMA_TILES[tile][0]}x{fc.IMMA_TILES[tile][1]}, {splits} K "
             f"slices)")
    tol = "rtol=atol=1e-5 (int32 sums exact)"
    if not timed:
        return untimed(label, err, tol, b)
    launch = lambda: fc._launch(x, w, es, eb, res, stride, padding, act)  # noqa: E731
    ms = time_ms(launch)
    ms1 = one_slice_ms(fc, launch)
    plain = time_ms(lambda: fc.fused_conv_int8_plain(x, w, es, eb, res, **kw),
                    reps=5)
    # yardstick: the conv alone in f32 (no epilogue), channels-last cuDNN
    kh = w.shape[0]
    xf = x.permute(0, 3, 1, 2).float().contiguous(
        memory_format=torch.channels_last)
    wf = w.permute(3, 2, 0, 1).float().contiguous(
        memory_format=torch.channels_last)
    lib_out = F.conv2d(xf, wf, stride=stride, padding=kh // 2)
    lib = (time_ms(lambda: F.conv2d(xf, wf, stride=stride, padding=kh // 2))
           if tuple(lib_out.permute(0, 2, 3, 1).shape) == tuple(got.shape)
           else None)
    return (f"{label} (one K slice: {ms1:.4f} ms)", err, tol, ms, plain, lib,
            b)


def gemm_hold_tol(x2, w, es, eb, r2, want, out_dtype):
    """``gemm_tol`` of one launch; a bf16 result (the tensor-core forms)
    adds its one rounding, 2**-8 of |want|: the hold compares it with the
    plain version's f32 result, before that version's own rounding."""
    tol = gemm_tol(x2.shape[1], abs_product(x2, w), want, es, eb, r2)
    if str(out_dtype) == "torch.bfloat16":
        tol = tol + UNIT_ROUNDOFF[str(out_dtype)] * want.abs()
    return tol


def gemm_case(args, timed=True):
    """The GEMM kernel's result (f32 from the CUDA-core form, bf16 from the
    tensor-core forms) against its plain version's f32 result (operands f32
    or bf16, read as they are by both), within ``gemm_hold_tol``.  Timed:
    the form the launch takes, with one slice of K, and for a tensor-core
    form the CUDA-core form on the same operands (``fma_ms``)."""
    import torch
    from repro_torch.kernels import matmul_epilogue as me

    x2, w, es, eb, r2, act = args
    form = me.launch_form(x2, w)
    got = me._launch(x2, w, es, eb, r2, act)
    want = me._plain(x2, w, es, eb, r2, act)
    m, k = x2.shape
    n = w.shape[1]
    err, ratio = held(got, want, gemm_hold_tol(x2, w, es, eb, r2, want,
                                               got.dtype))
    assert ratio <= 1.0, ("matmul_epilogue", form, m, k, n, err, ratio)
    kind = "bf16" if x2.dtype == torch.bfloat16 else "f32"
    nbytes = (x2.element_size() * (m * k + k * n) + 8 * n
              + got.element_size() * m * n
              + (0 if r2 is None else r2.element_size() * m * n))
    b = bound(nbytes, {kind: 2 * m * n * k})
    label = (f"matmul_epilogue {kind} {form} M={m} K={k} N={n} {act}"
             f"{' +res' if r2 is not None else ''}")
    tol = f"|err| <= gemm_hold_tol(K={k}), worst {ratio:.3f} of it"
    if not timed:
        return untimed(label, err, tol, b)
    launch = lambda: me._launch(x2, w, es, eb, r2, act)  # noqa: E731
    ms = time_ms(launch)
    ms1 = one_slice_ms(me, launch)
    plain = time_ms(lambda: me._plain(x2, w, es, eb, r2, act))
    lib = time_ms(lambda: torch.matmul(x2, w))
    extra, note = {}, f"one K slice: {ms1:.4f} ms"
    if form != "fma":
        fma = time_ms(lambda: me._launch(x2, w, es, eb, r2, act, "fma"),
                      reps=5)
        extra = {"fma_ms": fma}
        note += f"; fma form {fma:.4f} ms, {fma / ms:.1f}x the {form} form"
    return f"{label} ({note})", err, tol, ms, plain, lib, b, extra


def pool_case(args, timed=True):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import pooling as pk

    x, k, stride, op = args
    got = pk.windowed_pool(x, k=k, stride=stride, op=op)
    want = pk.windowed_pool_plain(x, k=k, stride=stride, op=op)
    if op == "max":
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        tol = "equal"
    else:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
        tol = "rtol=1e-6"
    err = (got.float() - want.float()).abs().max().item()
    nbytes = x.numel() * x.element_size() + got.numel() * got.element_size()
    b = bound(nbytes, {"f32": got.numel() * k * k})
    label = f"windowed_pool {op} {k}x{k}/{stride} x{tuple(x.shape)}"
    if not timed:
        return untimed(label, err, tol, b)
    ms = time_ms(lambda: pk._launch_windowed(x, k, stride, op))
    plain = time_ms(lambda: pk.windowed_pool_plain(x, k=k, stride=stride,
                                                   op=op))
    xc = x.permute(0, 3, 1, 2)  # NHWC storage = channels-last NCHW view
    pool = F.max_pool2d if op == "max" else F.avg_pool2d
    lib = time_ms(lambda: pool(xc, k, stride))
    return label, err, tol, ms, plain, lib, b


def gap_case(args, timed=True):
    import torch
    from repro_torch.kernels import pooling as pk

    (x,) = args
    got = pk.global_avgpool(x)
    want = pk.global_avgpool_plain(x)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    err = (got - want).abs().max().item()
    nbytes = x.numel() * x.element_size() + 4 * got.numel()
    b = bound(nbytes, {"f32": x.numel()})
    label, tol = (f"global_avgpool x{tuple(x.shape)}",
                  "rtol=atol=1e-6 (sum order)")
    if not timed:
        return untimed(label, err, tol, b)
    ms = time_ms(lambda: pk._launch_gap(x))
    plain = time_ms(lambda: pk.global_avgpool_plain(x))
    lib = time_ms(lambda: x.mean(dim=(1, 2)))
    return label, err, tol, ms, plain, lib, b


def dw_case(args, timed=True):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import depthwise_conv as dw

    x, w, es, eb, stride, padding, act = args
    kw = dict(stride=stride, padding=padding, act=act)
    got = dw.depthwise_conv_int8(x, w, es, eb, **kw)
    want = dw.depthwise_conv_int8_plain(x, w, es, eb, **kw)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    err = (got - want).abs().max().item()
    kh, kw_, c = w.shape
    nbytes = x.numel() + w.numel() + 8 * c + 4 * got.numel()
    b = bound(nbytes, {"int8": 2 * got.numel() * kh * kw_})
    label = (f"depthwise_conv x{tuple(x.shape)} k{kh}x{kw_} s{stride} "
             f"{padding} {act}")
    tol = "rtol=atol=1e-5 (int32 sums exact)"
    if not timed:
        return untimed(label, err, tol, b)
    ms = time_ms(lambda: dw._launch_dw(x, w, es, eb, stride, padding, act))
    plain = time_ms(lambda: dw.depthwise_conv_int8_plain(x, w, es, eb, **kw),
                    reps=5)
    # yardstick: the depthwise conv alone in f32, channels-last cuDNN
    xf = x.permute(0, 3, 1, 2).float().contiguous(
        memory_format=torch.channels_last)
    wf = w.permute(2, 0, 1).unsqueeze(1).float().contiguous(
        memory_format=torch.channels_last)
    conv = lambda: F.conv2d(xf, wf, stride=stride, padding=kh // 2,  # noqa: E731
                            groups=c)
    lib = (time_ms(conv) if tuple(conv().permute(0, 2, 3, 1).shape)
           == tuple(got.shape) else None)
    return label, err, tol, ms, plain, lib, b


def sep_intermediate(x, wd, ds, db, stride, padding, dw_act):
    """The separable block's f32 depthwise tile (after its epilogue and
    act) as (pixels, C): the left operand of its pointwise contraction,
    bit for bit the kernel's (exact int32 sums, the same f32 epilogue)."""
    from repro_torch.kernels import depthwise_conv as dw
    from repro_torch.kernels.common import EPILOGUE_ACTS

    d = EPILOGUE_ACTS[dw_act](dw._dw_acc(x, wd, stride, padding) * ds + db)
    return d.reshape(-1, d.shape[-1])


def sep_tol(args, want):
    """gemm_tol of the separable block's pointwise contraction over C."""
    x, wd, ds, db, wp, ps, pb, stride, padding, dw_act, _ = args
    d2 = sep_intermediate(x, wd, ds, db, stride, padding, dw_act)
    mag = abs_product(d2, wp).reshape(want.shape)
    return gemm_tol(wp.shape[0], mag, want, ps, pb)


def sep_pair_ms(args) -> float:
    """The unfused library pair at a separable block's shape, a yardstick
    the port never calls: cuDNN's depthwise conv in f32 (channels last,
    TF32 off), then ``torch.matmul`` in f32."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.ref import full_f32

    x, wd, _, _, wp, _, _, stride, padding, _, _ = args
    kh, _, c = wd.shape
    xf = x.permute(0, 3, 1, 2).float().contiguous(
        memory_format=torch.channels_last)
    wf = wd.permute(2, 0, 1).unsqueeze(1).float().contiguous(
        memory_format=torch.channels_last)
    wpf = wp.float()

    def pair():
        y = F.conv2d(xf, wf, stride=stride,
                     padding=kh // 2 if padding == "SAME" else 0, groups=c)
        return torch.matmul(y.permute(0, 2, 3, 1).reshape(-1, c), wpf)

    with full_f32():
        return time_ms(pair)


def sep_case(args, timed=True):
    from repro_torch.kernels import depthwise_conv as dw

    (x, wd, ds, db, wp, ps, pb, stride, padding, dw_act, pw_act) = args
    kw = dict(stride=stride, padding=padding, dw_act=dw_act, pw_act=pw_act)
    ops = (x, wd, ds, db, wp, ps, pb)
    got = dw._launch_sep(*ops, stride, padding, dw_act, pw_act)
    want = dw.sep_block_int8_plain(*ops, **kw)
    c, cout = wp.shape
    err, ratio = held(got, want, sep_tol(args, want))
    assert ratio <= 1.0, ("sep_block", tuple(x.shape), c, cout, err, ratio)
    kh, kw_, _ = wd.shape
    m = got.numel() // cout
    nbytes = (x.numel() + wd.numel() + 8 * c + wp.numel() + 8 * cout
              + 4 * got.numel())
    b = bound(nbytes, {"int8": 2 * m * c * kh * kw_, "f32": 2 * m * c * cout})
    label = (f"sep_block x{tuple(x.shape)} C={c} Cout={cout} s{stride} "
             f"{padding} {dw_act}/{pw_act}")
    tol = f"|err| <= gemm_tol(C={c}), worst {ratio:.3f} of it"
    if not timed:
        return untimed(label, err, tol, b)
    ms = time_ms(lambda: dw._launch_sep(*ops, stride, padding, dw_act,
                                        pw_act))
    ms1 = one_slice_ms(dw, lambda: dw._launch_sep(*ops, stride, padding,
                                                  dw_act, pw_act))
    plain = time_ms(lambda: dw.sep_block_int8_plain(*ops, **kw), reps=5)
    pair = sep_pair_ms(args)
    return (f"{label} (one C slice: {ms1:.4f} ms; cuDNN depthwise + "
            f"torch.matmul {pair:.4f} ms)", err, tol, ms, plain, None, b,
            {"pair_ms": pair})


def rmsnorm_case(args, timed=True):
    """The add2i kernel against its plain version: the residual exactly
    (one f32 add, rounded once), the normed rows within the bound of a
    mean of D squares summed in another order (relative D/2 * eps, through
    the square root), a few roundings, and one rounding to the output
    type.  Timed beside ``torch.add`` then ``F.rms_norm`` on the sum (the
    unfused library pair, a yardstick the port never calls)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import residual_rmsnorm as rr
    from repro_torch.kernels.ref import residual_rmsnorm_plain

    res2, x2, scale, eps = args
    got_res, got, form = rr._launch(res2, x2, scale, eps)
    want_res, want = residual_rmsnorm_plain(res2, x2, scale, eps)
    assert torch.equal(got_res, want_res), "residual_rmsnorm: new residual"
    r, d = res2.shape
    rf = res2.float() + x2.float()
    y = rf * torch.rsqrt(rf.square().mean(-1, keepdim=True) + eps) * (
        scale.float())
    u = UNIT_ROUNDOFF[str(res2.dtype)]
    tol = (1.2 * (d / 2 + 6) * F32_EPS + 2 * u) * y.abs() + 1e-30
    err, ratio = held(got, want, tol)
    assert ratio <= 1.0, ("residual_rmsnorm", r, d, err, ratio)
    size = res2.element_size()
    nbytes = 4 * r * d * size + d * scale.element_size()
    b = bound(nbytes, {"f32": 5 * r * d})
    label = (f"residual_rmsnorm {res2.dtype} rows={r} D={d} scale "
             f"{scale.dtype}, {form} form")
    tol_s = (f"new residual equal; normed |err| <= ((D/2+6) eps + 2u) |y|, "
             f"worst {ratio:.3f} of it")
    if not timed:
        return untimed(label, err, tol_s, b)
    ms = time_ms(lambda: rr._launch(res2, x2, scale, eps))
    plain = time_ms(lambda: residual_rmsnorm_plain(res2, x2, scale, eps))
    w = scale.to(res2.dtype)
    pair = time_ms(lambda: F.rms_norm(torch.add(res2, x2), (d,), w, eps))
    return (f"{label} (torch.add + F.rms_norm {pair:.4f} ms)", err, tol_s,
            ms, plain, None, b, {"pair_ms": pair})


def flash_tol(q, k, v, causal, want):
    """Per-element bound on the kernel's difference from its plain version:
    the scores of each (q, k) pair differ by at most d * eps * (|q|.|k|) *
    scale (two sums over d), which exp carries into P and the sum l; P is
    rounded to v's type at another running max (up to two roundings, 2u of
    each p); the PV sums over Skv and the per-tile rescales; the final
    division and the rounding to q's type.  A = sum_k P_k |v_k| / l (the
    plain PV product on |v|) carries each term to the output; M is the row's
    largest |q|.|k| * scale (the QK^T product on |q|, |k|)."""
    import math

    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import NEG_INF, full_f32

    qf, kf, vf = fa.to_bh(q, k, v)
    sq, skv, d = qf.shape[1], kf.shape[1], qf.shape[-1]
    scale = 1.0 / math.sqrt(d)
    with full_f32():
        s = qf.float() @ kf.float().transpose(1, 2) * scale
        mag = qf.float().abs() @ kf.float().abs().transpose(1, 2) * scale
    if causal:
        keep = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(skv, device=q.device)[None, :])
        s = torch.where(keep, s, NEG_INF)
        mag = torch.where(keep, mag, 0.0)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    den = p.sum(-1, keepdim=True)
    with full_f32():
        a = p.to(v.dtype).float() @ vf.float().abs() / den
    m = mag.amax(-1, keepdim=True)
    u_v, u_o = UNIT_ROUNDOFF[str(v.dtype)], UNIT_ROUNDOFF[str(q.dtype)]
    n_tiles = -(-skv // 64)
    t = 1.2 * ((2 * d * m + 4 + skv + 2 * n_tiles) * F32_EPS + 2 * u_v) * a
    return fa.from_bh(t, q.shape) + 2 * u_o * want.float().abs() + 1e-30


def flash_case(args, timed=True):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa

    q, k, v, causal = args
    form = fa.launch_form(q, k, v)
    got = fa._launch(q, k, v, causal)
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    err, ratio = held(got, want, flash_tol(q, k, v, causal, want))
    b_, sq, kh, g, d = q.shape
    skv = k.shape[1]
    assert ratio <= 1.0, ("flash_attention", form, tuple(q.shape), err, ratio)
    # the work this run's mask leaves: query i meets min(i + 1, Skv) keys
    pairs = (sum(min(i + 1, skv) for i in range(sq)) if causal
             else sq * skv)
    kind = "bf16" if q.dtype == torch.bfloat16 else "f32"
    size = q.element_size()
    nbytes = size * (2 * q.numel() + 2 * k.numel())
    b = bound(nbytes, {kind: 4 * d * pairs * b_ * kh * g})
    label = (f"flash_attention {kind} {form} B={b_} Sq={sq} Skv={skv} K={kh} "
             f"G={g} d={d} {'causal' if causal else 'full'}")
    tol = f"|err| <= flash_tol, worst {ratio:.3f} of it"
    if not timed:
        return untimed(label, err, tol, b)
    ms = time_ms(lambda: fa._launch(q, k, v, causal))
    plain = time_ms(lambda: fa.flash_attention_plain(q, k, v, causal=causal),
                    reps=5)
    # yardstick: PyTorch's fused attention on (B, heads, S, d) copies
    qh = q.reshape(b_, sq, kh * g, d).transpose(1, 2).contiguous()
    kh_, vh = (t.transpose(1, 2).contiguous() for t in (k, v))
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        qh, kh_, vh, is_causal=causal, enable_gqa=True))
    extra = {}
    if form != "fma":
        fma = time_ms(lambda: fa._launch(q, k, v, causal, "fma"), reps=5)
        extra = {"fma_ms": fma}
        label += f" (fma form {fma:.4f} ms, {fma / ms:.1f}x the {form} form)"
    return label, err, tol, ms, plain, lib, b, extra


def wkv_tol(args, want, want_s):
    """Per-element bounds on the wkv kernel's difference from its plain
    version, for the output and the final state: twice the bound E on each
    side's error against the exact recurrence, which this function carries
    through the chunks beside the magnitude state Ms (the recurrence on
    |r|, |k|, |v|, |u|, |s0| with the same decays).  In chunk c, column i
    of head (b, h) sums lam = sum_t |lw[t, i]|; every cumsum of it, in any
    order, is within (C - 1) u lam of exact (u = eps/2; the terms share one
    sign), so every decay factor (an exp of a difference of two cumsums,
    with its own few ulp) is within rho = ((2 C + 1) lam + 4) u of its own
    value, relatively.  Each term of the from-state and intra-chunk sums of
    column i then carries rho + (N + C + 5) u, the bonus (N + 5) u, and
    the from-state term also the state's own error E_S; the state update
    E_S' = exp(cum[-1]) E_S + (rho + (C + 3) u) Ms'.  Tight enough to see
    TF32 operands (2**-11 relative) in the recurrence, and far tighter
    than one worst chunk sum L for every column and chunk."""
    import torch
    from repro_torch.kernels.ref import NEG_INF, full_f32

    r, k, v, lw, u, s0, chunk = args
    n, s_len = r.shape[-1], r.shape[1]
    unit = F32_EPS / 2
    ra, ka, va, ua = (t.float().abs() for t in (r, k, v, u))
    ms = s0.float().abs()
    es = torch.zeros_like(ms)
    tri = (torch.arange(chunk, device=r.device)[:, None]
           > torch.arange(chunk, device=r.device)[None, :])
    outs = []
    with full_f32():
        for c0 in range(0, s_len, chunk):
            rc, kc, vc = (t[:, c0:c0 + chunk] for t in (ra, ka, va))
            lwc = lw[:, c0:c0 + chunk].float()
            cum = torch.cumsum(lwc, dim=1)
            cx = cum - lwc
            rho = unit * ((2 * chunk + 1) * cum[:, -1].abs() + 4)  # (B,H,N)
            w = rho + (n + chunk + 5) * unit
            o_state = torch.einsum("bthi,bhij->bthj", rc * torch.exp(cx),
                                   w[..., None] * ms + es)
            dec = torch.exp(torch.where(tri[None, :, :, None, None],
                                        cx[:, :, None] - cum[:, None],
                                        NEG_INF))
            a_ = (rc[:, :, None] * (kc * w[:, None])[:, None] * dec).sum(-1)
            o_intra = torch.einsum("btsh,bshj->bthj", a_, vc)
            bonus = (rc * ua * kc).sum(-1)[..., None] * vc * ((n + 5) * unit)
            outs.append(o_state + o_intra + bonus)
            d_end = torch.exp(cum[:, -1])[..., None]
            ms_new = d_end * ms + torch.einsum(
                "bthi,bthj->bhij", kc * torch.exp(cum[:, -1:] - cum), vc)
            es = d_end * es + (rho + (chunk + 3) * unit)[..., None] * ms_new
            ms = ms_new
    e_out = torch.cat(outs, dim=1)
    return (2.4 * e_out + 4 * F32_EPS * want.abs() + 1e-30,
            2.4 * es + 4 * F32_EPS * want_s.abs() + 1e-30)


def wkv_split_model(r, k, v, lw, u, s0, chunk, sub=16):
    """A plain mirror of csrc/wkv_chunk.cu's arithmetic, for tests and for
    reading the kernel against it: (a) each chunk from the chunk alone --
    the inclusive cumsum cum and cx[t] = cum[t - 1], the bonus, A by direct
    exps inside each ``sub``-token sub-chunk and, across sub-chunks, as the
    product of the rows of a binary split (level d's upper rows times
    exp(cx - cum[e]), its lower rows times exp(cum[e] - cum), e the node's
    boundary token), the intra-chunk output A v, U = (k exp(cum[C-1] -
    cum))^T v and the decay exp(cum[C-1]); (b) the scan S_c = decay S_{c-1}
    + U_c from s0; (c) the from-state term (r exp(cx)) S_{c-1}, added as
    (from-state + intra) + bonus v.  Every exponent is <= 0.  Returns
    (out (B, S, H, N), s_final (B, H, N, N)), f32."""
    import torch
    from repro_torch.kernels.ref import NEG_INF, full_f32

    b, s_len, h, n = r.shape
    nc = s_len // chunk

    def chunks(t):  # (B, S, H, N) -> (B, H, nc, C, N)
        return t.float().reshape(b, nc, chunk, h, n).permute(0, 3, 1, 2, 4)

    rc, kc, vc, lwc = (chunks(t) for t in (r, k, v, lw))
    tok = torch.arange(chunk, device=r.device)
    same = ((tok[:, None] // sub == tok[None, :] // sub)
            & (tok[:, None] > tok[None, :]))
    nsub = -(-chunk // sub)
    with full_f32():
        # (a)
        cum = torch.cumsum(lwc, dim=3)
        cx = torch.cat([torch.zeros_like(cum[..., :1, :]), cum[..., :-1, :]],
                       dim=3)
        last = cum[..., -1, :]
        a = (rc[..., :, None, :] * kc[..., None, :, :] * torch.exp(
            torch.where(same[..., None], cx[..., :, None, :]
                        - cum[..., None, :, :], NEG_INF))).sum(-1)
        for d in range(1, (nsub - 1).bit_length() + 1):
            for base in range(0, nsub, 1 << d):
                mid = base + (1 << (d - 1))
                if mid >= nsub:
                    break
                lo, hi = sub * mid, min(sub * (base + (1 << d)), chunk)
                e = cum[..., lo - 1:lo, :]
                upper = rc[..., lo:hi, :] * torch.exp(cx[..., lo:hi, :] - e)
                lower = (kc[..., sub * base:lo, :]
                         * torch.exp(e - cum[..., sub * base:lo, :]))
                a[..., lo:hi, sub * base:lo] = upper @ lower.transpose(-1, -2)
        o_intra = a @ vc
        bonus = (rc * (u.float()[None, :, None, None, :] * kc)).sum(-1)
        kd = kc * torch.exp(last[..., None, :] - cum)
        contrib = kd.transpose(-1, -2) @ vc
        decay = torch.exp(last)[..., None]
        # (b)
        state, before = s0.float(), []
        for c in range(nc):
            before.append(state)
            state = decay[:, :, c] * state + contrib[:, :, c]
        # (c)
        o_state = (rc * torch.exp(cx)) @ torch.stack(before, dim=2)
        out = (o_state + o_intra) + bonus[..., None] * vc
    return out.permute(0, 2, 3, 1, 4).reshape(b, s_len, h, n), state


def wkv_case(args, timed=True):
    from repro_torch.kernels import wkv_chunk as wk
    from repro_torch.kernels.ref import wkv_chunk_ref

    r, k, v, lw, u, s0, chunk = args
    got, got_s = wk._launch(*args)
    want, want_s = wkv_chunk_ref(*args)
    tol, tol_s = wkv_tol(args, want, want_s)
    err, ratio = held(got, want, tol)
    err_s, ratio_s = held(got_s, want_s, tol_s)
    b, s_len, h, n = r.shape
    assert max(ratio, ratio_s) <= 1.0, ("wkv_chunk", tuple(r.shape), chunk,
                                        err, ratio, err_s, ratio_s)
    # r, k, v, lw in and out, u, s0 in and the final state out, f32; the
    # r.S readout and k v^T update (4 N^2 a token and head) and the causal
    # half of A and of A v (2 C N)
    nbytes = 4 * (5 * r.numel() + u.numel() + 2 * s0.numel())
    b_ = bound(nbytes, {"f32": b * s_len * h * (4 * n * n + 2 * chunk * n)})
    label = f"wkv_chunk B={b} S={s_len} H={h} N={n} chunk={chunk}"
    tol_s_ = (f"|err| <= wkv_tol, worst {max(ratio, ratio_s):.3f} of it "
              f"(state max_abs_err {err_s:.3e})")
    err = max(err, err_s)
    if not timed:
        return untimed(label, err, tol_s_, b_)
    # the kernel against the plain mirror of its own decomposition
    mirror, mirror_s = wkv_split_model(*args)
    label += (f" (vs wkv_split_model: max |diff| "
              f"{(got - mirror).abs().max().item():.3e}, state "
              f"{(got_s - mirror_s).abs().max().item():.3e})")
    del mirror, mirror_s
    ms = time_ms(lambda: wk._launch(*args))
    plain = time_ms(lambda: wkv_chunk_ref(*args), reps=5)
    return label, err, tol_s_, ms, plain, None, b_


def int_mm_yardstick(x, w, scale):
    """torch._int_mm plus the scale multiply on copies zero-padded to what
    it takes (M > 16, K and N multiples of 8): the same sums."""
    import torch
    import torch.nn.functional as F

    m, k = x.shape
    n = w.shape[1]
    mp = max(24, -(-m // 8) * 8)
    kp, np_ = -(-k // 8) * 8, -(-n // 8) * 8
    xp = F.pad(x, (0, kp - k, 0, mp - m))
    wp = F.pad(w, (0, np_ - n, 0, kp - k))
    sp = F.pad(scale.float().reshape(-1), (0, np_ - n))
    return (lambda: torch._int_mm(xp, wp).float() * sp), (mp, kp, np_)


def imma_selftest(dev):
    """One 16 x BN x 64 int8 tile per staged width BN through
    ``csrc/imma.cuh``'s layouts and fragment maps (``mma.sync`` s8): equal
    to the exact product.  A wrong map fails silently elsewhere."""
    import numpy as np
    import torch
    from repro_torch.kernels import build

    rng = np.random.default_rng(18)
    for bn in (32, 64, 128):
        a = torch.from_numpy(rng.integers(-128, 128, (16, 64), np.int8))
        b = torch.from_numpy(rng.integers(-128, 128, (64, bn), np.int8))
        out = torch.empty((16, bn), dtype=torch.int32, device=dev)
        ad, bd = a.to(dev), b.to(dev)
        build.check("imma_selftest", build.lib().marvel_imma_selftest(
            ad.data_ptr(), bd.data_ptr(), out.data_ptr(), bn,
            build.stream_ptr(dev)))
        assert torch.equal(out.cpu(), (a.long() @ b.long()).int()), bn
    log("imma_selftest: one int8 tensor-core tile at BN = 32, 64, 128 "
        "equals the exact product")


def mac_case(args, timed=True):
    import torch
    from repro_torch.kernels import mac_matmul as mm
    from repro_torch.kernels.fused_conv import IMMA_TILES

    x, w, scale = args
    got = mm._launch(x, w, scale)
    want = mm.mac_matmul_int8_ref(x, w, scale)
    assert torch.equal(got, want), ("mac_matmul_int8", tuple(x.shape),
                                    tuple(w.shape))
    m, k = x.shape
    n = w.shape[1]
    nbytes = x.numel() + w.numel() + 4 * n + 4 * m * n
    b = bound(nbytes, {"int8": 2 * m * k * n})
    tile, splits = mm.mac_plan(m, n, k, torch.cuda.get_device_properties(
        x.device).multi_processor_count)
    label = (f"mac_matmul_int8 M={m} K={k} N={n} (tile "
             f"{IMMA_TILES[tile][0]}x{IMMA_TILES[tile][1]}, {splits} K "
             f"slices)")
    tol = "equal (exact int32 sums)"
    if not timed:
        return untimed(label, 0.0, tol, b)
    ms = time_ms(lambda: mm._launch(x, w, scale))
    plain = time_ms(lambda: mm.mac_matmul_int8_ref(x, w, scale))
    lib_fn, padded = int_mm_yardstick(x, w, scale)
    assert torch.equal(lib_fn()[:m, :n], want), "the yardstick differs"
    lib = time_ms(lib_fn)
    return (f"{label} (library on M, K, N padded to {padded})", 0.0, tol, ms,
            plain, lib, b)


KERNELS = {
    # name: (case fn, source, replaces, the forward its times are summed over)
    "fused_conv": (conv_case, "src/repro_torch/csrc/fused_conv.cu",
                   "src/repro/kernels/fused_conv.py:134", "resnet50 v4"),
    "matmul_epilogue": (gemm_case, "src/repro_torch/csrc/matmul_epilogue.cu",
                        "src/repro/kernels/matmul_epilogue.py:105",
                        "resnet50 v4"),
    "windowed_pool": (pool_case, "src/repro_torch/csrc/pooling.cu",
                      "src/repro/kernels/pooling.py:123", "resnet50 v4"),
    "global_avgpool": (gap_case, "src/repro_torch/csrc/pooling.cu",
                       "src/repro/kernels/pooling.py:160", "resnet50 v4"),
    "depthwise_conv": (dw_case, "src/repro_torch/csrc/depthwise_conv.cu",
                       "src/repro/kernels/depthwise_conv.py:107",
                       "mobilenetv2 v2"),
    "sep_block": (sep_case, "src/repro_torch/csrc/depthwise_conv.cu",
                  "src/repro/kernels/depthwise_conv.py:197",
                  "mobilenetv2 v4"),
    "residual_rmsnorm": (rmsnorm_case,
                         "src/repro_torch/csrc/residual_rmsnorm.cu",
                         "src/repro/kernels/residual_rmsnorm.py:43",
                         "qwen3-8b v4 prefill"),
    "flash_attention": (flash_case, "src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:87",
                        "qwen3-8b v4 prefill"),
    "wkv_chunk": (wkv_case, "src/repro_torch/csrc/wkv_chunk.cu",
                  "src/repro/kernels/wkv_chunk.py:86",
                  "rwkv6-1.6b v4 prefill"),
    "mac_matmul_int8": (mac_case, "src/repro_torch/csrc/mac_matmul.cu",
                        "src/repro/kernels/mac_matmul.py:58",
                        "mac_matmul_int8 cases"),
}

# granite-34b's depth on the card: its 88 layers come to 47 B parameters,
# 94 GB in bf16, over the card's 80 GB; this cut's phase peak stays under 70
MQA_ARCH, MQA_LAYERS = "granite-34b", 48

# launches per batch-8 forward, as the reference dispatches them
PER_FORWARD = {
    "resnet50 v4": {"fused_conv": 20, "matmul_epilogue": 34,
                    "windowed_pool": 1, "global_avgpool": 1},
    "mobilenetv2 v4": {"sep_block": 17, "matmul_epilogue": 18,
                       "fused_conv": 1, "global_avgpool": 1},
    "mobilenetv2 v2": {"depthwise_conv": 17, "fused_conv": 18,
                       "global_avgpool": 1},
    "mobilenetv1 v4": {"sep_block": 13, "fused_conv": 1,
                       "matmul_epilogue": 1, "global_avgpool": 1},
    "densenet121 v4": {"fused_conv": 59, "matmul_epilogue": 62,
                       "windowed_pool": 4, "global_avgpool": 1},
    "vgg16 v4": {"fused_conv": 13, "matmul_epilogue": 2, "windowed_pool": 5},
    "lenet5 v4": {"fused_conv": 2, "matmul_epilogue": 1},
    # qwen3-8b, 36 layers: 6 GEMMs, 1 fused residual-add + norm and (prefill
    # only: decode attention takes the plain path, as in the reference) 1
    # flash attention per layer
    "qwen3-8b v4 prefill": {"flash_attention": 36, "residual_rmsnorm": 36,
                            "matmul_epilogue": 216},
    "qwen3-8b v4 decode": {"residual_rmsnorm": 36, "matmul_epilogue": 216},
    # rwkv6-1.6b, 24 layers: the wkv recurrence and the wo and cm_v
    # projections per layer in the prefill; decode runs only mac_matmul
    # (no kernel in either package) and plain ops, as in the reference
    "rwkv6-1.6b v4 prefill": {"wkv_chunk": 24, "matmul_epilogue": 48},
    "rwkv6-1.6b v4 decode": {},
    # hymba-1.5b, 32 layers: 7 GEMMs (q, k, v, o, the SSM's out_proj, the
    # MLP's gate and down projections) and 1 fused residual-add + norm per
    # layer; its sliding-window attention takes the plain path and the SSM
    # scan has no kernel, in both packages
    "hymba-1.5b v4 prefill": {"residual_rmsnorm": 32, "matmul_epilogue": 224},
    "hymba-1.5b v4 decode": {"residual_rmsnorm": 32, "matmul_epilogue": 224},
    # whisper-tiny, 4 encoder layers (q, k, v, o and the MLP's 2: 6 GEMMs
    # and 1 fused norm each) and 4 decoder layers (self q, k, v, o, cross q
    # and o, encoder_kv's k and v, the MLP's 2: 10 GEMMs and 1 fused norm
    # each); flash launches for the decoder's causal self-attention only:
    # over 1500 frames (not a multiple of the 128-key tile) the encoder and
    # the cross-attention take the plain path, as in the reference.  The
    # decode state runs the encoder and 2 cross K/V GEMMs a layer; a decode
    # step 8 GEMMs a layer (cross k/v come from the state)
    "whisper-tiny v4 prefill": {"flash_attention": 4, "residual_rmsnorm": 8,
                                "matmul_epilogue": 64},
    "whisper-tiny v4 decode state": {"residual_rmsnorm": 4,
                                     "matmul_epilogue": 32},
    "whisper-tiny v4 decode": {"residual_rmsnorm": 4, "matmul_epilogue": 32},
    # the smoke variant (2 + 2 layers, 16 frames): the encoder's and the
    # cross-attention's flash launches too (16 keys: one whole tile)
    "whisper-tiny smoke v4": {"flash_attention": 6, "residual_rmsnorm": 4,
                              "matmul_epilogue": 32},
    # internvl2-26b, 48 dense layers over its patch prefix: qwen3-8b's 6
    # GEMMs, 1 fused norm and 1 flash attention a layer; the patch
    # projection and the MLP's up projection are mac_matmul sites (no
    # kernel in either package)
    "internvl2-26b v4 prefill": {"flash_attention": 48,
                                 "residual_rmsnorm": 48,
                                 "matmul_epilogue": 288},
    "internvl2-26b v4 decode": {"residual_rmsnorm": 48,
                                "matmul_epilogue": 288},
    # granite-34b at its cut depth: the same per layer, over one KV head
    f"{MQA_ARCH} v4 prefill": {"flash_attention": MQA_LAYERS,
                               "residual_rmsnorm": MQA_LAYERS,
                               "matmul_epilogue": 6 * MQA_LAYERS},
    f"{MQA_ARCH} v4 decode": {"residual_rmsnorm": MQA_LAYERS,
                              "matmul_epilogue": 6 * MQA_LAYERS},
}

# the form each launch of a kernel with forms takes, per forward: the LMs'
# bf16 GEMMs and attention on tensor cores (wgmma; the GEMM's decode form
# at 8 slots), every f32 launch of the CNNs on CUDA cores ("fma"), every
# pool launch in its vector form (16-byte channel groups) and every norm
# launch in its rows form (the row held in registers), where a forward
# names none (DEFAULT_FORMS)
DEFAULT_FORMS = {"matmul_epilogue": "fma", "flash_attention": "fma",
                 "windowed_pool": "vector", "global_avgpool": "vector",
                 "residual_rmsnorm": "rows"}
FORWARD_FORMS = {
    "qwen3-8b v4 prefill": {"matmul_epilogue": "wgmma",
                            "flash_attention": "wgmma"},
    "qwen3-8b v4 decode": {"matmul_epilogue": "decode"},
    "rwkv6-1.6b v4 prefill": {"matmul_epilogue": "wgmma"},
    "hymba-1.5b v4 prefill": {"matmul_epilogue": "wgmma"},
    "hymba-1.5b v4 decode": {"matmul_epilogue": "decode"},
    "whisper-tiny v4 prefill": {"matmul_epilogue": "wgmma",
                                "flash_attention": "wgmma"},
    "whisper-tiny v4 decode state": {"matmul_epilogue": "wgmma"},
    "whisper-tiny v4 decode": {"matmul_epilogue": "decode"},
    # heads of 32: flash in the fma form
    "whisper-tiny smoke v4": {"matmul_epilogue": "wgmma"},
    "internvl2-26b v4 prefill": {"matmul_epilogue": "wgmma",
                                 "flash_attention": "wgmma"},
    "internvl2-26b v4 decode": {"matmul_epilogue": "decode"},
    f"{MQA_ARCH} v4 prefill": {"matmul_epilogue": "wgmma",
                               "flash_attention": "wgmma"},
    f"{MQA_ARCH} v4 decode": {"matmul_epilogue": "decode"},
}


def wrappers():
    from repro_torch.kernels import depthwise_conv as dw
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_conv as fc
    from repro_torch.kernels import mac_matmul as mm
    from repro_torch.kernels import matmul_epilogue as me
    from repro_torch.kernels import pooling as pk
    from repro_torch.kernels import residual_rmsnorm as rr
    from repro_torch.kernels import wkv_chunk as wk

    return {"fused_conv": fc.fused_conv_int8,
            "matmul_epilogue": me.matmul_epilogue,
            "windowed_pool": pk.windowed_pool,
            "global_avgpool": pk.global_avgpool,
            "depthwise_conv": dw.depthwise_conv_int8,
            "sep_block": dw.sep_block_int8,
            "residual_rmsnorm": rr.residual_rmsnorm,
            "flash_attention": fa.flash_attention,
            "wkv_chunk": wk.wkv_chunk,
            "mac_matmul_int8": mm.mac_matmul_int8}


@contextlib.contextmanager
def counted():
    """Every launch counter set to 0 on entry, the per-form counters of the
    kernels with forms too; yields the dict the counts are read into on
    exit, the forms' under ``"forms"``."""
    fns = wrappers()
    for fn in fns.values():
        fn.launches = 0
        if hasattr(fn, "launches_by_form"):
            fn.launches_by_form = dict.fromkeys(fn.launches_by_form, 0)
    counts: dict = {}
    try:
        yield counts
    finally:
        counts.update({k: fn.launches for k, fn in fns.items()})
        counts["forms"] = {k: dict(fn.launches_by_form)
                           for k, fn in fns.items()
                           if hasattr(fn, "launches_by_form")}


def record_launches(prog, *x):
    """One call of ``prog`` with every kernel launcher wrapped to record
    its inputs: ({kernel: {shape signature: [count, args of the first
    launch (cloned), [args of every later launch]]}}, launch counts of the
    call, every counter set to 0 just before it, the call's result)."""
    from repro_torch.kernels import depthwise_conv as dw
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_conv as fc
    from repro_torch.kernels import mac_matmul as mm
    from repro_torch.kernels import matmul_epilogue as me
    from repro_torch.kernels import pooling as pk
    from repro_torch.kernels import residual_rmsnorm as rr
    from repro_torch.kernels import wkv_chunk as wk

    seen: dict[str, dict] = {k: {} for k in KERNELS}
    patched = [(fc, "_launch", "fused_conv"), (me, "_launch", "matmul_epilogue"),
               (pk, "_launch_windowed", "windowed_pool"),
               (pk, "_launch_gap", "global_avgpool"),
               (dw, "_launch_dw", "depthwise_conv"),
               (dw, "_launch_sep", "sep_block"),
               (rr, "_launch", "residual_rmsnorm"),
               (fa, "_launch", "flash_attention"),
               (wk, "_launch", "wkv_chunk"),
               (mm, "_launch", "mac_matmul_int8")]
    originals = []
    for mod, attr, name in patched:
        orig = getattr(mod, attr)
        originals.append((mod, attr, orig))

        def rec(*args, _orig=orig, _name=name):
            sig = tuple((tuple(a.shape), str(a.dtype))
                        if hasattr(a, "shape") else a for a in args)
            entry = seen[_name].get(sig)
            if entry is None:
                seen[_name][sig] = [1, tuple(
                    a.clone() if hasattr(a, "clone") else a
                    for a in args), []]
            else:  # the model never writes a launch's inputs afterwards
                entry[0] += 1
                entry[2].append(args)
            return _orig(*args)

        setattr(mod, attr, rec)
    try:
        with counted() as counts:
            out = prog(*x)
    finally:
        for mod, attr, orig in originals:
            setattr(mod, attr, orig)
    return seen, counts, out


def hold(recorded, names, timed, extras=None, quiet=False):
    """Hold every recorded launch of the ``names`` kernels (and ``extras``)
    against its plain version (``quiet``: without a line per shape); with
    ``timed``, time the first launch of
    each shape and sum the times over the call's launches.  ``bound_ms`` is
    the least time of the launches run one after another: the sum over them
    of each launch's bound; ``t_bytes`` and ``t_ops`` sum its two terms."""
    extras = extras or {}
    results = {}
    for name in names:
        case_fn = KERNELS[name][0]
        rows = list(recorded[name].values())
        rows += [(0, args, []) for args in extras.get(name, [])]
        agg = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
               "library_ms": 0.0, "t_bytes": 0.0, "t_ops": 0.0,
               "bound_ms": 0.0, "per_forward": sum(c for c, _, _ in rows)}
        for cnt, args, later in rows:
            label, err, tol, ms, plain, lib, (b_ms, by, tb, to), *more = (
                case_fn(args, timed))
            for key, t in (more[0] if more else {}).items():
                agg[key] = agg.get(key, 0.0) + cnt * t
            times = ("" if ms is None else
                     f" ms={ms:.4f} plain_ms={plain:.4f} library_ms="
                     f"{'null' if lib is None else f'{lib:.4f}'}")
            if not quiet:
                log(f"  {label}: x{cnt}/forward max_abs_err={err:.3e} "
                    f"[{tol}]{times} bound_ms={b_ms:.5f} ({by})")
            for args2 in later:  # the same shape's other launches, untimed
                _, e, _, _, _, _, (b2, _, tb2, to2) = case_fn(args2, False)
                err = max(err, e)
                agg["bound_ms"] += b2 - b_ms
                agg["t_bytes"] += tb2 - tb
                agg["t_ops"] += to2 - to
            if later and not quiet:
                log(f"    and {len(later)} more launches of that shape held: "
                    f"max_abs_err={err:.3e}")
            agg["max_abs_err"] = max(agg["max_abs_err"], err)
            if ms is not None:
                agg["ms"] += cnt * ms
                agg["plain_ms"] += cnt * plain
                agg["library_ms"] = (
                    None if lib is None or agg["library_ms"] is None
                    else agg["library_ms"] + cnt * lib)
            agg["bound_ms"] += cnt * b_ms
            agg["t_bytes"] += cnt * tb
            agg["t_ops"] += cnt * to
        results[name] = agg
    return results


def check_counts(label, counts, batches=1):
    want = PER_FORWARD[label]
    for k in KERNELS:
        assert counts[k] == want.get(k, 0) * batches, (
            label, k, counts[k], want.get(k, 0), batches)
    check_forms(label, counts["forms"], batches)


def check_forms(label, forms, batches=1):
    """Every launch of a kernel with forms took the form FORWARD_FORMS
    names for this forward (DEFAULT_FORMS where it names none)."""
    want = PER_FORWARD[label]
    for k, got in forms.items():
        form = FORWARD_FORMS.get(label, {}).get(k, DEFAULT_FORMS[k])
        expect = {f: want.get(k, 0) * batches if f == form else 0
                  for f in got}
        assert got == expect, (label, k, got, expect)


def extra_cases(dev):
    """A case no recorded forward emits: a fused_conv with a residual
    operand (ResNet50 carries every residual on the GEMM)."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(1)
    x = torch.randint(-127, 128, (BATCH, 8, 8, 128), generator=g,
                      dtype=torch.int8).to(dev)
    w = torch.randint(-127, 128, (3, 3, 128, 128), generator=g,
                      dtype=torch.int8).to(dev)
    es = (torch.rand(128, generator=g) * 1e-4).to(dev)
    eb = torch.randn(128, generator=g).to(dev)
    res = torch.randn((BATCH, 8, 8, 128), generator=g).to(dev)
    return {"fused_conv": [(x, w, es, eb, res, 1, "SAME", "relu")]}


# every program this run compiles, so none may have counted a bucket whose
# rewrite failed (``rewrite_fallbacks``); a phase done with its programs
# retires them to ``RETIRED`` (their summary, fallbacks and whether they
# were rewritten at compile), so its models are freed
PROGRAMS: list = []
RETIRED: list[tuple[str, int, bool]] = []


def track_programs() -> None:
    """Record every ``marvel.compile`` of the run in ``PROGRAMS``."""
    from repro_torch import marvel

    real = marvel.compile

    def compile(*args, **kwargs):
        prog = real(*args, **kwargs)
        PROGRAMS.append(prog)
        return prog

    marvel.compile = compile


def free_card() -> None:
    """Return what the dropped models held to the card: collect any
    reference cycle still holding one (an engine's, a traceback's), then
    release the allocator's cached blocks."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def retire(start: int) -> None:
    """Record the programs compiled since ``PROGRAMS[start]`` in
    ``RETIRED`` and drop them from ``PROGRAMS``: once the phase that made
    them lets go of them, their parameters leave the card."""
    RETIRED.extend((p.summary(), p.rewrite_fallbacks, p.rewrite_baked)
                   for p in PROGRAMS[start:])
    del PROGRAMS[start:]


def rel_l2(got, want) -> float:
    import torch

    got, want = got.float(), want.float()
    return (torch.linalg.norm(got - want) / torch.linalg.norm(want)).item()


def model(name, dev):
    import torch
    from repro_torch.models.cnn import get_cnn

    init, apply, in_shape = get_cnn(name)
    return init(torch.Generator().manual_seed(0), device=dev), apply, in_shape


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def tf32_phase(dev):
    """3a: the v0 forward on the card with both TF32 flags on, against the
    CPU; the flags must come back as they were."""
    import numpy as np
    import torch
    from repro_torch import marvel
    from repro_torch.kernels import ref

    params, apply, in_shape = model("resnet50", "cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (BATCH, *in_shape)).astype(np.float32))
    want = marvel.compile(apply, x, params=params, level="v0",
                          device="cpu")(x)
    flags = (torch.backends.cudnn, torch.backends.cuda.matmul)
    for f in flags:
        f.allow_tf32 = True
    prog = marvel.compile(apply, x, params=params, level="v0", device=dev)
    got = prog(x).cpu()
    assert [f.allow_tf32 for f in flags] == [True, True], "flags changed"
    rel = rel_l2(got, want)
    real_guard = ref.full_f32
    ref.full_f32 = contextlib.nullcontext  # the baselines as they were
    try:
        unguarded = rel_l2(prog(x).cpu(), want)
    finally:
        ref.full_f32 = real_guard
    log(f"resnet50 v0 on the card with TF32 flags on: relative L2 vs the CPU "
        f"{rel:.3e} (limit {V0_LIMIT:g}); without the full-f32 guard "
        f"{unguarded:.3e}")
    assert got.shape == (BATCH, 2) and torch.isfinite(got).all()
    assert rel <= V0_LIMIT, rel


def site_noise_response(prog, batch, got, seeds: int = 3) -> float:
    """The card program's largest response, over ``seeds`` draws, to
    relative noise of one unit in the last place on the input of every
    dispatch site (1e-7 for f32 inputs, bf16's epsilon 2**-7 for bf16): the
    size of a sum-order difference in each layer, carried through the
    rest of the program (the int8 path of the CNNs).  ``batch`` is the
    program's input, or a tuple of its inputs."""
    import torch
    from repro_torch.core import dispatch

    gens: dict = {}  # the noise is drawn where the site's input lies
    orig = dispatch.call

    def noisy(pattern, baseline, *args, **kwargs):
        # the site's first tensor argument (ssm_chunk takes its params first)
        i = next(j for j, a in enumerate(args)
                 if isinstance(a, torch.Tensor))
        x = args[i]
        g = gens.get(x.device)
        if g is None:
            g = gens[x.device] = torch.Generator(
                device=x.device).manual_seed(3)
        n = torch.randn(x.shape, generator=g, device=x.device)
        if x.dtype == torch.bfloat16:
            eps = torch.finfo(x.dtype).eps
            x = (x.float() * (1 + eps * n)).to(x.dtype)
        else:
            x = x * (1 + 1e-7 * n)
        return orig(pattern, baseline, *args[:i], x, *args[i + 1:], **kwargs)

    worst = 0.0
    dispatch.call = noisy
    try:
        for _ in range(seeds):
            args = batch if isinstance(batch, tuple) else (batch,)
            worst = max(worst, rel_l2(prog(*args).cpu(), got))
    finally:
        dispatch.call = orig
    return worst


def tf32_round(t):
    """f32 rounded to TF32's 10-bit mantissa (to nearest, ties away)."""
    import torch

    return torch.bitwise_and(t.view(torch.int32) + 0x1000, -0x2000).view(
        torch.float32)


def sep_tf32_launch(x, wd, ds, db, wp, ps, pb, stride, padding, dw_act,
                    pw_act):
    """A wrong separable block: the plain version with its contraction on
    TF32 operands (f32 accumulation), as tensor cores would run it."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.common import EPILOGUE_ACTS

    d2 = sep_intermediate(x, wd, ds, db, stride, padding, dw_act)
    with ref.full_f32():
        y = tf32_round(d2) @ wp.float()
    n, ho, wo = x.shape[0], *sep_out_hw(x, wd, stride, padding)
    return EPILOGUE_ACTS[pw_act](y * ps + pb).reshape(n, ho, wo, -1)


def sep_out_hw(x, wd, stride, padding):
    from repro_torch.kernels.common import conv_out_size

    return (conv_out_size(x.shape[1], wd.shape[0], stride, padding),
            conv_out_size(x.shape[2], wd.shape[1], stride, padding))


def planted_faults(label):
    """Wrong launchers the logits check of ``label`` is read against:
    {fault: (launcher attribute of kernels.depthwise_conv, replacement,
    must the check catch it)}."""
    from repro_torch.kernels import depthwise_conv as dw

    sep, dwl = dw._launch_sep, dw._launch_dw
    if not label.startswith("mobilenet"):
        return {}
    if label == "mobilenetv2 v2":
        return {"depthwise_conv with its act dropped": (
            "_launch_dw", lambda *a: dwl(*a[:6], "none"), True)}
    return {
        "sep_block with its depthwise act dropped": (
            "_launch_sep", lambda *a: sep(*a[:9], "none", a[10]), True),
        "sep_block contracting in TF32": ("_launch_sep", sep_tf32_launch,
                                          False),
    }


def tf32_fault_holds(label, recorded) -> None:
    """The per-launch holds' power against a TF32 contraction: how many of
    the forward's recorded separable-block launches the stated tolerance
    (``gemm_tol``) flags when the contraction runs on TF32 operands; more
    than the old tolerance's 2 must."""
    from repro_torch.kernels import depthwise_conv as dw

    flagged = total = 0
    for _, first, later in recorded["sep_block"].values():
        for args in (first, *later):
            x, wd, ds, db, wp, ps, pb, stride, padding, dw_act, pw_act = args
            want = dw.sep_block_int8_plain(
                x, wd, ds, db, wp, ps, pb, stride=stride, padding=padding,
                dw_act=dw_act, pw_act=pw_act)
            _, ratio = held(sep_tf32_launch(*args), want,
                            sep_tol(args, want))
            flagged += ratio > 1.0
            total += 1
    log(f"{label}: planted fault 'sep_block contracting in TF32': the "
        f"per-launch tolerance flags {flagged} of {total} launches")
    # the old tolerance, 8*C*eps, flagged 2 (PERF.md)
    assert flagged > 2, "the per-launch holds miss a TF32 contraction"


def gemm_tf32_launch(x2, w, es, eb, r2, act):
    """A wrong f32 GEMM: the plain version on operands rounded to TF32 (f32
    sums), as tensor cores would run it."""
    from repro_torch.kernels import matmul_epilogue as me

    return me._plain(tf32_round(x2.float()), tf32_round(w.float()), es, eb,
                     r2, act)


def gemm_tf32_fault_holds(label, recorded) -> None:
    """The per-launch holds' power against a TF32 f32 GEMM: how many of the
    forward's recorded GEMM launches the unchanged ``gemm_hold_tol`` flags
    when the operands are rounded to TF32; at least half must be."""
    import torch
    from repro_torch.kernels import matmul_epilogue as me

    flagged = total = 0
    for _, first, later in recorded["matmul_epilogue"].values():
        for args in (first, *later):
            x2, w, es, eb, r2, act = args
            want = me._plain(x2, w, es, eb, r2, act)
            _, ratio = held(gemm_tf32_launch(*args), want,
                            gemm_hold_tol(x2, w, es, eb, r2, want,
                                          torch.float32))
            flagged += ratio > 1.0
            total += 1
    log(f"{label}: planted fault 'matmul_epilogue on TF32 operands': the "
        f"per-launch tolerance flags {flagged} of {total} launches")
    assert 2 * flagged >= total, "the GEMM holds miss TF32 operands"


def e2e_check(label, prog, apply, params_cpu, batch):
    """The card program's batch logits against the same program on the CPU
    (plain versions), beside the card's own response to 1e-7 noise; for
    the mobile nets, also the readings of planted faults."""
    import torch
    from repro_torch import marvel
    from repro_torch.kernels import depthwise_conv as dw

    cpu_prog = marvel.compile(apply, batch[:1].cpu(), params=params_cpu,
                              level=prog.level, backend="cuda", device="cpu")
    got = prog(batch).cpu()
    want = cpu_prog(batch.cpu())
    assert got.shape == want.shape == (BATCH, want.shape[1])
    assert torch.isfinite(got).all()
    rel = rel_l2(got, want)
    # the int8 path's own noise floor: on-the-fly per-tensor quantization
    # turns a 1-ulp change of an activation into a flipped int8 code now and
    # then, and the quantized layers amplify that; so kernels that sum in
    # another order than the CPU's cannot agree to 1e-3
    g = torch.Generator(device="cpu").manual_seed(2)
    noise = 1e-7 * torch.randn(batch.shape, generator=g).to(batch.device)
    floor = rel_l2(prog(batch * (1 + noise)).cpu(), got)
    sites = site_noise_response(prog, batch, got)
    limit = E2E_LIMIT[label]
    log(f"{label}: logits vs CPU plain path: relative L2 {rel:.3e} (limit "
        f"{limit:g}); response of the card's logits to 1e-7 relative input "
        f"noise {floor:.3e}, to 1e-7 relative noise on every site's input "
        f"(max of 3) {sites:.3e}")
    for fault, (attr, launch, caught) in planted_faults(label).items():
        real = getattr(dw, attr)
        setattr(dw, attr, launch)
        try:
            bad = rel_l2(prog(batch).cpu(), want)
        finally:
            setattr(dw, attr, real)
        log(f"{label}: planted fault '{fault}': relative L2 vs CPU "
            f"{bad:.3e} (limit {limit:g}, must be caught: {caught})")
        assert bad > limit or not caught, (fault, bad)
    assert rel <= limit, rel


def serve_phase(label, prog, apply, in_shape, params_cpu, card):
    """Serve N_REQUESTS through the async engine with the counts from 0;
    check the launches per batch, fallbacks, bucket misses and the logits
    against the same program on the CPU.  Returns the counts and the
    batch-8 forward's median wall time."""
    import numpy as np
    import torch
    from repro_torch.kernels import ref
    from repro_torch.launch.serve import random_images

    images = random_images(in_shape, N_REQUESTS)
    batch = torch.from_numpy(np.stack(images[:BATCH])).to(prog.device)
    engine = prog.serve(mode="async", max_batch=BATCH)
    fallbacks = []
    real_refs = {n: getattr(ref, n) for n in
                 ("fused_conv_ref", "matmul_epilogue_ref", "pool_ref",
                  "conv_nhwc")}
    for n, fn in real_refs.items():
        setattr(ref, n, lambda *a, _n=n, _f=fn, **k:
                fallbacks.append(_n) or _f(*a, **k))

    async def serve():
        async with engine:
            engine.warmup(in_shape)
            misses = prog.cache_misses
            batches0 = engine.batches_run
            with counted() as launches:
                t0 = time.perf_counter()
                done = await engine.submit_wave(images)
                dt = time.perf_counter() - t0
            return (done, dt, launches, engine.batches_run - batches0,
                    prog.cache_misses - misses, engine.metrics())

    try:
        done, dt, launches, n_batches, new_misses, metrics = asyncio.run(serve())
    finally:
        for n, fn in real_refs.items():
            setattr(ref, n, fn)
    assert len(done) == N_REQUESTS and all(r.done and r.error is None
                                           for r in done), "requests failed"
    assert metrics["errors"] == 0, metrics
    assert not fallbacks, f"plain fallbacks on the main path: {fallbacks}"
    assert new_misses == 0, f"{new_misses} bucket misses after warmup"
    check_counts(label, launches, n_batches)
    log(f"{label}: served {N_REQUESTS} requests in {n_batches} batches in "
        f"{dt * 1e3:.1f} ms: {N_REQUESTS / dt:.1f} req/s, "
        f"p50 {metrics['p50_latency_ms']:.2f} ms, "
        f"p99 {metrics['p99_latency_ms']:.2f} ms on {card}")
    log(f"{label}: launches on the main path: {launches}")

    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prog(batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)

    e2e_check(label, prog, apply, params_cpu, batch)
    return launches, statistics.median(walls)


# ---------------------------------------------------------------------------
# the report, int8 PTQ and the chess_rewrite pass: the six CNNs
# ---------------------------------------------------------------------------

REPORT_CNNS = ("lenet5", "vgg16", "resnet50", "mobilenetv1", "mobilenetv2",
               "densenet121")


def report_numbers(report) -> dict:
    """Every label and number of a report, for an exact comparison."""
    prof = report.profile
    return {"class": report.model_class,
            "extensions": report.recommended_extensions,
            "rewrite_stats": report.rewrite_stats,
            "rewrite_ok": report.rewrite_ok,
            "inputs": prof.as_costmodel_inputs(), "counts": dict(prof.counts),
            "conv_strides": dict(prof.conv_strides),
            "site_counts": dict(prof.site_counts),
            **{k: getattr(report, k) for k in (
                "rv32_cycles", "rv32_energy_j", "gpu_cycles", "gpu_energy_j",
                "hbm_bytes", "rv32_speedup_v4", "gpu_speedup_v4")}}


def wall_ms(fn, n: int = 5) -> float:
    """Median host wall time of ``n`` calls, each ended by a synchronize."""
    import torch

    fn()
    walls = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls)


def device_busy_ms(fn):
    """The summed device time of every kernel one call of ``fn`` launches
    (``torch.profiler``'s CUPTI trace: the port's kernels and PyTorch's
    own, each device event counted once, not again under the host op that
    launched it); None where the trace shows no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as trace:
        fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in trace.events()
                   if e.device_type == DeviceType.CUDA)
    return total_us / 1e3 if total_us > 0 else None


def report_phase(dev, card) -> None:
    """3c: each of the six CNNs compiled at v4 with int8 PTQ of its
    parameters (``quantize=True``) on the card, its report printed and held
    number for number against the same compile on the CPU, one batch-8
    forward recorded (launch counts equal ``PER_FORWARD``, every launch
    held against its plain version) and its logits against the CPU program
    within ``E2E_LIMIT``; the bucket's rewritten graph traced and run (the
    same launch counts, its logits against the unrewritten program
    ``do_rewrite=False``, expected equal), and the wall and device-busy
    time of the graph and of the eager executable."""
    import numpy as np
    import torch
    from repro_torch import marvel
    from repro_torch.kernels.common import full_f32
    from repro_torch.launch.serve import random_images

    for name in REPORT_CNNS:
        label = f"{name} v4"
        params, apply, shape = model(name, dev)
        params_cpu, _, _ = model(name, "cpu")
        x0 = torch.zeros((1, *shape))
        t0 = time.perf_counter()
        prog = marvel.compile(apply, x0.to(dev), params=params, level="v4",
                              quantize=True)
        t_compile = time.perf_counter() - t0
        cpu = marvel.compile(apply, x0, params=params_cpu, level="v4",
                             backend="cuda", quantize=True, device="cpu")
        assert prog.quantized and prog.rewrite_baked, prog.summary()
        assert prog.table == cpu.table, (prog.table, cpu.table)
        assert prog.quant_stats == cpu.quant_stats, prog.quant_stats
        same = report_numbers(prog.report) == report_numbers(cpu.report)
        log(f"{label}, int8 PTQ {prog.quant_stats}, compiled in "
            f"{t_compile:.2f} s on {card}; report equal to the CPU "
            f"compile's: {same}\n{prog.summary()}")
        assert same, (report_numbers(prog.report), report_numbers(cpu.report))

        xb = torch.from_numpy(np.stack(random_images(shape, BATCH))).to(dev)
        recorded, counts, got = record_launches(prog, xb)
        check_counts(label, counts)
        hold(recorded, [k for k in KERNELS if counts[k]], timed=False)
        del recorded
        got = got.cpu()
        want = cpu(xb.cpu())
        assert got.shape == want.shape == (BATCH, want.shape[1])
        assert torch.isfinite(got).all()
        rel = rel_l2(got, want)
        sites = site_noise_response(prog, xb, got)
        limit = E2E_LIMIT[label]
        log(f"{label} quantized: logits vs the CPU program: relative L2 "
            f"{rel:.3e} (limit {limit:g}); response to 1e-7 relative noise "
            f"on every site's input (max of 3) {sites:.3e}")
        assert rel <= limit, rel

        t0 = time.perf_counter()
        graph = prog.baked_graph(xb)
        trace_s = time.perf_counter() - t0
        assert graph is not None, prog.summary()

        def run_graph():  # the plain versions' products in full f32
            with torch.inference_mode(), full_f32():
                return graph(xb)

        with counted() as graph_counts:
            rewritten = run_graph().cpu()
        check_counts(label, graph_counts)
        plain = marvel.compile(apply, x0.to(dev), params=params, level="v4",
                               quantize=True, do_rewrite=False)
        assert plain.baked_graph(xb) is None
        unrewritten = plain(xb).cpu()
        diff = (rewritten - unrewritten).abs().max().item()
        rel_un = rel_l2(rewritten, unrewritten)
        log(f"{label} quantized: rewritten graph vs the unrewritten program "
            f"on the card: max |diff| {diff:.3e}, relative L2 {rel_un:.3e} "
            f"(limit {limit:g}); launches per forward equal: "
            f"{ {k: v for k, v in graph_counts.items() if k != 'forms'} }")
        assert rel_un <= limit, rel_un
        forms = {"rewritten graph": run_graph,
                 "eager (the bucket's executable)": lambda: prog(xb)}
        times = {form: (wall_ms(fn), device_busy_ms(fn))
                 for form, fn in forms.items()}
        log(f"{label} quantized, batch {BATCH} on {card}: the rewrite's "
            f"trace at this bucket {trace_s * 1e3:.1f} ms; " + "; ".join(
                f"{form}: wall {w:.3f} ms, device busy "
                + ("not measured" if b is None else f"{b:.3f} ms, host "
                   f"{w - b:.3f} ms") for form, (w, b) in times.items()))


# ---------------------------------------------------------------------------
# the dense-LM path: qwen3-8b at full width
# ---------------------------------------------------------------------------

LM_ARCH = "qwen3-8b"
LM_PREFILL = (4, 512)  # (B, S) of the recorded prefill forward
LM_SLOTS, LM_MAX_LEN, LM_MAX_NEW = 8, 64, 16
LM_E2E = (1, 64)  # (B, S) of the card-vs-CPU check, depth cut to 2 layers


def tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, dev) for v in tree]
    return tree.to(dev)


def tree_numel(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_numel(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(tree_numel(v) for v in tree)
    return tree.numel()


def serve_streams_check(engine, params, cfg, run, prompts, placed, done,
                        kv_quant=None):
    """Every served stream against a static decode from a fresh state
    through the decode step of ``engine`` (a ``ContinuousBatchEngine`` of
    the serving program), each prompt in the lane (slot) it had when served:
    group g holds the g-th occupant of each slot of a bucket, the other
    lanes a filler prompt.  Every op of a decode step is row-wise, so a
    lane's tokens depend on its own prompt alone."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.runtime.lm_server import static_decode

    by_uid = {r.uid: r for r in done}
    slots = engine.slots
    checked = 0
    for bucket in sorted({b for _, b, _ in placed}):
        occupants: dict[int, list[int]] = {}
        for uid, b, slot in placed:
            if b == bucket:
                occupants.setdefault(slot, []).append(uid)
        for g in range(max(len(v) for v in occupants.values())):
            lanes = [occupants.get(slot, [])[g:g + 1] for slot in range(slots)]
            lane_prompts = [prompts[u[0]] if u else [1] for u in lanes]
            st = T.init_decode_state(params, cfg, run, batch=slots,
                                     max_len=bucket, kv_quant=kv_quant)
            streams = static_decode(
                lambda s_, t_: engine._decode_fn(params, s_, t_), st,
                lane_prompts, LM_MAX_NEW, cfg.vocab)
            for u, stream in zip(lanes, streams):
                if u:
                    assert by_uid[u[0]].generated == stream, (bucket, u)
                    checked += 1
    torch.cuda.synchronize()
    return checked


def lm_program(params, cfg, run, tokens, dev):
    from repro_torch import marvel
    from repro_torch.models import transformer as T

    return marvel.compile(lambda p, t: T.forward_lm(p, t, cfg, run)[0],
                          tokens, params=params, level="v4", device=dev)


def lm_noise_and_faults(prog, inputs, want, limit):
    """The 2-layer program's logits against the CPU's, beside its response
    to one-ulp noise on every site's input; the planted fault (the flash
    kernel with its causal mask dropped) must exceed the limit.
    ``inputs``: the tokens, or a tuple of the program's inputs."""
    from repro_torch.kernels import flash_attention as fa

    args = inputs if isinstance(inputs, tuple) else (inputs,)
    got = prog(*args).cpu()
    rel = rel_l2(got, want)
    sites = site_noise_response(prog, inputs, got)
    real = fa._launch
    fa._launch = lambda q, k, v, causal: real(q, k, v, False)
    try:
        bad = rel_l2(prog(*args).cpu(), want)
    finally:
        fa._launch = real
    return got, rel, sites, bad


def gemm_rounded_acc(x2, w, es, eb, r2, act, step=64):
    """A wrong GEMM kernel: the plain version with its f32 accumulator
    rounded to bf16 after every 64-deep K tile (as a kernel that kept its
    sums in bf16 between the stages of its ring), its output in bf16."""
    import torch
    from repro_torch.kernels.ref import full_f32
    from repro_torch.models.layers import ACTS

    acc = torch.zeros((x2.shape[0], w.shape[1]), device=x2.device)
    with full_f32():
        for k0 in range(0, x2.shape[1], step):
            acc = (acc + x2[:, k0:k0 + step].float()
                   @ w[k0:k0 + step].float()).bfloat16().float()
    y = acc * es + eb
    if r2 is not None:
        y = y + r2.float()
    return ACTS[act](y).bfloat16()


def flash_tile_model(q, k, v, causal, round_pv=False, dot=None, bk=64):
    """The honest wgmma flash kernel's rounding schedule in plain PyTorch:
    the online softmax over 64-key tiles, each tile's probabilities rounded
    to v's type at the running max (the kernel's P operand), the sum l of
    the unrounded ones, the PV sums in f32 rescaled by each tile's
    correction, the output rounded to q's type.  ``round_pv``: a wrong
    kernel, its PV partial sums rounded to bf16 after every key tile (kept
    in bf16).  ``dot``: the f32 product (default the full-f32 matmul)."""
    import math

    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import NEG_INF, full_f32

    if dot is None:
        def dot(a, b):
            with full_f32():
                return a.float() @ b.float()
    qf, kf, vf = fa.to_bh(q, k, v)
    bh, sq, d = qf.shape
    skv = kf.shape[1]
    m = torch.full((bh, sq, 1), NEG_INF, device=q.device)
    l_ = torch.zeros((bh, sq, 1), device=q.device)
    acc = torch.zeros((bh, sq, d), device=q.device)
    qpos = torch.arange(sq, device=q.device)[:, None]
    for t in range(0, skv, bk):
        sc = dot(qf, kf[:, t:t + bk].transpose(1, 2)) * (1.0 / math.sqrt(d))
        if causal:
            kpos = torch.arange(t, min(t + bk, skv), device=q.device)[None]
            sc = torch.where(qpos >= kpos, sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        p = torch.exp(sc - m_new)
        corr = torch.exp(m - m_new)
        l_ = l_ * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + dot(p.to(v.dtype), vf[:, t:t + bk])
        if round_pv:
            acc = acc.bfloat16().float()
        m = m_new
    out = (acc / torch.clamp_min(l_, 1e-30)).to(q.dtype)
    return fa.from_bh(out, q.shape)


def flash_rounded_pv(q, k, v, causal):
    """A wrong flash kernel: PV partial sums rounded to bf16 per key tile."""
    return flash_tile_model(q, k, v, causal, round_pv=True)


def flash_launch_reading(q, k, v, causal, got, bk=64) -> float:
    """A launch-level reading of a flash kernel's result: the RMS over the
    launch of (got - model) / sigma, where model is the honest kernel's
    rounding schedule (``flash_tile_model``: P rounded to bf16 at the
    running max of each key tile) and sigma, per element, the RMS of what
    that schedule leaves to chance.  The f32 sums in another order: each
    score within 2 sqrt(d/12) eps |q|.|k| scale (RMS of d roundings, two
    evaluations; the row's largest), the PV sums within 2 sqrt(Skv/12) eps,
    the per-tile rescales and the division a few eps, all of A = sum_k p_k
    |v_k| / l; the score noise flips a probability's bf16 rounding with
    chance delta / u, by at most 2u p, so 4 u delta sum_k p_k^2 v_k^2 / l^2;
    with Delta the sum of the two, the output's rounding to bf16 differs
    with chance |Delta| / ulp by one ulp: sigma^2 = Delta ulp + Delta^2.
    An honest kernel reads at most 1 (the limit); a kernel that rounds
    where the schedule does not reads above it wherever that rounding is
    larger than the f32 noise."""
    import math

    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import NEG_INF, full_f32

    model = flash_tile_model(q, k, v, causal, bk=bk)
    qf, kf, vf = fa.to_bh(q, k, v)
    sq, skv, d = qf.shape[1], kf.shape[1], qf.shape[-1]
    scale = 1.0 / math.sqrt(d)
    with full_f32():
        s = qf.float() @ kf.float().transpose(1, 2) * scale
        mag = qf.float().abs() @ kf.float().abs().transpose(1, 2) * scale
    if causal:
        keep = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(skv, device=q.device)[None, :])
        s = torch.where(keep, s, NEG_INF)
        mag = torch.where(keep, mag, 0.0)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    den = p.sum(-1, keepdim=True)
    with full_f32():
        a = p @ vf.float().abs() / den
        p2v2 = p.square() @ vf.float().square() / den.square()
    delta = 2 * math.sqrt(d / 12) * F32_EPS * mag.amax(-1, keepdim=True)
    del s, mag, p
    u = UNIT_ROUNDOFF[str(v.dtype)]
    n_tiles = -(-skv // bk)
    f32 = (delta + (2 * math.sqrt(skv / 12) + n_tiles + 4) * F32_EPS) * a
    dlt = fa.from_bh(f32 + (4 * u * delta * p2v2).sqrt(), q.shape)
    _, e = torch.frexp(model.float().abs().clamp_min(1e-30))
    ulp = torch.ldexp(torch.ones_like(dlt), e - 8 if q.dtype == torch.bfloat16
                      else e - 24)
    sigma2 = dlt * ulp + dlt.square() + 1e-45
    err2 = (got.float() - model.float()).square()
    return (err2 / sigma2).mean().sqrt().item()


def lm_fault_holds(recorded) -> None:
    """The unchanged per-launch holds against wrong tensor-core kernels,
    over every recorded launch of the qwen3-8b prefill: the GEMM with its
    accumulator rounded to bf16 per 64-deep K tile must be flagged on at
    least half of them; the flash kernel with its PV partial sums rounded
    to bf16 per key tile is read and printed (flash_tol allows two bf16
    roundings of every probability and of the output, the same size as
    this fault's; PERF.md).  The flash launches are read once more, over
    the launch (``flash_launch_reading``): the honest kernel must read at
    most 1 on every launch, the wrong one above 1 on at least half."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul_epilogue as me

    def gemm_reading(args):
        x2, w, es, eb, r2, act = args
        want = me._plain(x2, w, es, eb, r2, act)
        bad = gemm_rounded_acc(*args)
        return held(bad, want, gemm_hold_tol(x2, w, es, eb, r2, want,
                                             bad.dtype))[1]

    def flash_reading(args):
        q, k, v, causal = args
        want = fa.flash_attention_plain(q, k, v, causal=causal)
        return held(flash_rounded_pv(*args), want,
                    flash_tol(q, k, v, causal, want))[1]

    faults = {"matmul_epilogue": ("its f32 accumulator rounded to bf16 "
                                  "after every 64-deep K tile", gemm_reading),
              "flash_attention": ("its PV partial sums rounded to bf16 per "
                                  "key tile", flash_reading)}
    flagged_of = {}
    for name, (what, reading) in faults.items():
        ratios = [reading(args) for _, first, later in recorded[name].values()
                  for args in (first, *later)]
        flagged = sum(x > 1.0 for x in ratios)
        log(f"{LM_ARCH} prefill: planted fault '{name} with {what}': the "
            f"unchanged per-launch hold flags {flagged} of {len(ratios)} "
            f"launches (readings {min(ratios):.3f} to {max(ratios):.3f} "
            f"times the bound)")
        flagged_of[name] = (flagged, len(ratios))
    flagged, n = flagged_of["matmul_epilogue"]
    assert 2 * flagged >= n, "the GEMM hold misses a bf16 accumulator"

    launches = [args for _, first, later in recorded["flash_attention"].values()
                for args in (first, *later)]
    honest = [flash_launch_reading(*args, fa._launch(*args))
              for args in launches]
    wrong = [flash_launch_reading(*args, flash_rounded_pv(*args))
             for args in launches]
    flagged = sum(r > 1.0 for r in wrong)
    log(f"{LM_ARCH} prefill: launch-level reading of flash_attention "
        f"(RMS of (got - tile model) / sigma, limit 1): the kernel reads "
        f"{min(honest):.4f} to {max(honest):.4f} on {len(honest)} launches; "
        f"planted fault 'flash_attention with its PV partial sums rounded to "
        f"bf16 per key tile' reads {min(wrong):.3f} to {max(wrong):.3f}, "
        f"flagged on {flagged} of {len(wrong)}")
    assert max(honest) <= 1.0, ("flash_attention launch reading", honest)
    assert 2 * flagged >= len(wrong), "the launch reading misses a bf16 PV"


def host_us(fn, n: int = 50) -> float:
    """Host time of one call of ``fn`` (microseconds), the device kept busy
    by a sleep kernel so the calls only enqueue."""
    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def lm_phases(dev, card):
    """6a-6e: qwen3-8b at full width and depth in bf16 on the card."""
    import numpy as np
    import torch
    from repro_torch.configs import RunConfig, get_arch
    from repro_torch.kernels import matmul_epilogue as me
    from repro_torch.launch.serve import lm_prompts
    from repro_torch.models import transformer as T

    n_progs = len(PROGRAMS)
    # 6a) build on the card and compile at v4
    cfg = get_arch(LM_ARCH)
    run = RunConfig(seq_len=LM_PREFILL[1], global_batch=LM_PREFILL[0],
                    mode="prefill")
    t0 = time.perf_counter()
    params = T.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    torch.cuda.synchronize()
    n_params = tree_numel(params)
    log(f"{LM_ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{n_params / 1e9:.3f} B parameters in {cfg.param_dtype} drawn on "
        f"the card in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    prog = lm_program(params, cfg, run, np.ones((1, 8), np.int32), dev)
    assert prog.model_class == "dense_lm", prog.model_class
    for pat in ("flash_attention", "residual_rmsnorm", "matmul_epilogue"):
        assert prog.resolved_extensions.get(pat) == "cuda", prog.table
    log(f"compiled {LM_ARCH} v4: {prog.summary()}")
    rng = np.random.default_rng(4)

    # 6b) one recorded prefill forward, every launch held
    b, s = LM_PREFILL
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab, (b, s)).astype(
        np.int32)).to(dev)
    rec, counts, logits = record_launches(prog, tokens)
    check_counts(f"{LM_ARCH} v4 prefill", counts)
    assert logits.shape == (b, s, cfg.vocab_padded), logits.shape
    assert torch.isfinite(logits).all(), "non-finite prefill logits"
    log(f"{LM_ARCH} v4 prefill B={b} S={s}: launches {counts}")
    del logits
    prefill = hold(rec, ("flash_attention", "residual_rmsnorm",
                         "matmul_epilogue"), timed=True)
    lm_fault_holds(rec)
    del rec
    torch.cuda.empty_cache()
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prog(tokens)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    log(f"{LM_ARCH} v4 prefill B={b} S={s}: forward "
        f"{statistics.median(walls):.2f} ms wall (median of 3), of which its "
        f"kernels' device time " + ", ".join(
            f"{k} {r['ms']:.3f} ms (plain {r['plain_ms']:.3f}, bound "
            f"{r['bound_ms']:.3f}"
            + (f", fma form {r['fma_ms']:.3f}" if "fma_ms" in r else "")
            + ")" for k, r in prefill.items()))

    # 6c) one recorded decode step at LM_SLOTS slots, after a few steps of
    # history; decode attention takes the plain path (the reference's)
    decode = prog.table.bind(
        lambda st, tk: T.decode_step(params, st, tk, cfg, run))
    state = T.init_decode_state(params, cfg, run, batch=LM_SLOTS,
                                max_len=LM_MAX_LEN)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab, (LM_SLOTS, 1)).astype(
        np.int32)).to(dev)
    with torch.inference_mode():
        for _ in range(8):
            _, state = decode(state, toks)
        rec, counts, (step_logits, _) = record_launches(decode, state, toks)
        check_counts(f"{LM_ARCH} v4 decode", counts)
        assert torch.isfinite(step_logits).all()
        log(f"{LM_ARCH} v4 decode step, {LM_SLOTS} slots: launches {counts}")
        dec = hold(rec, ("residual_rmsnorm", "matmul_epilogue"), timed=True)
        x2, w, es, eb, r2, act = next(iter(rec["matmul_epilogue"].values()))[1]
        host = {f: host_us(lambda f=f: me._launch(x2, w, es, eb, r2, act, f))
                for f in ("decode", "fma")}
        log(f"{LM_ARCH} v4 decode: host time of one GEMM launch through the "
            f"wrapper at M={x2.shape[0]} K={x2.shape[1]} N={w.shape[1]}: "
            f"decode form {host['decode']:.1f} us (two tensor maps encoded), "
            f"fma form {host['fma']:.1f} us; "
            f"{PER_FORWARD[f'{LM_ARCH} v4 decode']['matmul_epilogue']} "
            f"launches a step")
        del rec
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            decode(state, toks)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
    dec_ms = sum(r["ms"] for r in dec.values())
    log(f"{LM_ARCH} v4 decode step, {LM_SLOTS} slots: "
        f"{statistics.median(walls):.2f} ms wall (median of 5), of which its "
        f"kernels' device time {dec_ms:.3f} ms (" + ", ".join(
            f"{k} {r['ms']:.4f}, bound {r['bound_ms']:.5f}, plain "
            f"{r['plain_ms']:.4f}"
            + (f", fma form {r['fma_ms']:.3f}" if "fma_ms" in r else "")
            for k, r in dec.items()) + ") on " + card)

    # 6d) serve through the continuous-batching tier, int8 KV
    engine = prog.serve(mode="lm", cfg=cfg, run=run, kv_quant="int8",
                        slots=LM_SLOTS, max_len=LM_MAX_LEN)
    prompts = lm_prompts(cfg.vocab, N_REQUESTS)
    placed: list[tuple[int, int, int]] = []  # (uid, bucket, slot)
    alloc = engine.engine.manager.alloc

    def placing(uid, total_len):
        got = alloc(uid, total_len)
        if got is not None:
            placed.append((uid, *got))
        return got

    engine.engine.manager.alloc = placing

    async def serve():
        async with engine:
            engine.warmup()
            misses = engine.engine.compile_misses
            steps = engine.engine.decode_steps
            with counted() as launches:
                t0 = time.perf_counter()
                done = await engine.submit_wave(prompts,
                                                max_new_tokens=LM_MAX_NEW)
                dt = time.perf_counter() - t0
            return (done, dt, launches, engine.engine.decode_steps - steps,
                    engine.engine.compile_misses - misses, engine.metrics())

    done, dt, launches, steps, new_misses, m = asyncio.run(serve())
    assert len(done) == N_REQUESTS and all(
        r.done and r.error is None and len(r.generated) == LM_MAX_NEW
        for r in done), "LM requests failed"
    assert m["errors"] == 0 and new_misses == 0, (m, new_misses)
    want = PER_FORWARD[f"{LM_ARCH} v4 decode"]
    for k in KERNELS:
        assert launches[k] == want.get(k, 0) * steps, (k, launches, steps)
    check_forms(f"{LM_ARCH} v4 decode", launches["forms"], steps)
    toks_out = sum(len(r.generated) for r in done)
    log(f"{LM_ARCH} v4 serve, int8 KV, {LM_SLOTS} slots, buckets "
        f"{engine.engine.manager.bucket_lens}: {N_REQUESTS} requests, "
        f"{toks_out} tokens in {dt:.3f} s: {toks_out / dt:.1f} tokens/s, "
        f"TTFT p50 {m['ttft_p50_ms']:.1f} ms p99 {m['ttft_p99_ms']:.1f} ms, "
        f"inter-token p50 {m['intertoken_p50_ms']:.2f} ms p99 "
        f"{m['intertoken_p99_ms']:.2f} ms, {steps} decode steps, "
        f"0 compile misses after warmup, on {card}")
    log(f"{LM_ARCH} v4 serve: launches on the main path: {launches}")
    checked = serve_streams_check(engine.engine, params, cfg, run, prompts,
                                  placed, done, kv_quant="int8")
    assert checked == N_REQUESTS, checked
    log(f"{LM_ARCH} v4 serve: all {checked} request streams equal a static "
        f"decode of the same prompts from a fresh state in the same lanes "
        f"through the same program")
    del engine, state
    torch.cuda.empty_cache()

    # 6e) full width, depth cut to 2 layers: the card against the CPU
    cut = cfg.replace(n_layers=2)
    params2 = {"embed": params["embed"], "ln_f": params["ln_f"],
               "layers": params["layers"][:2]}
    e2e_tokens = rng.integers(1, cfg.vocab, LM_E2E).astype(np.int32)
    prog2 = lm_program(params2, cut, run, e2e_tokens, dev)
    from repro_torch import marvel

    cpu_prog = marvel.compile(
        lambda p, t: T.forward_lm(p, t, cut, run)[0], e2e_tokens,
        params=tree_to(params2, "cpu"), level="v4", backend="cuda",
        device="cpu")
    t0 = time.perf_counter()
    want = cpu_prog(e2e_tokens)
    cpu_s = time.perf_counter() - t0
    tok_dev = torch.from_numpy(e2e_tokens).to(dev)
    got, rel, sites, bad = lm_noise_and_faults(prog2, tok_dev, want, None)
    assert got.shape == want.shape and torch.isfinite(got).all()
    limit = E2E_LIMIT[f"{LM_ARCH} 2-layer v4"]
    log(f"{LM_ARCH} 2-layer (depth cut from {cfg.n_layers}: a 36-layer CPU "
        f"forward of 15 GB is out of reach) v4 B={LM_E2E[0]} S={LM_E2E[1]}: "
        f"logits vs the CPU program ({cpu_s:.1f} s there) relative L2 "
        f"{rel:.3e} (limit {limit:g}); response to one-ulp noise on every "
        f"site's input (max of 3) {sites:.3e}; planted fault 'flash kernel "
        f"without its causal mask' {bad:.3e}")
    assert bad > limit, ("planted no-causal-mask fault passed", bad, limit)
    assert rel <= limit, rel
    retire(n_progs)
    return prefill, dec, counts, launches


# ---------------------------------------------------------------------------
# the rnn_lm path: rwkv6-1.6b at full width, and mac_matmul_int8
# ---------------------------------------------------------------------------

RWKV_ARCH = "rwkv6-1.6b"
RWKV_PREFILL = (4, 512)  # (B, S): 8 chunks of 64
RWKV_E2E = (1, 64)  # (B, S) of the card-vs-CPU check, depth cut to 2 layers
# mac_matmul_int8's cases (M, K, N): kernel_cases.GRID's three, then
# rwkv6-1.6b's GEMM shapes at 8 decode slots and at a 2048-row prefill
MAC_CASES = [(130, 257, 140), (64, 96, 32), (1, 256, 128),
             (8, 2048, 2048), (8, 2048, 7168), (8, 7168, 2048),
             (2048, 2048, 7168)]
MAC_PATH = ("no model path in the reference; held on GRID and rwkv6-1.6b "
            "shapes")


def wkv_rounded(fn):
    """A wrong wkv kernel: the plain version with the operands of its
    contractions (r exp(cx) and the state, r and k of A, A and v, the
    decayed k and v of the state update, r and u k of the bonus) passed
    through ``fn``, as a kernel on TF32 or bf16 tensor-core operands would
    see them.  The model's r, k and v are bf16 values already, so rounding
    only the inputs would leave most of them as they are."""
    import torch
    from repro_torch.kernels.ref import NEG_INF, full_f32

    def launch(r, k, v, lw, u, s0, chunk):
        s = s0.float()
        tri = (torch.arange(chunk, device=r.device)[:, None]
               > torch.arange(chunk, device=r.device)[None, :])
        outs = []
        with full_f32():
            for c0 in range(0, r.shape[1], chunk):
                rc, kc, vc, lwc = (t[:, c0:c0 + chunk].float()
                                   for t in (r, k, v, lw))
                cum = torch.cumsum(lwc, dim=1)
                cx = cum - lwc
                o_state = torch.einsum("bthi,bhij->bthj",
                                       fn(rc * torch.exp(cx)), fn(s))
                dec = torch.exp(torch.where(tri[None, :, :, None, None],
                                            cx[:, :, None] - cum[:, None],
                                            NEG_INF))
                a_ = (fn(rc)[:, :, None] * fn(kc)[:, None] * dec).sum(-1)
                o_intra = torch.einsum("btsh,bshj->bthj", fn(a_), fn(vc))
                bonus = (fn(rc) * fn(u.float() * kc)).sum(-1)[..., None]
                outs.append(o_state + o_intra + bonus * vc)
                s = torch.exp(cum[:, -1])[..., None] * s + torch.einsum(
                    "bthi,bthj->bhij",
                    fn(kc * torch.exp(cum[:, -1:] - cum)), fn(vc))
        return torch.cat(outs, dim=1), s

    return launch


def wkv_faults():
    """Wrong wkv launchers: {fault: (launcher, how many of the prefill's
    launches the per-launch tolerance must flag: "all" or "most")}."""
    from repro_torch.kernels import wkv_chunk as wk

    real = wk._launch
    return {
        "bonus term dropped": (
            lambda r, k, v, lw, u, s0, c: real(r, k, v, lw, u * 0, s0, c),
            "all"),
        "bf16 contractions": (wkv_rounded(lambda t: t.bfloat16().float()),
                              "all"),
        "TF32 contractions": (
            wkv_rounded(lambda t: tf32_round(t.contiguous())), "most"),
    }


def wkv_fault_holds(recorded) -> None:
    """The per-launch holds' power against wrong wkv kernels: every
    recorded launch of the prefill must be flagged when the bonus term is
    dropped or the contractions take bf16 operands, and more than half
    when they take TF32 operands."""
    from repro_torch.kernels.ref import wkv_chunk_ref

    launches = [args for _, first, later in recorded["wkv_chunk"].values()
                for args in (first, *later)]
    readings = {f: [] for f in wkv_faults()}
    for args in launches:
        want, want_s = wkv_chunk_ref(*args)
        tol, tol_s = wkv_tol(args, want, want_s)
        for fault, (launch, _) in wkv_faults().items():
            bad, bad_s = launch(*args)
            readings[fault].append(max(held(bad, want, tol)[1],
                                       held(bad_s, want_s, tol_s)[1]))
    for fault, (_, must) in wkv_faults().items():
        ratios = readings[fault]
        flagged = sum(x > 1.0 for x in ratios)
        log(f"{RWKV_ARCH}: planted fault 'wkv kernel with {fault}': the "
            f"per-launch tolerance flags {flagged} of {len(ratios)} launches "
            f"(readings {min(ratios):.2f} to {max(ratios):.2f} times the "
            f"bound)")
        ok = (flagged == len(ratios) if must == "all"
              else 2 * flagged > len(ratios))
        assert ok, f"the wkv holds miss a wkv kernel with {fault}"


def rwkv_phases(dev, card):
    """8a-8e: rwkv6-1.6b at full width and depth in bf16 on the card."""
    import numpy as np
    import torch
    from repro_torch import marvel
    from repro_torch.configs import RunConfig, get_arch
    from repro_torch.launch.serve import lm_prompts
    from repro_torch.models import transformer as T
    from repro_torch.runtime.kvcache import POSITION_LEAVES

    n_progs = len(PROGRAMS)
    # 8a) build on the card and compile at v4
    cfg = get_arch(RWKV_ARCH)
    run = RunConfig(seq_len=RWKV_PREFILL[1], global_batch=RWKV_PREFILL[0],
                    mode="prefill")
    t0 = time.perf_counter()
    params = T.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    torch.cuda.synchronize()
    log(f"{RWKV_ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.d_model // cfg.rwkv_head_dim} heads of {cfg.rwkv_head_dim}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab}: {tree_numel(params) / 1e9:.3f} "
        f"B parameters in {cfg.param_dtype} (w0, u in f32) drawn on the "
        f"card in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    prog = lm_program(params, cfg, run, np.ones((1, 8), np.int32), dev)
    assert prog.model_class == "rnn_lm", prog.model_class
    for pat in ("wkv_chunk", "matmul_epilogue", "mac_matmul_int8"):
        assert prog.resolved_extensions.get(pat) == "cuda", prog.table
    assert "residual_rmsnorm" not in prog.table, prog.table
    log(f"compiled {RWKV_ARCH} v4: {prog.summary()}")
    rng = np.random.default_rng(8)

    # 8b) one recorded prefill forward, every launch held
    b, s = RWKV_PREFILL
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab, (b, s)).astype(
        np.int32)).to(dev)
    rec, counts, logits = record_launches(prog, tokens)
    check_counts(f"{RWKV_ARCH} v4 prefill", counts)
    assert logits.shape == (b, s, cfg.vocab_padded), logits.shape
    assert torch.isfinite(logits).all(), "non-finite prefill logits"
    log(f"{RWKV_ARCH} v4 prefill B={b} S={s}: launches {counts}")
    del logits
    prefill = hold(rec, ("wkv_chunk", "matmul_epilogue"), timed=True)
    wkv_fault_holds(rec)
    del rec
    torch.cuda.empty_cache()
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prog(tokens)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    log(f"{RWKV_ARCH} v4 prefill B={b} S={s}: forward "
        f"{statistics.median(walls):.2f} ms wall (median of 3), of which its "
        f"kernels' device time " + ", ".join(
            f"{k} {r['ms']:.3f} ms (plain {r['plain_ms']:.3f}, bound "
            f"{r['bound_ms']:.3f}"
            + (f", fma form {r['fma_ms']:.3f}" if "fma_ms" in r else "")
            + ")" for k, r in prefill.items()) + f" on {card}")

    # 8c) one recorded decode step at LM_SLOTS slots: mac_matmul and plain
    # ops only, as in the reference, so no kernel launches
    decode = prog.table.bind(
        lambda st, tk: T.decode_step(params, st, tk, cfg, run))
    state = T.init_decode_state(params, cfg, run, batch=LM_SLOTS,
                                max_len=LM_MAX_LEN)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab, (LM_SLOTS, 1)).astype(
        np.int32)).to(dev)
    with torch.inference_mode():
        for _ in range(8):
            _, state = decode(state, toks)
        _, counts, (step_logits, _) = record_launches(decode, state, toks)
        check_counts(f"{RWKV_ARCH} v4 decode", counts)
        assert torch.isfinite(step_logits).all()
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            decode(state, toks)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
    log(f"{RWKV_ARCH} v4 decode step, {LM_SLOTS} slots: launches {counts}; "
        f"{statistics.median(walls):.2f} ms wall (median of 5) on {card}")
    del state

    # 8d) serve through the continuous-batching tier
    engine = prog.serve(mode="lm", cfg=cfg, run=run, kv_quant=None,
                        slots=LM_SLOTS, max_len=LM_MAX_LEN)
    prompts = lm_prompts(cfg.vocab, N_REQUESTS)
    mgr = engine.engine.manager
    placed: list[tuple[int, int, int]] = []  # (uid, bucket, slot)
    stale: list[tuple[int, str]] = []  # recurrent rows not zero at admission
    alloc = mgr.alloc

    def placing(uid, total_len):
        got = alloc(uid, total_len)
        if got is not None:
            bucket, slot = got
            for name, t in mgr.pools[bucket].state["cache"].items():
                if name not in POSITION_LEAVES and bool(t[:, slot].any()):
                    stale.append((uid, name))
            placed.append((uid, bucket, slot))
        return got

    mgr.alloc = placing

    async def serve():
        async with engine:
            engine.warmup()
            misses = engine.engine.compile_misses
            steps = engine.engine.decode_steps
            with counted() as launches:
                t0 = time.perf_counter()
                done = await engine.submit_wave(prompts,
                                                max_new_tokens=LM_MAX_NEW)
                dt = time.perf_counter() - t0
            return (done, dt, launches, engine.engine.decode_steps - steps,
                    engine.engine.compile_misses - misses, engine.metrics())

    done, dt, launches, steps, new_misses, m = asyncio.run(serve())
    assert len(done) == N_REQUESTS and all(
        r.done and r.error is None and len(r.generated) == LM_MAX_NEW
        for r in done), "rwkv requests failed"
    assert m["errors"] == 0 and new_misses == 0, (m, new_misses)
    check_counts(f"{RWKV_ARCH} v4 decode", launches, steps)
    reused = len(placed) - len({(b_, s_) for _, b_, s_ in placed})
    assert not stale, f"recurrent rows not zeroed at admission: {stale}"
    assert reused >= N_REQUESTS // 2, reused
    toks_out = sum(len(r.generated) for r in done)
    log(f"{RWKV_ARCH} v4 serve, {LM_SLOTS} slots, buckets "
        f"{mgr.bucket_lens}: {N_REQUESTS} requests, {toks_out} tokens in "
        f"{dt:.3f} s: {toks_out / dt:.1f} tokens/s, TTFT p50 "
        f"{m['ttft_p50_ms']:.1f} ms p99 {m['ttft_p99_ms']:.1f} ms, "
        f"inter-token p50 {m['intertoken_p50_ms']:.2f} ms p99 "
        f"{m['intertoken_p99_ms']:.2f} ms, {steps} decode steps, 0 kernel "
        f"launches and 0 compile misses after warmup, on {card}")
    checked = serve_streams_check(engine.engine, params, cfg, run, prompts,
                                  placed, done)
    assert checked == N_REQUESTS, checked
    log(f"{RWKV_ARCH} v4 serve: all {checked} request streams equal a "
        f"static decode of the same prompts from a fresh state in the same "
        f"lanes; the {reused} admissions to a reused slot found its "
        f"recurrent rows zero")
    del engine
    torch.cuda.empty_cache()

    # 8e) full width, depth cut to 2 layers: the card against the CPU
    from repro_torch.kernels import wkv_chunk as wk

    cut = cfg.replace(n_layers=2)
    params2 = dict(params, layers=params["layers"][:2])
    e2e_tokens = rng.integers(1, cfg.vocab, RWKV_E2E).astype(np.int32)
    prog2 = lm_program(params2, cut, run, e2e_tokens, dev)
    cpu_prog = marvel.compile(
        lambda p, t: T.forward_lm(p, t, cut, run)[0], e2e_tokens,
        params=tree_to(params2, "cpu"), level="v4", backend="cuda",
        device="cpu")
    t0 = time.perf_counter()
    want = cpu_prog(e2e_tokens)
    cpu_s = time.perf_counter() - t0
    tok_dev = torch.from_numpy(e2e_tokens).to(dev)
    got = prog2(tok_dev).cpu()
    assert got.shape == want.shape and torch.isfinite(got).all()
    rel = rel_l2(got, want)
    sites = site_noise_response(prog2, tok_dev, got)
    real = wk._launch
    faults = {"without its decay (lw = 0)": lambda r, k, v, lw, u, s0, c:
              real(r, k, v, lw * 0, u, s0, c)}
    faults.update({f"with {f}": launch for f, (launch, _) in
                   wkv_faults().items() if f != "bonus term dropped"})
    bad = {}
    for fault, launch in faults.items():
        wk._launch = launch
        try:
            bad[fault] = rel_l2(prog2(tok_dev).cpu(), want)
        finally:
            wk._launch = real
    limit = E2E_LIMIT[f"{RWKV_ARCH} 2-layer v4"]
    log(f"{RWKV_ARCH} 2-layer (depth cut from {cfg.n_layers}) v4 "
        f"B={RWKV_E2E[0]} S={RWKV_E2E[1]}: logits vs the CPU program "
        f"({cpu_s:.1f} s there) relative L2 {rel:.3e} (limit {limit:g}); "
        f"response to one-ulp noise on every site's input (max of 3) "
        f"{sites:.3e}; planted faults (only the first must exceed the "
        f"limit): " + ", ".join(f"'wkv kernel {f}' {x:.3e}"
                                for f, x in bad.items()))
    no_decay = bad["without its decay (lw = 0)"]
    assert no_decay > limit, ("planted no-decay fault passed", no_decay,
                              limit)
    assert rel <= limit, rel
    retire(n_progs)
    return prefill


def mac_phase(dev, card):
    """8f: mac_matmul_int8, which no model path reaches: every case through
    the wrapper (counted) and through ``layers.mac_matmul(x, None,
    quant=quantize_weight(w))`` under the v4 rnn_lm table, each held
    exactly against the plain int32 sum; then each case timed."""
    import numpy as np
    import torch
    from repro_torch.core import dispatch
    from repro_torch.core.extensions import resolve_table
    from repro_torch.kernels import mac_matmul as mm
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    from repro_torch.quant.ptq import quantize_weight

    rng = np.random.default_rng(9)
    cases = []
    for m, k, n in MAC_CASES:
        x = torch.from_numpy(rng.integers(-127, 128, (m, k), np.int8)).to(dev)
        w = torch.from_numpy(rng.integers(-127, 128, (k, n), np.int8)).to(dev)
        sc = torch.from_numpy((rng.random(n) * 0.02).astype(np.float32)).to(
            dev)
        cases.append((x, w, sc))
    xf = torch.from_numpy(rng.standard_normal((LM_SLOTS, 2048)).astype(
        np.float32)).to(dev, torch.bfloat16)
    q = quantize_weight(torch.from_numpy(
        (rng.standard_normal((2048, 2048)) / np.sqrt(2048)).astype(
            np.float32)).to(dev, torch.bfloat16))
    table = resolve_table("v4", "cuda", model_class="rnn_lm")
    with counted() as launches:
        outs = [mm.mac_matmul_int8(*args) for args in cases]
        with dispatch.use_table(table):
            via_layer = L.mac_matmul(xf, None, quant=q)
    for args, got in zip(cases, outs):
        assert torch.equal(got, mm.mac_matmul_int8_ref(*args)), [
            tuple(a.shape) for a in args]
    codes, xs = ops._quant_rows(xf)
    want = (mm.mac_matmul_int8_ref(codes, q["w_int8"], q["scale"]) * xs).to(
        xf.dtype)
    assert torch.equal(via_layer, want), "layers.mac_matmul(quant=...)"
    assert launches["mac_matmul_int8"] == len(cases) + 1, launches
    log(f"mac_matmul_int8: {launches['mac_matmul_int8']} wrapper launches "
        f"held exactly ({len(cases)} cases and layers.mac_matmul(quant=...) "
        f"at M={LM_SLOTS} K=N=2048 under the v4 rnn_lm table)")
    recorded = {"mac_matmul_int8": {i: [1, args, []]
                                    for i, args in enumerate(cases)}}
    res = hold(recorded, ("mac_matmul_int8",), timed=True)
    log(f"mac_matmul_int8: its {len(cases)} cases on {card}: kernel "
        f"{res['mac_matmul_int8']['ms']:.4f} ms, plain "
        f"{res['mac_matmul_int8']['plain_ms']:.4f} ms, torch._int_mm "
        f"{res['mac_matmul_int8']['library_ms']:.4f} ms in all")
    return res, launches["mac_matmul_int8"]


# ---------------------------------------------------------------------------
# the hybrid_lm path: hymba-1.5b at full width, and the ssm_lm stack
# ---------------------------------------------------------------------------

HYMBA_ARCH = "hymba-1.5b"
# (B, S) of the recorded prefill: two SWA blocks of 1024 and sixteen SSM
# chunks of 128 a layer
HYMBA_PREFILL = (1, 2048)
HYMBA_REQUESTS, HYMBA_PROMPT_LENS = 8, (8, 24)
# the v4 logits against the same model at v0 on the card: at most this many
# times the v4 program's response to one-ulp noise on every site's input
HYMBA_V0_TIMES_NOISE = 3.0
# (B, S) of the f32 smoke decode against the forward: two 32-token windows,
# four SSM chunks of 16; the reference's own atol and rtol
HYMBA_DECODE = (2, 64)
HYMBA_DECODE_TOL = dict(atol=2e-3, rtol=1e-3)


def hymba_phases(dev, card):
    """11a-11f: hymba-1.5b at full width and depth in bf16 on the card, its
    f32 smoke variant's decode against its forward, and the ssm_lm
    stack."""
    import numpy as np
    import torch
    from repro_torch import marvel
    from repro_torch.configs import RunConfig, get_arch, smoke_variant
    from repro_torch.kernels import matmul_epilogue as me
    from repro_torch.models import ssm as SSM
    from repro_torch.models import transformer as T
    from repro_torch.runtime.kvcache import POSITION_LEAVES

    t_phase = time.perf_counter()
    n_progs = len(PROGRAMS)
    # 11a) build on the card and compile at v4
    cfg = get_arch(HYMBA_ARCH)
    run = RunConfig(seq_len=HYMBA_PREFILL[1], global_batch=HYMBA_PREFILL[0],
                    mode="prefill")
    t0 = time.perf_counter()
    params = T.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    torch.cuda.synchronize()
    log(f"{HYMBA_ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads of {cfg.d_head} over {cfg.n_kv_heads} KV heads, "
        f"a {cfg.sliding_window}-token window, SSM d_inner "
        f"{cfg.ssm_d_inner} x {cfg.ssm_state} states, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}: {tree_numel(params) / 1e9:.3f} B parameters in "
        f"{cfg.param_dtype} (A_log, D in f32) drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    t0 = time.perf_counter()
    prog = lm_program(params, cfg, run, np.ones((1, 8), np.int32), dev)
    assert prog.model_class == "hybrid_lm", prog.model_class
    for pat in ("flash_attention", "residual_rmsnorm", "matmul_epilogue"):
        assert prog.resolved_extensions.get(pat) == "cuda", prog.table
    assert "ssm_chunk" not in prog.table, prog.table
    sites = prog.profile.site_counts
    log(f"compiled {HYMBA_ARCH} v4 in {time.perf_counter() - t0:.1f} s: "
        f"{prog.summary()}")
    rng = np.random.default_rng(11)

    # 11b) one recorded prefill forward, every launch held
    b, s = HYMBA_PREFILL
    label = f"{HYMBA_ARCH} v4 prefill"
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab, (b, s)).astype(
        np.int32)).to(dev)
    rec, counts, logits = record_launches(prog, tokens)
    check_counts(label, counts)
    for k in ("matmul_epilogue", "residual_rmsnorm"):
        assert counts[k] == sites[k] * cfg.n_layers, (k, counts[k], sites)
    assert sites["flash_attention"] == 1 and counts["flash_attention"] == 0
    assert logits.shape == (b, s, cfg.vocab_padded), logits.shape
    assert torch.isfinite(logits).all(), "non-finite prefill logits"
    got4 = logits.float().cpu()
    del logits
    log(f"{label} B={b} S={s}: launches {counts}; the report's sites a "
        f"layer x {cfg.n_layers} layers: matmul_epilogue "
        f"{sites['matmul_epilogue']}, residual_rmsnorm "
        f"{sites['residual_rmsnorm']}; flash_attention: "
        f"{sites['flash_attention']} site a layer and 0 launches, as in the "
        f"reference (its {cfg.sliding_window}-token window takes the plain "
        f"blocked path); ssm_chunk {sites['ssm_chunk']} site a layer, no "
        f"kernel in either package")
    prefill = hold(rec, ("residual_rmsnorm", "matmul_epilogue"), timed=True)
    del rec
    torch.cuda.empty_cache()
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prog(tokens)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    log(f"{label} B={b} S={s}: forward {statistics.median(walls):.2f} ms "
        f"wall (median of 3), of which its kernels' device time " + ", ".join(
            f"{k} {r['ms']:.3f} ms (plain {r['plain_ms']:.3f}, bound "
            f"{r['bound_ms']:.3f}"
            + ("" if r["library_ms"] is None
               else f", cuBLAS {r['library_ms']:.3f}")
            + (f", fma form {r['fma_ms']:.3f}" if "fma_ms" in r else "")
            + ")" for k, r in prefill.items()) + f" on {card}")

    # 11c) the v4 logits against the same model at v0 on the card
    prog0 = marvel.compile(
        lambda p, t: T.forward_lm(p, t, cfg, run)[0],
        np.ones((1, 8), np.int32), params=params, level="v0", device=dev)
    with counted() as v0_launches:
        want0 = prog0(tokens).float().cpu()
    assert all(v0_launches[k] == 0 for k in KERNELS), v0_launches
    rel = rel_l2(got4, want0)
    noise = site_noise_response(prog, tokens, got4, seeds=2)
    limit = HYMBA_V0_TIMES_NOISE * noise
    real = me._launch
    me._launch = lambda x2, w, es, eb, r2, act, form=None: real(
        x2, w, es, eb, None, act, form)
    try:
        bad = rel_l2(prog(tokens).float().cpu(), want0)
    finally:
        me._launch = real
    log(f"{label}: logits vs the same model at v0 on the card (plain "
        f"versions, no launch) relative L2 {rel:.3e}; response to one-ulp "
        f"noise on every site's input (max of 2) {noise:.3e}, limit "
        f"{HYMBA_V0_TIMES_NOISE:g} times that, {limit:.3e}; planted fault "
        f"'GEMM kernel without its residual' {bad:.3e}")
    assert rel <= limit, (rel, limit)
    assert bad > limit, ("planted no-residual fault passed", bad, limit)
    del prog0, want0, got4
    torch.cuda.empty_cache()

    # 11d) serve through the continuous-batching tier, int8 KV; then one
    # recorded decode step at LM_SLOTS slots
    engine = prog.serve(mode="lm", cfg=cfg, run=run, kv_quant="int8",
                        slots=LM_SLOTS, max_len=LM_MAX_LEN)
    lo, hi = HYMBA_PROMPT_LENS
    prompts = [rng.integers(1, cfg.vocab, int(rng.integers(lo, hi + 1))
                            ).tolist() for _ in range(HYMBA_REQUESTS)]
    mgr = engine.engine.manager
    placed: list[tuple[int, int, int]] = []  # (uid, bucket, slot)
    stale: list[tuple[int, str]] = []  # SSM rows not zero at admission
    alloc = mgr.alloc

    def placing(uid, total_len):
        got = alloc(uid, total_len)
        if got is not None:
            bucket, slot = got
            for name, t in mgr.pools[bucket].state["cache"].items():
                if name not in POSITION_LEAVES and bool(t[:, slot].any()):
                    stale.append((uid, name))
            placed.append((uid, bucket, slot))
        return got

    mgr.alloc = placing

    async def serve():
        async with engine:
            engine.warmup()
            misses = engine.engine.compile_misses
            steps = engine.engine.decode_steps
            with counted() as launches:
                t0 = time.perf_counter()
                done = await engine.submit_wave(prompts,
                                                max_new_tokens=LM_MAX_NEW)
                dt = time.perf_counter() - t0
            return (done, dt, launches, engine.engine.decode_steps - steps,
                    engine.engine.compile_misses - misses, engine.metrics())

    done, dt, launches, steps, new_misses, m = asyncio.run(serve())
    assert len(done) == HYMBA_REQUESTS and all(
        r.done and r.error is None and len(r.generated) == LM_MAX_NEW
        for r in done), "hymba requests failed"
    assert m["errors"] == 0 and new_misses == 0, (m, new_misses)
    check_counts(f"{HYMBA_ARCH} v4 decode", launches, steps)
    assert not stale, f"SSM rows not zeroed at admission: {stale}"
    toks_out = sum(len(r.generated) for r in done)
    log(f"{HYMBA_ARCH} v4 serve, int8 KV (SSM state f32), {LM_SLOTS} slots, "
        f"buckets {mgr.bucket_lens}: {HYMBA_REQUESTS} requests (prompts of "
        f"{lo}-{hi} tokens), {toks_out} tokens in {dt:.3f} s: "
        f"{toks_out / dt:.1f} tokens/s, TTFT p50 {m['ttft_p50_ms']:.1f} ms "
        f"p99 {m['ttft_p99_ms']:.1f} ms, inter-token p50 "
        f"{m['intertoken_p50_ms']:.2f} ms p99 {m['intertoken_p99_ms']:.2f} "
        f"ms, {steps} decode steps, 0 compile misses after warmup, on {card}")
    checked = serve_streams_check(engine.engine, params, cfg, run, prompts,
                                  placed, done, kv_quant="int8")
    assert checked == HYMBA_REQUESTS, checked
    log(f"{HYMBA_ARCH} v4 serve: all {checked} request streams equal a "
        f"static decode of the same prompts from a fresh state in the same "
        f"lanes; every admitted slot's h/conv rows were zero")
    decode = prog.table.bind(
        lambda st, tk: T.decode_step(params, st, tk, cfg, run))
    state = T.init_decode_state(params, cfg, run, batch=LM_SLOTS,
                                max_len=LM_MAX_LEN, kv_quant="int8")
    toks = torch.from_numpy(rng.integers(1, cfg.vocab, (LM_SLOTS, 1)).astype(
        np.int32)).to(dev)
    with torch.inference_mode():
        for _ in range(8):
            _, state = decode(state, toks)
        rec, counts, (step_logits, _) = record_launches(decode, state, toks)
        check_counts(f"{HYMBA_ARCH} v4 decode", counts)
        assert torch.isfinite(step_logits).all()
        dec = hold(rec, ("residual_rmsnorm", "matmul_epilogue"), timed=True)
        del rec
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            decode(state, toks)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
    dec_ms = sum(r["ms"] for r in dec.values())
    log(f"{HYMBA_ARCH} v4 decode step, {LM_SLOTS} slots, int8 KV: launches "
        f"{counts}; {statistics.median(walls):.2f} ms wall (median of 5), of "
        f"which its kernels' device time {dec_ms:.3f} ms (" + ", ".join(
            f"{k} {r['ms']:.3f}, bound {r['bound_ms']:.3f}"
            for k, r in dec.items()) + f") on {card}")
    del engine, state
    torch.cuda.empty_cache()

    # 11e) the f32 smoke variant on the card: token-by-token decode against
    # the full forward, across the rolling window and several SSM chunks
    scfg = smoke_variant(cfg).replace(param_dtype="float32")
    b2, s2 = HYMBA_DECODE
    srun = RunConfig(seq_len=s2, global_batch=b2, attn_chunk=32, ssm_chunk=16)
    sparams = T.init_params(torch.Generator(device=dev).manual_seed(1), scfg)
    stoks = torch.from_numpy(rng.integers(1, scfg.vocab, (b2, s2)).astype(
        np.int32)).to(dev)
    sprog = marvel.compile(lambda p, t: T.forward_lm(p, t, scfg, srun)[0],
                           stoks, params=sparams, level="v4", device=dev)
    with counted() as fwd_launches:
        fwd = sprog(stoks)
    step = sprog.table.bind(
        lambda st, tk: T.decode_step(sparams, st, tk, scfg, srun))
    state = T.init_decode_state(sparams, scfg, srun, batch=b2, max_len=s2)
    outs = []
    with torch.inference_mode(), counted() as dec_launches:
        for i in range(s2):
            lg, state = step(state, stoks[:, i:i + 1])
            outs.append(lg)
    got = torch.cat(outs, dim=1)
    err = (got - fwd).abs()
    ratio = (err / (HYMBA_DECODE_TOL["atol"] + HYMBA_DECODE_TOL["rtol"]
                    * fwd.abs())).max().item()
    fwd_n = {k: fwd_launches[k] for k in KERNELS if fwd_launches[k]}
    dec_n = {k: dec_launches[k] for k in KERNELS if dec_launches[k]}
    log(f"{HYMBA_ARCH} smoke variant in f32 (window {scfg.sliding_window}, "
        f"SSM chunks of {srun.ssm_chunk}), B={b2} S={s2}: {s2} decode steps "
        f"against the v4 forward: max |diff| {err.max().item():.3e}, worst "
        f"{ratio:.3f} of atol {HYMBA_DECODE_TOL['atol']:g} + rtol "
        f"{HYMBA_DECODE_TOL['rtol']:g} |forward|; launches: forward "
        f"{fwd_n}, decode {dec_n}")
    assert ratio <= 1.0, ratio
    assert fwd_launches["matmul_epilogue"] > 0 < dec_launches[
        "matmul_epilogue"]

    # 11f) the pure-SSM stack, the ssm_lm exemplar, compiled on the card
    kcfg = smoke_variant(cfg)
    kparams = SSM.ssm_stack_init(torch.Generator(device=dev).manual_seed(2),
                                 kcfg)
    ktoks = torch.from_numpy(rng.integers(1, kcfg.vocab, (1, 64)).astype(
        np.int32)).to(dev)
    kprog = marvel.compile(
        lambda p, t: SSM.ssm_stack_forward(p, t, kcfg, srun)[0], ktoks,
        params=kparams, level="v4", device=dev)
    assert kprog.model_class == "ssm_lm", kprog.model_class
    with counted() as k_launches:
        klog = kprog(ktoks)
    k_n = {k: k_launches[k] for k in KERNELS if k_launches[k]}
    assert torch.isfinite(klog).all()
    assert k_launches["matmul_epilogue"] == 3 * kcfg.n_layers, k_launches
    assert k_launches["residual_rmsnorm"] == kcfg.n_layers, k_launches
    log(f"ssm_stack ({kcfg.n_layers} layers of the {HYMBA_ARCH} smoke "
        f"widths, bf16) compiled on the card: {kprog.summary()}; one forward "
        f"B=1 S=64: launches {k_n}")
    log(f"{HYMBA_ARCH} phases: {time.perf_counter() - t_phase:.1f} s")
    del params, prog
    retire(n_progs)
    free_card()
    return prefill, dec


# ---------------------------------------------------------------------------
# the enc_dec path: whisper-tiny at full width and depth
# ---------------------------------------------------------------------------

WHISPER_ARCH = "whisper-tiny"
# (B, frames, S) of the recorded prefill: the encoder's 1500 frames (30 s
# of audio) and Whisper's 448-token text context (arXiv:2212.04356)
WHISPER_PREFILL = (4, 1500, 448)
WHISPER_REQUESTS = 8
# the v4 logits against the same model at v0 on the card: at most this many
# times the v4 program's response to one-ulp noise on every site's input
WHISPER_V0_TIMES_NOISE = 3.0
WHISPER_E2E = (1, 64)  # (B, S) of the card-vs-CPU check, full depth
WHISPER_SMOKE = (2, 32)  # (B, S) of the smoke variant: 32 queries, 16 frames
# the std of the attention and MLP biases drawn over the init's zeros, so
# every GEMM launch carries a bias through its epilogue
WHISPER_BIAS_STD = 0.1


def whisper_model(cfg, dev, seed):
    """whisper-tiny's params drawn on the card from ``seed``: the
    reference's init (biases zero), then every bias drawn from N(0,
    ``WHISPER_BIAS_STD``**2) from the same generator."""
    import torch
    from repro_torch.models import transformer as T

    gen = torch.Generator(device=dev).manual_seed(seed)
    params = T.init_params(gen, cfg)
    for layer in params["enc_layers"] + params["layers"]:
        for block in ("attn", "xattn", "mlp"):
            for name, t in layer.get(block, {}).items():
                if name.startswith("b"):
                    t.copy_(torch.randn(t.shape, generator=gen, device=dev)
                            * WHISPER_BIAS_STD)
    return params, gen


def whisper_program(params, cfg, run, dev, level="v4"):
    """``forward_lm`` with frames compiled on ``dev`` (on the CPU: the
    kernels' plain versions under the same table)."""
    import numpy as np
    import torch
    from repro_torch import marvel
    from repro_torch.models import transformer as T

    dt = T.torch_dtype(cfg.param_dtype)
    frames = torch.zeros((1, cfg.n_frames, cfg.d_model), dtype=dt,
                         device=dev)
    return marvel.compile(
        lambda p, t, f: T.forward_lm(p, t, cfg, run, frames=f)[0],
        np.ones((1, 8), np.int32), frames, params=params, level=level,
        backend="cuda", device=dev)


def whisper_phases(dev, card):
    """12a-12f: whisper-tiny at full width and depth in bf16 on the card,
    and its smoke variant's cross-attention through the flash kernel."""
    import numpy as np
    import torch
    from repro_torch import marvel
    from repro_torch.configs import RunConfig, get_arch, smoke_variant
    from repro_torch.kernels import matmul_epilogue as me
    from repro_torch.launch import serve as launcher
    from repro_torch.models import transformer as T
    from repro_torch.runtime.lm_server import static_decode
    from repro_torch.runtime.server import Request, ServeEngine

    t_phase = time.perf_counter()
    n_progs = len(PROGRAMS)
    # 12a) build on the card and compile at v4; the report against the
    # CPU compile's
    cfg = get_arch(WHISPER_ARCH)
    b, nf, s = WHISPER_PREFILL
    run = RunConfig(seq_len=s, global_batch=b, mode="prefill")
    t0 = time.perf_counter()
    params, gen = whisper_model(cfg, dev, 0)
    torch.cuda.synchronize()
    log(f"{WHISPER_ARCH}: {cfg.n_enc_layers} encoder + {cfg.n_layers} "
        f"decoder layers, d_model {cfg.d_model}, {cfg.n_heads} heads of "
        f"{cfg.d_head}, d_ff {cfg.d_ff} ({cfg.act}), vocab {cfg.vocab}, "
        f"{cfg.n_frames} frames: {tree_numel(params) / 1e6:.2f} M parameters "
        f"in {cfg.param_dtype} drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s (biases N(0, "
        f"{WHISPER_BIAS_STD}^2))")
    t0 = time.perf_counter()
    prog = whisper_program(params, cfg, run, dev)
    compile_s = time.perf_counter() - t0
    cpu_prog = whisper_program(tree_to(params, "cpu"), cfg, run, "cpu")
    assert prog.model_class == cpu_prog.model_class == "dense_lm", (
        prog.model_class, cpu_prog.model_class)
    assert report_numbers(prog.report) == report_numbers(cpu_prog.report)
    for pat in ("flash_attention", "residual_rmsnorm", "matmul_epilogue"):
        assert prog.resolved_extensions.get(pat) == "cuda", prog.table
    sites = prog.profile.site_counts
    log(f"compiled {WHISPER_ARCH} v4 in {compile_s:.1f} s (the report "
        f"equals the CPU compile's, number for number): {prog.summary()}")
    rng = np.random.default_rng(12)

    # 12b) one recorded prefill forward, every launch held
    label = f"{WHISPER_ARCH} v4 prefill"
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab, (b, s)).astype(
        np.int32)).to(dev)
    frames = torch.randn((b, nf, cfg.d_model), generator=gen,
                         device=dev).to(torch.bfloat16)
    rec, counts, logits = record_launches(prog, tokens, frames)
    check_counts(label, counts)
    assert counts["matmul_epilogue"] == (
        cfg.n_enc_layers * 6 + cfg.n_layers * 10), counts
    assert sites["matmul_epilogue"] == 16 and sites["flash_attention"] == 3
    assert logits.shape == (b, s, cfg.vocab_padded), logits.shape
    assert torch.isfinite(logits).all(), "non-finite prefill logits"
    got4 = logits.float().cpu()
    del logits
    log(f"{label} B={b} F={nf} S={s}: launches {counts}; the report's "
        f"sites: matmul_epilogue {sites['matmul_epilogue']} (6 a encoder "
        f"layer, 10 a decoder layer with encoder_kv), residual_rmsnorm "
        f"{sites['residual_rmsnorm']}, flash_attention "
        f"{sites['flash_attention']} (encoder, decoder self and cross); "
        f"flash launches: the decoder's causal self-attention alone, the "
        f"encoder's and the cross-attention over {nf} frames take the plain "
        f"path in both packages ({nf} % 128 != 0)")
    prefill = hold(rec, ("flash_attention", "residual_rmsnorm",
                         "matmul_epilogue"), timed=True)
    del rec
    torch.cuda.empty_cache()
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prog(tokens, frames)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    busy = device_busy_ms(lambda: prog(tokens, frames))
    kernel_ms = sum(r["ms"] for r in prefill.values())
    log(f"{label} B={b} F={nf} S={s}: forward {statistics.median(walls):.2f} "
        f"ms wall (median of 3), device busy "
        + ("not measured" if busy is None else f"{busy:.3f} ms")
        + f", of which its kernels' device time {kernel_ms:.3f} ms: "
        + ", ".join(
            f"{k} {r['ms']:.3f} ms (plain {r['plain_ms']:.3f}, bound "
            f"{r['bound_ms']:.4f}"
            + ("" if r["library_ms"] is None
               else f", library {r['library_ms']:.3f}")
            + (f", fma form {r['fma_ms']:.3f}" if "fma_ms" in r else "")
            + ")" for k, r in prefill.items()) + f" on {card}")

    # 12c) the v4 logits against the same model at v0 on the card
    prog0 = whisper_program(params, cfg, run, dev, level="v0")
    with counted() as v0_launches:
        want0 = prog0(tokens, frames).float().cpu()
    assert all(v0_launches[k] == 0 for k in KERNELS), v0_launches
    rel = rel_l2(got4, want0)
    noise = site_noise_response(prog, (tokens, frames), got4, seeds=2)
    limit = WHISPER_V0_TIMES_NOISE * noise
    real = me._launch
    me._launch = lambda x2, w, es, eb, r2, act, form=None: real(
        x2, w, es, torch.zeros_like(eb), r2, act, form)
    try:
        bad = rel_l2(prog(tokens, frames).float().cpu(), want0)
    finally:
        me._launch = real
    log(f"{label}: logits vs the same model at v0 on the card (plain "
        f"versions, no launch) relative L2 {rel:.3e}; response to one-ulp "
        f"noise on every site's input (max of 2) {noise:.3e}, limit "
        f"{WHISPER_V0_TIMES_NOISE:g} times that, {limit:.3e}; planted fault "
        f"'GEMM kernel without its bias' {bad:.3e}")
    assert rel <= limit, (rel, limit)
    assert bad > limit, ("planted no-bias fault passed", bad, limit)
    del prog0, want0, got4
    torch.cuda.empty_cache()

    # 12d) the decode state for LM_SLOTS slots (the encoder and the cross
    # K/V GEMMs run once), then one recorded decode step, under the table
    slot_frames = torch.randn((LM_SLOTS, nf, cfg.d_model), generator=gen,
                              device=dev).to(torch.bfloat16)
    init_state = prog.table.bind(lambda f: T.init_decode_state(
        params, cfg, run, batch=LM_SLOTS, max_len=LM_MAX_LEN, frames=f))
    with torch.inference_mode():
        rec, counts, state = record_launches(init_state, slot_frames)
    check_counts(f"{WHISPER_ARCH} v4 decode state", counts)
    xk = state["cross_kv"]["k"]
    assert xk.shape == (cfg.n_layers, LM_SLOTS, nf, cfg.n_kv_heads,
                        cfg.d_head), xk.shape
    enc = hold(rec, ("residual_rmsnorm", "matmul_epilogue"), timed=False,
               quiet=True)
    del rec
    log(f"{WHISPER_ARCH} v4 decode state, {LM_SLOTS} slots of {nf} frames: "
        f"launches {counts} (the encoder and each layer's cross K/V), every "
        f"one held: max |err| " + ", ".join(
            f"{k} {r['max_abs_err']:.3e}" for k, r in enc.items()))
    decode = prog.table.bind(
        lambda st, tk: T.decode_step(params, st, tk, cfg, run))
    toks = torch.from_numpy(rng.integers(1, cfg.vocab, (LM_SLOTS, 1)).astype(
        np.int32)).to(dev)
    with torch.inference_mode():
        for _ in range(8):
            _, state = decode(state, toks)
        rec, counts, (step_logits, _) = record_launches(decode, state, toks)
        check_counts(f"{WHISPER_ARCH} v4 decode", counts)
        assert torch.isfinite(step_logits).all()
        dec = hold(rec, ("residual_rmsnorm", "matmul_epilogue"), timed=True)
        del rec
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            decode(state, toks)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        busy = device_busy_ms(lambda: decode(state, toks))
    dec_ms = sum(r["ms"] for r in dec.values())
    log(f"{WHISPER_ARCH} v4 decode step, {LM_SLOTS} slots: launches "
        f"{counts}; {statistics.median(walls):.2f} ms wall (median of 5), "
        f"device busy " + ("not measured" if busy is None else
                           f"{busy:.3f} ms")
        + f", of which its kernels' device time {dec_ms:.3f} ms (" + ", ".join(
            f"{k} {r['ms']:.4f}, bound {r['bound_ms']:.5f}, plain "
            f"{r['plain_ms']:.4f}, library "
            + ("null" if r["library_ms"] is None else f"{r['library_ms']:.4f}")
            for k, r in dec.items()) + f") on {card}")
    del state
    torch.cuda.empty_cache()

    # 12e) the legacy wave loop (the plain versions, as the reference's
    # loop runs its baselines): 8 requests, the streams against a static
    # greedy decode with the same frames; the launcher on the card; --lm
    # refused
    wrun = RunConfig(seq_len=128, global_batch=LM_SLOTS, mode="decode",
                     attn_chunk=32)
    engine = ServeEngine(params, cfg, wrun, batch_slots=LM_SLOTS,
                         max_len=128, frames=slot_frames)
    prompts = launcher.lm_prompts(cfg.vocab, WHISPER_REQUESTS)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=LM_MAX_NEW)
            for i, p in enumerate(prompts)]
    with counted() as wave_launches:
        t0 = time.perf_counter()
        for r in reqs:
            engine.submit(r)
        engine.run_until_drained()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    assert all(wave_launches[k] == 0 for k in KERNELS), wave_launches
    assert all(r.done and len(r.generated) == LM_MAX_NEW for r in reqs)
    fresh = T.init_decode_state(params, cfg, wrun, batch=LM_SLOTS,
                                max_len=128, frames=slot_frames)
    static = static_decode(
        lambda st, tk: T.decode_step(params, st, tk, cfg, wrun), fresh,
        prompts, LM_MAX_NEW, cfg.vocab)
    for r in reqs:
        assert r.generated == static[r.uid], r.uid
    m = engine.metrics()
    toks_out = sum(len(r.generated) for r in reqs)
    log(f"{WHISPER_ARCH} wave loop, {LM_SLOTS} slots, each lane against its "
        f"own {nf} frames: {WHISPER_REQUESTS} requests, {toks_out} tokens "
        f"in {dt:.3f} s: {toks_out / dt:.1f} tokens/s, latency p50 "
        f"{m['p50_latency_ms']:.1f} ms p99 {m['p99_latency_ms']:.1f} ms, 0 "
        f"kernel launches (the plain versions); all {len(reqs)} streams "
        f"equal a static greedy decode with the same frames, on {card}")
    del engine, fresh
    t0 = time.perf_counter()
    lm = launcher.main(["--arch", WHISPER_ARCH, "--requests",
                        str(WHISPER_REQUESTS)])
    assert lm["completed"] == WHISPER_REQUESTS, lm
    log(f"python -m repro_torch.launch.serve --arch {WHISPER_ARCH} "
        f"--requests {WHISPER_REQUESTS}: served on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    try:
        launcher.main(["--arch", WHISPER_ARCH, "--lm"])
    except ValueError as e:
        assert "legacy wave loop" in str(e), e
        log(f"--arch {WHISPER_ARCH} --lm refused: {e}")
    else:
        raise AssertionError("--lm served an enc_dec arch")
    torch.cuda.empty_cache()

    # 12f) full depth at B=1, S=64: the card against the CPU; then the
    # smoke variant, whose encoder and cross-attention take the non-causal
    # flash kernel with Sq != Skv
    eb, es = WHISPER_E2E
    e2e_tokens = rng.integers(1, cfg.vocab, (eb, es)).astype(np.int32)
    e2e_frames = slot_frames[:eb]
    t0 = time.perf_counter()
    want = cpu_prog(e2e_tokens, e2e_frames.cpu())
    cpu_s = time.perf_counter() - t0
    tok_dev = torch.from_numpy(e2e_tokens).to(dev)
    got = prog(tok_dev, e2e_frames).cpu()
    assert got.shape == want.shape and torch.isfinite(got).all()
    rel = rel_l2(got, want)
    sites_noise = site_noise_response(prog, (tok_dev, e2e_frames), got)
    limit = E2E_LIMIT[f"{WHISPER_ARCH} v4"]
    log(f"{WHISPER_ARCH} v4 (full depth) B={eb} F={nf} S={es}: logits vs "
        f"the CPU program ({cpu_s:.1f} s there) relative L2 {rel:.3e} "
        f"(limit {limit:g}); response to one-ulp noise on every site's "
        f"input (max of 3) {sites_noise:.3e}")
    assert rel <= limit, rel
    scfg = smoke_variant(cfg)
    sb, ss = WHISPER_SMOKE
    srun = RunConfig(seq_len=ss, global_batch=sb, attn_chunk=16)
    sparams, sgen = whisper_model(scfg, dev, 1)
    stoks = torch.from_numpy(rng.integers(1, scfg.vocab, (sb, ss)).astype(
        np.int32)).to(dev)
    sframes = torch.randn((sb, scfg.n_frames, scfg.d_model), generator=sgen,
                          device=dev).to(torch.bfloat16)
    sprog = whisper_program(sparams, scfg, srun, dev)
    rec, counts, slog = record_launches(sprog, stoks, sframes)
    check_counts(f"{WHISPER_ARCH} smoke v4", counts)
    assert torch.isfinite(slog).all()
    shapes = sorted((tuple(args[0].shape[1:2]), tuple(args[1].shape[1:2]),
                     args[3]) for _, args, _ in rec["flash_attention"].values())
    assert ((ss,), (scfg.n_frames,), False) in shapes, shapes
    smoke = hold(rec, ("flash_attention", "residual_rmsnorm",
                       "matmul_epilogue"), timed=True)
    del rec
    log(f"{WHISPER_ARCH} smoke variant ({scfg.n_enc_layers} + "
        f"{scfg.n_layers} layers, d_model {scfg.d_model}, {scfg.n_frames} "
        f"frames) v4 B={sb} S={ss}: launches {counts}; flash (Sq, Skv, "
        f"causal) per shape {shapes}: the encoder's {scfg.n_frames} frames "
        f"and the cross-attention's {ss} queries over them non-causal, every "
        f"launch held: max |err| " + ", ".join(
            f"{k} {r['max_abs_err']:.3e}" for k, r in smoke.items()))
    log(f"{WHISPER_ARCH} phases: {time.perf_counter() - t_phase:.1f} s")
    del params, prog, cpu_prog, sparams, sprog
    retire(n_progs)
    free_card()
    return prefill, dec, smoke


# ---------------------------------------------------------------------------
# the vlm path: internvl2-26b at full width and depth; granite-34b's one KV
# head at a cut depth
# ---------------------------------------------------------------------------

VLM_ARCH = "internvl2-26b"
# (B, patches, text) of the recorded prefill: the config's 256 patch
# embeddings ahead of 256 tokens, S = 512 (four 128-key tiles)
VLM_PREFILL = (4, 256, 256)
VLM_REQUESTS = 8
# the launcher's run on the card: new tokens a request
VLM_LAUNCHER_NEW = 4
# the v4 logits against the same model at v0 on the card: at most this many
# times the v4 program's response to one-ulp noise on every site's input
VLM_V0_TIMES_NOISE = 3.0
# (B, patches, text) of the card-vs-CPU check, depth cut to 2 layers; the
# patches cut from 256 to 64 to keep the CPU's forward short
VLM_E2E = (1, 64, 64)
MQA_PREFILL = (4, 512)  # (B, S) of granite-34b's recorded prefill
MQA_REQUESTS = 8
MQA_V0_TIMES_NOISE = 3.0


def log_peak(label: str, t_phase: float) -> None:
    """The device's peak allocation since the last call, then reset; the
    seconds since ``t_phase``."""
    import torch

    log(f"{label}: peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, "
        f"{time.perf_counter() - t_phase:.1f} s into the phase")
    torch.cuda.reset_peak_memory_stats()


def vlm_program(params, cfg, run, dev, level="v4"):
    """``forward_lm`` with patches compiled on ``dev``, the tokens and the
    patches as example args (on the CPU: the kernels' plain versions under
    the same table)."""
    import numpy as np
    import torch
    from repro_torch import marvel
    from repro_torch.models import transformer as T

    patches = torch.zeros((1, 8, cfg.d_model),
                          dtype=T.torch_dtype(cfg.param_dtype), device=dev)
    return marvel.compile(
        lambda p, t, x: T.forward_lm(p, t, cfg, run, patches=x)[0],
        np.ones((1, 8), np.int32), patches, params=params, level=level,
        backend="cuda", device=dev)


def timed_forward(label, fn, results, card, reps=3):
    """The forward's wall time (median of ``reps``) and device busy time
    against the sum of its kernels' device time, logged."""
    import torch

    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    busy = device_busy_ms(fn)
    kernel_ms = sum(r["ms"] for r in results.values())
    log(f"{label}: {statistics.median(walls):.2f} ms wall (median of {reps}),"
        f" device busy " + ("not measured" if busy is None else
                            f"{busy:.3f} ms")
        + f", of which its kernels' device time {kernel_ms:.3f} ms: "
        + ", ".join(
            f"{k} {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, bound "
            f"{r['bound_ms']:.4f}, library "
            + ("null" if r["library_ms"] is None else f"{r['library_ms']:.4f}")
            + (f", fma form {r['fma_ms']:.3f}" if "fma_ms" in r else "")
            + ")" for k, r in results.items()) + f" on {card}")


def v0_check(label, prog, prog0, inputs, got4, times_noise):
    """13c / 14c: the v4 logits against the same model at v0 on the card
    (the plain versions, no launch), within ``times_noise`` times the v4
    program's response to one-ulp noise on every site's input; a GEMM
    kernel that drops its residual (planted) must exceed that limit."""
    import torch
    from repro_torch.kernels import matmul_epilogue as me

    with counted() as v0_launches:
        want0 = prog0(*inputs).float().cpu()
    assert all(v0_launches[k] == 0 for k in KERNELS), v0_launches
    rel = rel_l2(got4, want0)
    noise = site_noise_response(prog, inputs, got4, seeds=2)
    limit = times_noise * noise
    real = me._launch
    me._launch = lambda x2, w, es, eb, r2, act, form=None: real(
        x2, w, es, eb, None, act, form)
    try:
        bad = rel_l2(prog(*inputs).float().cpu(), want0)
    finally:
        me._launch = real
    log(f"{label}: logits vs the same model at v0 on the card (plain "
        f"versions, no launch) relative L2 {rel:.3e}; response to one-ulp "
        f"noise on every site's input (max of 2) {noise:.3e}, limit "
        f"{times_noise:g} times that, {limit:.3e}; planted fault 'GEMM "
        f"kernel without its residual' {bad:.3e}")
    assert rel <= limit, (rel, limit)
    assert bad > limit, ("planted no-residual fault passed", bad, limit)
    del want0
    torch.cuda.empty_cache()


def decode_step_phase(label, decode, state, toks, card):
    """One recorded decode step after 8 steps of history, every launch
    held and timed; its wall and device busy time against its kernels'."""
    import torch

    with torch.inference_mode():
        for _ in range(8):
            _, state = decode(state, toks)
        rec, counts, (step_logits, _) = record_launches(decode, state, toks)
        check_counts(label, counts)
        assert torch.isfinite(step_logits).all()
        dec = hold(rec, ("residual_rmsnorm", "matmul_epilogue"), timed=True)
        del rec
        timed_forward(f"{label} step, {LM_SLOTS} slots, launches {counts}",
                      lambda: decode(state, toks), dec, card, reps=5)
    return dec


def vlm_phases(dev, card):
    """13a-13f: internvl2-26b at full width and depth in bf16 on the card,
    its patch prefix through the ``mac_matmul`` site."""
    import numpy as np
    import torch
    from repro_torch.configs import RunConfig, get_arch
    from repro_torch.launch import serve as launcher
    from repro_torch.models import transformer as T
    from repro_torch.runtime.lm_server import static_decode
    from repro_torch.runtime.server import Request, ServeEngine

    t_phase = time.perf_counter()
    n_progs = len(PROGRAMS)
    torch.cuda.reset_peak_memory_stats()
    log(f"{VLM_ARCH}: {torch.cuda.memory_allocated() / 1e9:.2f} GB held on "
        f"the card before the phase")
    # 13a) build on the card and compile at v4, tokens and patches as
    # example args
    cfg = get_arch(VLM_ARCH)
    b, npatch, s = VLM_PREFILL
    run = RunConfig(seq_len=npatch + s, global_batch=b, mode="prefill")
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = T.init_params(gen, cfg)
    torch.cuda.synchronize()
    log(f"{VLM_ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads of {cfg.d_head} over {cfg.n_kv_heads} KV heads, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab} (padded {cfg.vocab_padded}), "
        f"{cfg.n_patches} patches: {tree_numel(params) / 1e9:.3f} B "
        f"parameters in {cfg.param_dtype} drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    t0 = time.perf_counter()
    prog = vlm_program(params, cfg, run, dev)
    assert prog.model_class == "dense_lm", prog.model_class
    for pat in ("flash_attention", "residual_rmsnorm", "matmul_epilogue"):
        assert prog.resolved_extensions.get(pat) == "cuda", prog.table
    assert "mac_matmul" not in prog.table, prog.table
    sites = prog.profile.site_counts
    want_sites = {"mac_matmul": 2, "matmul_epilogue": 6,
                  "flash_attention": 1, "residual_rmsnorm": 1}
    assert all(sites[k] == v for k, v in want_sites.items()), sites
    log(f"compiled {VLM_ARCH} v4 in {time.perf_counter() - t0:.1f} s: "
        f"{prog.summary()}")
    log_peak(f"{VLM_ARCH} drawn and compiled (13a)", t_phase)
    rng = np.random.default_rng(13)

    # 13b) one recorded prefill forward, every launch held
    label = f"{VLM_ARCH} v4 prefill"
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab, (b, s)).astype(
        np.int32)).to(dev)
    patches = torch.randn((b, npatch, cfg.d_model), generator=gen,
                          device=dev).to(torch.bfloat16)
    rec, counts, logits = record_launches(prog, tokens, patches)
    check_counts(label, counts)
    for k in ("matmul_epilogue", "residual_rmsnorm", "flash_attention"):
        assert counts[k] == sites[k] * cfg.n_layers, (k, counts[k], sites)
    flash = {(tuple(a[0].shape), tuple(a[1].shape), a[3])
             for _, a, _ in rec["flash_attention"].values()}
    assert flash == {((b, npatch + s, cfg.n_kv_heads,
                       cfg.n_heads // cfg.n_kv_heads, cfg.d_head),
                      (b, npatch + s, cfg.n_kv_heads, cfg.d_head), True)}, (
        flash)
    assert logits.shape == (b, s, cfg.vocab_padded), logits.shape
    assert torch.isfinite(logits).all(), "non-finite prefill logits"
    got4 = logits.float().cpu()
    del logits
    log(f"{label} B={b}, {npatch} patches + {s} tokens (S={npatch + s}): "
        f"launches {counts}; the report's sites a layer x {cfg.n_layers} "
        f"layers: matmul_epilogue {sites['matmul_epilogue']}, "
        f"residual_rmsnorm {sites['residual_rmsnorm']}, flash_attention "
        f"{sites['flash_attention']} (causal over the prefix and the text, "
        f"q {flash}); mac_matmul {sites['mac_matmul']} sites (the patch "
        f"projection and the MLP's up projection) launch nothing: no kernel "
        f"in either package; the logits cover the {s} text positions")
    prefill = hold(rec, ("flash_attention", "residual_rmsnorm",
                         "matmul_epilogue"), timed=True)
    del rec
    torch.cuda.empty_cache()
    log_peak(f"{label} (13a-13b)", t_phase)
    timed_forward(f"{label} B={b} S={npatch + s}: forward",
                  lambda: prog(tokens, patches), prefill, card)

    # 13c) the v4 logits against the same model at v0 on the card; the two
    # programs share the params
    prog0 = vlm_program(params, cfg, run, dev, level="v0")
    v0_check(label, prog, prog0, (tokens, patches), got4, VLM_V0_TIMES_NOISE)
    del prog0, got4
    log_peak(f"{label} (13c)", t_phase)

    # 13d) the decode state for LM_SLOTS slots, then one recorded decode
    # step (dense, from tokens alone, as the reference's)
    decode = prog.table.bind(
        lambda st, tk: T.decode_step(params, st, tk, cfg, run))
    state = T.init_decode_state(params, cfg, run, batch=LM_SLOTS,
                                max_len=LM_MAX_LEN)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab, (LM_SLOTS, 1)).astype(
        np.int32)).to(dev)
    dec = decode_step_phase(f"{VLM_ARCH} v4 decode", decode, state, toks,
                            card)
    del state
    torch.cuda.empty_cache()
    log_peak(f"{VLM_ARCH} v4 decode (13d)", t_phase)

    # 13e) the legacy wave loop (the plain versions, from tokens alone as
    # the reference's loop serves a vlm arch): 8 requests, the streams
    # against a static greedy decode
    wrun = RunConfig(seq_len=128, global_batch=LM_SLOTS, mode="decode",
                     attn_chunk=32)
    engine = ServeEngine(params, cfg, wrun, batch_slots=LM_SLOTS,
                         max_len=128)
    prompts = launcher.lm_prompts(cfg.vocab, VLM_REQUESTS)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=LM_MAX_NEW)
            for i, p in enumerate(prompts)]
    with counted() as wave_launches:
        t0 = time.perf_counter()
        for r in reqs:
            engine.submit(r)
        engine.run_until_drained()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    assert all(wave_launches[k] == 0 for k in KERNELS), wave_launches
    assert all(r.done and len(r.generated) == LM_MAX_NEW for r in reqs)
    fresh = T.init_decode_state(params, cfg, wrun, batch=LM_SLOTS,
                                max_len=128)
    static = static_decode(
        lambda st, tk: T.decode_step(params, st, tk, cfg, wrun), fresh,
        prompts, LM_MAX_NEW, cfg.vocab)
    for r in reqs:
        assert r.generated == static[r.uid], r.uid
    m = engine.metrics()
    toks_out = sum(len(r.generated) for r in reqs)
    log(f"{VLM_ARCH} wave loop, {LM_SLOTS} slots, from tokens alone: "
        f"{VLM_REQUESTS} requests, {toks_out} tokens in {dt:.3f} s: "
        f"{toks_out / dt:.1f} tokens/s, latency p50 "
        f"{m['p50_latency_ms']:.1f} ms p99 {m['p99_latency_ms']:.1f} ms, 0 "
        f"kernel launches (the plain versions); all {len(reqs)} streams "
        f"equal a static greedy decode, on {card}")
    del engine, fresh
    torch.cuda.empty_cache()
    log_peak(f"{VLM_ARCH} wave loop (13e)", t_phase)

    # 13f) full width, depth cut to 2 layers: the card against the CPU,
    # with patches
    cut = cfg.replace(n_layers=2)
    params2 = {"embed": params["embed"], "ln_f": params["ln_f"],
               "frontend_proj": params["frontend_proj"],
               "layers": params["layers"][:2]}
    eb, ep, es = VLM_E2E
    e2e_tokens = torch.from_numpy(rng.integers(1, cfg.vocab, (eb, es)).astype(
        np.int32)).to(dev)
    e2e_patches = patches[:eb, :ep].contiguous()
    prog2 = vlm_program(params2, cut, run, dev)
    cpu_prog = vlm_program(tree_to(params2, "cpu"), cut, run, "cpu")
    t0 = time.perf_counter()
    want = cpu_prog(e2e_tokens.cpu(), e2e_patches.cpu())
    cpu_s = time.perf_counter() - t0
    got, rel, noise, bad = lm_noise_and_faults(
        prog2, (e2e_tokens, e2e_patches), want, None)
    assert got.shape == want.shape == (eb, es, cfg.vocab_padded)
    assert torch.isfinite(got).all()
    limit = E2E_LIMIT[f"{VLM_ARCH} 2-layer v4"]
    log(f"{VLM_ARCH} 2-layer (depth cut from {cfg.n_layers}: a 48-layer f32 "
        f"CPU forward does not fit the host) v4 B={eb}, {ep} patches + {es} "
        f"tokens: logits vs the CPU program ({cpu_s:.1f} s there) relative "
        f"L2 {rel:.3e} (limit {limit:g}); response to one-ulp noise on every "
        f"site's input (max of 3) {noise:.3e}; planted fault 'flash kernel "
        f"without its causal mask' {bad:.3e}")
    assert bad > limit, ("planted no-causal-mask fault passed", bad, limit)
    assert rel <= limit, rel
    del prog2, cpu_prog, params2, params, prog, patches, decode
    retire(n_progs)
    free_card()
    log_peak(f"{VLM_ARCH} 2-layer cut vs the CPU (13f)", t_phase)

    # 13e, the launcher: draws its own full-width model once this phase's
    # is freed; --lm refused with the reason
    t0 = time.perf_counter()
    lm = launcher.main(["--arch", VLM_ARCH, "--requests", str(VLM_REQUESTS),
                        "--max-new", str(VLM_LAUNCHER_NEW)])
    assert lm["completed"] == VLM_REQUESTS, lm
    log(f"python -m repro_torch.launch.serve --arch {VLM_ARCH} --requests "
        f"{VLM_REQUESTS} --max-new {VLM_LAUNCHER_NEW}: served on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    try:
        launcher.main(["--arch", VLM_ARCH, "--lm"])
    except ValueError as e:
        assert "legacy wave loop" in str(e), e
        log(f"--arch {VLM_ARCH} --lm refused: {e}")
    else:
        raise AssertionError("--lm served a vlm arch")
    free_card()
    log_peak(f"{VLM_ARCH} launcher (13e)", t_phase)
    log(f"{VLM_ARCH} phases: {time.perf_counter() - t_phase:.1f} s")
    return prefill, dec


def mqa_phases(dev, card):
    """14a-14d: granite-34b at full width (one KV head under 48 query
    heads) and its depth cut to ``MQA_LAYERS`` in bf16 on the card."""
    import numpy as np
    import torch
    from repro_torch import marvel
    from repro_torch.configs import RunConfig, get_arch
    from repro_torch.launch.serve import lm_prompts
    from repro_torch.models import transformer as T

    t_phase = time.perf_counter()
    n_progs = len(PROGRAMS)
    torch.cuda.reset_peak_memory_stats()
    # 14a) build on the card at the cut depth and compile at v4
    full = get_arch(MQA_ARCH)
    cfg = full.replace(n_layers=MQA_LAYERS)
    b, s = MQA_PREFILL
    run = RunConfig(seq_len=s, global_batch=b, mode="prefill")
    log(f"{MQA_ARCH}: {torch.cuda.memory_allocated() / 1e9:.2f} GB held on "
        f"the card before the phase")
    t0 = time.perf_counter()
    params = T.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    torch.cuda.synchronize()
    n_params = tree_numel(params)
    per_layer = tree_numel(params["layers"][0])
    full_n = n_params + (full.n_layers - MQA_LAYERS) * per_layer
    log(f"{MQA_ARCH}: d_model {cfg.d_model}, {cfg.n_heads} heads of "
        f"{cfg.d_head} over {cfg.n_kv_heads} KV head, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}; depth cut from {full.n_layers} to {MQA_LAYERS} layers "
        f"(all {full.n_layers} come to {full_n / 1e9:.2f} B parameters, "
        f"{2 * full_n / 1e9:.1f} GB in bf16, over the card's 80 GB): "
        f"{n_params / 1e9:.3f} B parameters drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    t0 = time.perf_counter()
    prog = lm_program(params, cfg, run, np.ones((1, 8), np.int32), dev)
    assert prog.model_class == "dense_lm", prog.model_class
    for pat in ("flash_attention", "residual_rmsnorm", "matmul_epilogue"):
        assert prog.resolved_extensions.get(pat) == "cuda", prog.table
    sites = prog.profile.site_counts
    log(f"compiled {MQA_ARCH} ({MQA_LAYERS} layers) v4 in "
        f"{time.perf_counter() - t0:.1f} s: {prog.summary()}")
    log_peak(f"{MQA_ARCH} drawn and compiled (14a)", t_phase)
    rng = np.random.default_rng(14)

    # 14b) one recorded prefill forward, every launch held
    label = f"{MQA_ARCH} v4 prefill"
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab, (b, s)).astype(
        np.int32)).to(dev)
    rec, counts, logits = record_launches(prog, tokens)
    check_counts(label, counts)
    for k in ("matmul_epilogue", "residual_rmsnorm", "flash_attention"):
        assert counts[k] == sites[k] * cfg.n_layers, (k, counts[k], sites)
    flash = {(tuple(a[0].shape), tuple(a[1].shape))
             for _, a, _ in rec["flash_attention"].values()}
    assert flash == {((b, s, 1, cfg.n_heads, cfg.d_head),
                      (b, s, 1, cfg.d_head))}, flash
    gemms = {(a[0].shape[1], a[1].shape[1])
             for _, a, _ in rec["matmul_epilogue"].values()}
    assert (cfg.d_model, cfg.d_head) in gemms, gemms  # wk, wv: N = 128
    assert (cfg.d_ff, cfg.d_model) in gemms, gemms  # the down projection
    assert logits.shape == (b, s, cfg.vocab_padded), logits.shape
    assert torch.isfinite(logits).all(), "non-finite prefill logits"
    got4 = logits.float().cpu()
    del logits
    log(f"{label} ({MQA_LAYERS} layers) B={b} S={s}: launches {counts}; "
        f"flash with {cfg.n_heads} query heads over one KV head, GEMMs (K, N) "
        f"{sorted(gemms)}")
    prefill = hold(rec, ("flash_attention", "residual_rmsnorm",
                         "matmul_epilogue"), timed=True)
    del rec
    torch.cuda.empty_cache()
    log_peak(f"{label} (14a-14b)", t_phase)
    timed_forward(f"{label} ({MQA_LAYERS} layers) B={b} S={s}: forward",
                  lambda: prog(tokens), prefill, card)

    # 14c) the v4 logits against the same model at v0 on the card
    prog0 = marvel.compile(
        lambda p, t: T.forward_lm(p, t, cfg, run)[0],
        np.ones((1, 8), np.int32), params=params, level="v0", device=dev)
    v0_check(label, prog, prog0, (tokens,), got4, MQA_V0_TIMES_NOISE)
    del prog0, got4
    log_peak(f"{label} (14c)", t_phase)

    # 14d) serve through the continuous-batching tier, int8 KV (the scale
    # planes over one head); then one recorded decode step
    engine = prog.serve(mode="lm", cfg=cfg, run=run, kv_quant="int8",
                        slots=LM_SLOTS, max_len=LM_MAX_LEN)
    prompts = lm_prompts(cfg.vocab, MQA_REQUESTS)
    mgr = engine.engine.manager
    placed: list[tuple[int, int, int]] = []  # (uid, bucket, slot)
    alloc = mgr.alloc

    def placing(uid, total_len):
        got = alloc(uid, total_len)
        if got is not None:
            placed.append((uid, *got))
        return got

    mgr.alloc = placing

    async def serve():
        async with engine:
            engine.warmup()
            misses = engine.engine.compile_misses
            steps = engine.engine.decode_steps
            with counted() as launches:
                t0 = time.perf_counter()
                done = await engine.submit_wave(prompts,
                                                max_new_tokens=LM_MAX_NEW)
                dt = time.perf_counter() - t0
            return (done, dt, launches, engine.engine.decode_steps - steps,
                    engine.engine.compile_misses - misses, engine.metrics())

    done, dt, launches, steps, new_misses, m = asyncio.run(serve())
    assert len(done) == MQA_REQUESTS and all(
        r.done and r.error is None and len(r.generated) == LM_MAX_NEW
        for r in done), "granite-34b requests failed"
    assert m["errors"] == 0 and new_misses == 0, (m, new_misses)
    check_counts(f"{MQA_ARCH} v4 decode", launches, steps)
    scale = next(iter(mgr.pools.values())).state["cache"]["k_scale"]
    assert scale.shape[-1] == 1, scale.shape
    toks_out = sum(len(r.generated) for r in done)
    log(f"{MQA_ARCH} ({MQA_LAYERS} layers) v4 serve, int8 KV (scale planes "
        f"{tuple(scale.shape)}: one head), {LM_SLOTS} slots, buckets "
        f"{mgr.bucket_lens}: {MQA_REQUESTS} requests, {toks_out} tokens in "
        f"{dt:.3f} s: {toks_out / dt:.1f} tokens/s, TTFT p50 "
        f"{m['ttft_p50_ms']:.1f} ms p99 {m['ttft_p99_ms']:.1f} ms, "
        f"inter-token p50 {m['intertoken_p50_ms']:.2f} ms p99 "
        f"{m['intertoken_p99_ms']:.2f} ms, {steps} decode steps, 0 compile "
        f"misses after warmup, on {card}")
    checked = serve_streams_check(engine.engine, params, cfg, run, prompts,
                                  placed, done, kv_quant="int8")
    assert checked == MQA_REQUESTS, checked
    log(f"{MQA_ARCH} v4 serve: all {checked} request streams equal a static "
        f"decode of the same prompts from a fresh state in the same lanes")
    del engine
    torch.cuda.empty_cache()
    decode = prog.table.bind(
        lambda st, tk: T.decode_step(params, st, tk, cfg, run))
    state = T.init_decode_state(params, cfg, run, batch=LM_SLOTS,
                                max_len=LM_MAX_LEN, kv_quant="int8")
    toks = torch.from_numpy(rng.integers(1, cfg.vocab, (LM_SLOTS, 1)).astype(
        np.int32)).to(dev)
    dec = decode_step_phase(f"{MQA_ARCH} v4 decode", decode, state, toks,
                            card)
    del state, decode, params, prog
    retire(n_progs)
    free_card()
    log_peak(f"{MQA_ARCH} serve and decode step (14d)", t_phase)
    log(f"{MQA_ARCH} phases: {time.perf_counter() - t_phase:.1f} s")
    return prefill, dec


# ---------------------------------------------------------------------------
# supervised serving: in-process and process-isolated workers
# ---------------------------------------------------------------------------

SUP_WORKERS = 2
RATE_WAVES = 3  # fault-free waves timed per fleet
SUP_WAVE, SUP_KILL_WAVE, SUP_SECOND_WAVE = 32, 48, 16
HEAL_S = 300.0  # bound on the wait for a fleet to heal (a qwen3-8b child
# draws 15.1 GB and compiles before its HELLO)


class BatchRecorder:
    """A CNN program seen at the engines' boundary: while ``recording``,
    each batch it runs records its launches (every counter from 0 just
    before, read just after; ``record_launches``) and keeps its input, the
    counts, the recorded launches and the logits.  Calls serialize on a
    lock: the recorder patches the kernel modules while it records."""

    def __init__(self, prog):
        import threading

        self.prog = prog
        self.recording = False
        self.batches: list = []
        self._lock = threading.Lock()

    def __getattr__(self, name):
        return getattr(self.prog, name)

    def serve(self, mode="async", **kw):
        from repro_torch.runtime.cnn_server import AsyncCnnEngine

        assert mode == "async", mode
        return AsyncCnnEngine(self, **kw)

    def __call__(self, x):
        if not self.recording:
            return self.prog(x)
        import torch

        with self._lock:
            rec, counts, out = record_launches(self.prog, x)
            self.batches.append((torch.as_tensor(x).clone(), counts, rec,
                                 out.clone()))
        return out


async def healed(sup, n, restarts=1, timeout_s=HEAL_S):
    """True once the supervisor has made ``restarts`` restarts and ``n``
    workers are healthy again (False after ``timeout_s``)."""
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout_s
    while (sup.metrics()["aggregate"]["restarts"] < restarts
           or len(sup.healthy_workers()) != n):
        if loop.time() >= deadline:
            return False
        await asyncio.sleep(0.05)
    return True


async def kill_when_busy(engine, kill, settle_s=0.0, timeout_s=60.0):
    """Kill a worker once it owns requests in flight (``settle_s`` later):
    the kill lands mid-wave.  Returns the owned count at the kill."""
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout_s
    while engine.outstanding == 0:
        assert loop.time() < deadline, "the worker never took a request"
        await asyncio.sleep(0.001)
    if settle_s:
        await asyncio.sleep(settle_s)
    owned = engine.outstanding
    kill()
    return owned


def fmt_rates(rates) -> str:
    return " / ".join(f"{r:.1f}" for r in rates)


def exactly_once(results, n):
    assert len(results) == n, len(results)
    assert all(r.error is None for r in results), "a request failed"
    assert len({r.uid for r in results}) == n, "a request resolved twice"


def softmax(z):
    import torch

    return torch.softmax(z.float(), dim=-1)


def sup_inproc_phase(prog, apply, in_shape, params_cpu, card):
    """10a: a Supervisor over 2 in-process ResNet50 v4 workers of one
    program.  A recorded 32-request wave: each batch's launches counted
    (PER_FORWARD) and held, its logits and the probabilities delivered to
    its requests held against the CPU program on the same batch.  A
    concurrent wave with the counts from 0: the totals come to batches x
    per-forward (the counters are bumped from both compute threads), 0
    restarts.  A wave with worker 0 killed mid-wave: every request resolved
    exactly once, failover, the fleet healed, the replacement's warmup
    replay adds no bucket.  Returns the labels of the first wave."""
    import numpy as np
    import torch
    from repro_torch import marvel
    from repro_torch.launch.serve import random_images
    from repro_torch.runtime.supervisor import Supervisor

    label = "resnet50 v4"
    images = random_images(in_shape, SUP_WAVE)
    recorder = BatchRecorder(prog)
    # recording serializes the workers and clones every launch's inputs, so
    # a heartbeat may wait behind several slowed batches: this fleet's
    # beats are floored at 1 s; the serving fleet below keeps the defaults
    rec_sup = Supervisor(heartbeat_floor_ms=1000.0)
    rec_sup.register("cnn", recorder, workers=SUP_WORKERS, warmup=in_shape,
                     max_batch=BATCH)
    sup = Supervisor()
    sup.register("cnn", prog, workers=SUP_WORKERS, warmup=in_shape,
                 max_batch=BATCH)
    cpu_prog = marvel.compile(apply, np.zeros((1, *in_shape), np.float32),
                              params=params_cpu, level="v4", backend="cuda",
                              device="cpu")

    async def waves():
        async with rec_sup:  # the workers warm up unrecorded
            recorder.recording = True
            first = await rec_sup.submit_wave(images)
            recorder.recording = False
            assert len(recorder.batches) == rec_sup.metrics()[
                "aggregate"]["batches"], "a batch went unrecorded"
        engine = prog.serve(mode="async", max_batch=BATCH)
        async with engine:  # the same program, one engine, unsupervised
            engine.warmup(in_shape)
            single = []
            for _ in range(RATE_WAVES):
                t0 = time.perf_counter()
                await engine.submit_wave(images)
                single.append(SUP_WAVE / (time.perf_counter() - t0))
        one = Supervisor()  # one supervised worker: routing, no second thread
        one.register("cnn", prog, workers=1, warmup=in_shape,
                     max_batch=BATCH)
        async with one:
            one_rates = []
            for _ in range(RATE_WAVES):
                t0 = time.perf_counter()
                exactly_once(await one.submit_wave(images), SUP_WAVE)
                one_rates.append(SUP_WAVE / (time.perf_counter() - t0))
        async with sup:
            with counted() as launches:
                t0 = time.perf_counter()
                second = await sup.submit_wave(images)
                dt = time.perf_counter() - t0
            agg1 = sup.metrics()["aggregate"]
            rates = [SUP_WAVE / dt]
            for _ in range(RATE_WAVES - 1):
                t0 = time.perf_counter()
                exactly_once(await sup.submit_wave(images), SUP_WAVE)
                rates.append(SUP_WAVE / (time.perf_counter() - t0))
            misses = prog.cache_misses
            w0 = sup.workers["cnn/0"]
            killer = asyncio.ensure_future(kill_when_busy(
                w0.engine, lambda: w0.engine.kill("killed mid-wave")))
            third = await sup.submit_wave(images)
            owned = await killer
            ok = await healed(sup, SUP_WORKERS)
            fourth = await sup.submit_wave(images[:SUP_SECOND_WAVE])
            return (first, second, dt, launches, agg1, rates, single,
                    one_rates, misses, owned, ok, third, fourth,
                    sup.metrics()["aggregate"], sup.prometheus())

    (first, second, dt, launches, agg1, rates, single, one_rates, misses,
     owned, ok, third, fourth, agg, prom) = asyncio.run(waves())

    # the recorded wave: every batch counted, held, and its answers
    exactly_once(first, SUP_WAVE)
    by_row = {images[r.uid].tobytes(): r for r in first}
    limit = E2E_LIMIT[label]
    worst_logits = worst_probs = 0.0
    worst_err = {}
    for x, counts, rec, logits in recorder.batches:
        check_counts(label, counts)
        for k, held_k in hold(rec, PER_FORWARD[label], timed=False,
                              quiet=True).items():
            worst_err[k] = max(worst_err.get(k, 0.0), held_k["max_abs_err"])
        want = cpu_prog(x.cpu())
        worst_logits = max(worst_logits, rel_l2(logits.cpu(), want))
        rows = [(i, by_row[x[i].cpu().numpy().tobytes()])
                for i in range(x.shape[0])
                if x[i].cpu().numpy().tobytes() in by_row]
        got = torch.from_numpy(np.stack([r.probs for _, r in rows]))
        ref_probs = softmax(want)[[i for i, _ in rows]]
        worst_probs = max(worst_probs, rel_l2(got, ref_probs))
        assert torch.allclose(got, softmax(logits.cpu())[[i for i, _ in rows]],
                              rtol=1e-5, atol=1e-6), "probs not delivered"
    n_rec = len(recorder.batches)
    assert n_rec >= SUP_WAVE // BATCH, n_rec
    assert worst_logits <= limit and worst_probs <= limit, (
        worst_logits, worst_probs)
    log(f"10a {label}, {SUP_WORKERS} in-process workers: recorded wave of "
        f"{SUP_WAVE} in {n_rec} batches, each with {PER_FORWARD[label]} "
        f"launches, every launch held against its plain version (worst "
        f"|err| {worst_err}); logits vs "
        f"the CPU program on the same batch: worst relative L2 "
        f"{worst_logits:.3e}, delivered probabilities {worst_probs:.3e} "
        f"(limit {limit:g})")

    # the concurrent wave: the counters' totals from both compute threads
    exactly_once(second, SUP_WAVE)
    n_batches = agg1["batches"]
    check_counts(label, launches, n_batches)
    assert agg1["restarts"] == 0 and agg1["errors"] == 0, agg1
    log(f"10a {label}: concurrent wave of {SUP_WAVE} in {n_batches} batches "
        f"across {SUP_WORKERS} workers in {dt * 1e3:.1f} ms: "
        f"{SUP_WAVE / dt:.1f} req/s, p50 {agg1['p50_latency_ms']:.2f} ms, "
        f"p99 {agg1['p99_latency_ms']:.2f} ms (worst worker), 0 restarts; "
        f"launch totals = {n_batches} batches x per-forward: "
        f"{ {k: launches[k] for k in PER_FORWARD[label]} } on {card}")
    log(f"10a {label}: {RATE_WAVES} fault-free waves of {SUP_WAVE}: "
        f"{fmt_rates(rates)} req/s supervised ({SUP_WORKERS} in-process "
        f"workers); the same program in the same run through one "
        f"supervised worker {fmt_rates(one_rates)}, through one engine "
        f"unsupervised {fmt_rates(single)} req/s")

    # the kill wave
    exactly_once(third, SUP_WAVE)
    exactly_once(fourth, SUP_SECOND_WAVE)
    assert ok, "the in-process fleet never healed"
    assert agg["failovers"] >= 1 and agg["restarts"] >= 1, agg
    assert prog.cache_misses == misses, "the replacement added a bucket"
    log(f"10a {label}: worker 0 killed with {owned} requests in flight: "
        f"{SUP_WAVE} resolved exactly once, {agg['failovers']} failovers, "
        f"{agg['restarts']} restart, fleet healed to "
        f"{agg['healthy_workers']}; the replacement served "
        f"{SUP_SECOND_WAVE} more with 0 new buckets")
    log("10a prometheus():\n" + prom.rstrip())
    return [r.label for r in first]


def child_line(engine) -> str:
    h = engine.hello
    peak = engine.metrics().get("device_memory_peak_bytes")
    load = h.get("kernel_load_s")
    return (f"pid {engine.pid} on {h.get('devices')}: kernel library loaded "
            f"in {'n/a' if load is None else f'{load:.3f} s'}, program "
            f"{h.get('program_s', 0):.1f} s, warmup {h.get('warmup_s', 0):.1f}"
            f" s, spawn to HELLO {engine.spawn_to_hello_s:.1f} s, peak "
            f"allocated {'n/a' if peak is None else f'{peak / 1e9:.2f} GB'}")


async def refresh(sup):
    """One PING to every live worker: their metrics as of now."""
    for wh in sup.workers.values():
        if wh.engine.is_alive:
            r = wh.engine.ping()
            if asyncio.iscoroutine(r):
                await r


def sup_process_cnn_phase(in_shape, fleet_labels, card):
    """10b: two process-isolated ResNet50 v4 workers sharing the card; a
    48-request wave with worker 0's pid SIGKILLed once it owns requests in
    flight; a second 16-request wave through the replacement."""
    import signal

    from repro_torch.launch.serve import random_images
    from repro_torch.runtime.actor import cnn_program_factory
    from repro_torch.runtime.supervisor import Supervisor

    model = "resnet50"
    images = random_images(in_shape, SUP_KILL_WAVE)
    sup = Supervisor()
    sup.register(model, None, workers=SUP_WORKERS, warmup=in_shape,
                 max_batch=BATCH, isolation="process",
                 program_factory=cnn_program_factory,
                 factory_kwargs=dict(model=model))

    async def waves():
        t0 = time.perf_counter()
        async with sup:
            up = time.perf_counter() - t0
            await refresh(sup)
            lines = [child_line(wh.engine) for wh in sup.workers.values()]
            rates = []
            for _ in range(RATE_WAVES):
                t1 = time.perf_counter()
                clean = await sup.submit_wave(images[:SUP_WAVE])
                rates.append(SUP_WAVE / (time.perf_counter() - t1))
                exactly_once(clean, SUP_WAVE)
            await refresh(sup)
            agg0 = sup.metrics()["aggregate"]
            w0 = sup.workers[f"{model}/0"]
            old = w0.engine
            killer = asyncio.ensure_future(kill_when_busy(
                old, lambda: os.kill(old.pid, signal.SIGKILL)))
            t1 = time.perf_counter()
            first = await sup.submit_wave(images)
            dt = time.perf_counter() - t1
            owned = await killer
            ok = await healed(sup, SUP_WORKERS)
            second = await sup.submit_wave(images[:SUP_SECOND_WAVE])
            await refresh(sup)
            new = sup.workers[f"{model}/0"].engine
            lines.append(child_line(new))
            return (up, lines, clean, rates, agg0, old, new, first, dt,
                    owned, ok, second, new.metrics(),
                    sup.metrics()["aggregate"])

    (up, lines, clean, rates, agg0, old, new, first, dt, owned, ok, second,
     new_m, agg) = asyncio.run(waves())
    assert agg0["restarts"] == 0, agg0
    exactly_once(first, SUP_KILL_WAVE)
    exactly_once(second, SUP_SECOND_WAVE)
    assert ok, "the process fleet never healed"
    assert old.exitcode == -signal.SIGKILL, old.exitcode
    assert new.pid != old.pid
    assert agg["worker_process_restarts"] >= 1 and agg["failovers"] >= 1, agg
    assert new_m["recompiles_after_warmup"] == 0, new_m
    agree = sum(r.label == fleet_labels[i] for i, r in enumerate(clean))
    log(f"10b {model} v4, {SUP_WORKERS} process-isolated workers on one "
        f"card (fleet up in {up:.1f} s):")
    for line in lines:
        log(f"  child {line}")
    log(f"10b: {RATE_WAVES} fault-free waves of {SUP_WAVE}: "
        f"{fmt_rates(rates)} req/s, {agg0['batches']} batches in all, "
        f"p50 {agg0['p50_latency_ms']:.2f} ms p99 "
        f"{agg0['p99_latency_ms']:.2f} ms (worst worker), 0 restarts; "
        f"{agree} of {SUP_WAVE} labels of the last agree "
        f"with 10a's fleet on the same images (the int8 activation scale is "
        f"per batch)")
    log(f"10b: {SUP_KILL_WAVE} requests in {dt * 1e3:.1f} ms with worker 0 "
        f"(pid {old.pid}) SIGKILLed holding {owned} in flight: all resolved "
        f"exactly once, {agg['failovers']} failovers, "
        f"{agg['worker_process_restarts']} process restart (exit code "
        f"{old.exitcode}), fleet healed; the replacement (pid {new.pid}) "
        f"served {SUP_SECOND_WAVE} more with 0 recompiles after warmup, on "
        f"{card}")


def sup_process_lm_phase(card):
    """10c: two process-isolated qwen3-8b v4 workers (full width and depth,
    bf16, int8 KV, 8 slots, max_len 64) on the one card: a fault-free
    32-request wave (0 restarts), then a wave with worker 0 SIGKILLed
    mid-decode; every stream of both equal to a static decode from a fresh
    state in its lane, through the same program built in this process."""
    import signal

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import LM_SUPERVISOR, lm_prompts
    from repro_torch.runtime.actor import lm_program_factory
    from repro_torch.runtime.supervisor import Supervisor

    arch = LM_ARCH
    factory_kwargs = dict(arch=arch, smoke=False, global_batch=LM_SLOTS)
    prompts = lm_prompts(get_arch(arch).vocab, N_REQUESTS)
    engine_kwargs = dict(slots=LM_SLOTS, max_len=LM_MAX_LEN,
                         kv_quant="int8")
    sup = Supervisor(**LM_SUPERVISOR)
    sup.register(arch, None, workers=SUP_WORKERS, mode="lm", warmup=(),
                 isolation="process", program_factory=lm_program_factory,
                 factory_kwargs=factory_kwargs, **engine_kwargs)

    async def waves():
        t0 = time.perf_counter()
        async with sup:
            up = time.perf_counter() - t0
            await refresh(sup)
            lines = [child_line(wh.engine) for wh in sup.workers.values()]
            t1 = time.perf_counter()
            first = await sup.submit_wave(prompts, max_new_tokens=LM_MAX_NEW)
            dt = time.perf_counter() - t1
            await refresh(sup)
            agg1 = sup.metrics()["aggregate"]
            old = sup.workers[f"{arch}/0"].engine
            killer = asyncio.ensure_future(kill_when_busy(
                old, lambda: os.kill(old.pid, signal.SIGKILL),
                settle_s=0.5))
            second = await sup.submit_wave(prompts,
                                           max_new_tokens=LM_MAX_NEW)
            owned = await killer
            ok = await healed(sup, SUP_WORKERS)
            await refresh(sup)
            new = sup.workers[f"{arch}/0"].engine
            lines.append(child_line(new))
            return (up, lines, first, dt, agg1, old, new, second, owned,
                    ok, sup.metrics()["aggregate"])

    (up, lines, first, dt, agg1, old, new, second, owned, ok,
     agg) = asyncio.run(waves())
    for results in (first, second):
        exactly_once(results, N_REQUESTS)
        assert all(len(r.generated) == LM_MAX_NEW for r in results)
    assert agg1["restarts"] == 0, agg1
    assert ok, "the LM fleet never healed"
    assert old.exitcode == -signal.SIGKILL, old.exitcode
    assert agg["failovers"] >= 1 and agg["worker_process_restarts"] >= 1, agg
    toks = sum(len(r.generated) for r in first)
    log(f"10c {arch} v4, {SUP_WORKERS} process-isolated workers on one "
        f"card, int8 KV, {LM_SLOTS} slots each (fleet up in {up:.1f} s):")
    for line in lines:
        log(f"  child {line}")
    log(f"10c: fault-free wave: {N_REQUESTS} requests, {toks} tokens in "
        f"{dt:.3f} s: {toks / dt:.1f} tokens/s, TTFT p50 "
        f"{agg1['ttft_p50_ms']:.1f} ms p99 {agg1['ttft_p99_ms']:.1f} ms, "
        f"inter-token p50 {agg1['intertoken_p50_ms']:.2f} ms p99 "
        f"{agg1['intertoken_p99_ms']:.2f} ms (worst worker), 0 restarts, "
        f"on {card}")
    log(f"10c: worker 0 (pid {old.pid}) SIGKILLed mid-decode holding "
        f"{owned} sequences: all {N_REQUESTS} finished with {LM_MAX_NEW} "
        f"tokens, {agg['failovers']} failovers (each a full prompt replayed "
        f"on a sibling), {agg['worker_process_restarts']} process restart, "
        f"fleet healed (replacement pid {new.pid})")

    # the same program in this process, the fleet gone: every stream
    # against a static decode from a fresh state in the lane it had
    t2 = time.perf_counter()
    prog, ctx = lm_program_factory(**factory_kwargs)
    engine = prog.serve(mode="lm_sync", **ctx, **engine_kwargs)
    for name, results in (("fault-free", first), ("SIGKILL", second)):
        by_uid = {r.uid: prompts[i] for i, r in enumerate(results)}
        placed = [(r.uid, *r.lane) for r in results]
        checked = serve_streams_check(engine, prog.bound_params, ctx["cfg"],
                                      ctx["run"], by_uid, placed, results,
                                      kv_quant="int8")
        assert checked == N_REQUESTS, (name, checked)
    log(f"10c: both waves' {2 * N_REQUESTS} streams equal a static decode of "
        f"the same prompts from a fresh state in their lanes, through the "
        f"same program built here ({time.perf_counter() - t2:.1f} s)")
    del engine, prog
    torch.cuda.empty_cache()


def supervised_phases(prog, apply, in_shape, params_cpu, card):
    """10a-10c: supervised, process-isolated serving on the card."""
    labels = sup_inproc_phase(prog, apply, in_shape, params_cpu, card)
    sup_process_cnn_phase(in_shape, labels, card)
    sup_process_lm_phase(card)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    # the package comes from this checkout's src/; without it, stop here
    # before printing anything
    from repro_torch.kernels import build

    dev = torch.device("cuda")

    track_programs()

    # 1) the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    # 2) build
    t0 = time.perf_counter()
    build.lib()
    how = ("reused an existing build" if build.build_seconds is None
           else f"nvcc {build.build_seconds:.1f} s")
    log(f"kernels ready in {time.perf_counter() - t0:.1f} s ({how}) -> "
        f"{build.library_path().name}")
    imma_selftest(dev)

    # 3a) the plain baselines in full f32 whatever the TF32 flags
    tf32_phase(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 3) compile ResNet50 at v4 and hold every main-path call's kernel
    # against its plain version
    from repro_torch import marvel
    from repro_torch.launch.serve import random_images

    params, apply, in_shape = model("resnet50", dev)
    x0 = torch.zeros((1, *in_shape), device=dev)
    prog = marvel.compile(apply, x0, params=params, level="v4")
    assert prog.model_class == "cnn", prog.model_class
    table = prog.resolved_extensions
    for pat in ("fused_conv", "matmul_epilogue", "pool"):
        assert table.get(pat) == "cuda", table
    log(f"compiled: {prog.summary()}")

    batch = torch.from_numpy(np.stack(
        random_images(in_shape, BATCH))).to(dev)
    recorded, counts, _ = record_launches(prog, batch)
    check_counts("resnet50 v4", counts)
    results = hold(recorded, ("fused_conv", "matmul_epilogue",
                              "windowed_pool", "global_avgpool"),
                   timed=True, extras=extra_cases(dev))
    gemm_tf32_fault_holds("resnet50 v4", recorded)
    del recorded

    # 3b) the other CNN forwards: every launch held against its plain
    # version, MobileNetV2 at v4 (all its kernels timed: the slice's main
    # path) and v2 (the depthwise kernel timed), every pool launch timed;
    # the logits of each against the CPU program
    progs, path_counts, mbv2_times = {}, {}, {}
    gemm_forwards = {"resnet50 v4": results["matmul_epilogue"]}
    conv_forwards = {"resnet50 v4": results["fused_conv"]}
    pool_forwards = {k: {"resnet50 v4": results[k]}
                     for k in ("windowed_pool", "global_avgpool")}
    for label, timed_names in (
            ("mobilenetv2 v4", ("sep_block", "matmul_epilogue", "fused_conv",
                                "global_avgpool")),
            ("mobilenetv2 v2", ("depthwise_conv", "fused_conv")),
            ("mobilenetv1 v4", ("sep_block", "global_avgpool")),
            ("densenet121 v4", ("windowed_pool", "global_avgpool",
                                "matmul_epilogue", "fused_conv")),
            ("vgg16 v4", ("windowed_pool",)),
            ("lenet5 v4", ())):
        name, level = label.split()
        p, a, shape = model(name, dev)
        mprog = marvel.compile(a, torch.zeros((1, *shape), device=dev),
                               params=p, level=level)
        log(f"compiled {label}: {mprog.summary()}")
        xb = torch.from_numpy(np.stack(random_images(shape, BATCH))).to(dev)
        rec, counts, _ = record_launches(mprog, xb)
        check_counts(label, counts)
        path_counts[label] = counts
        log(f"{label}: launches per forward {counts}")
        res = hold(rec, timed_names, timed=True)
        hold(rec, [k for k in KERNELS if counts[k] and k not in timed_names],
             timed=False)
        if counts["sep_block"]:
            tf32_fault_holds(label, rec)
        if "sep_block" in res:
            log(f"{label}: sep_block {res['sep_block']['ms']:.4f} ms over "
                f"its {counts['sep_block']} launches; the unfused library "
                f"pair at the same shapes (cuDNN's depthwise conv in f32, "
                f"then torch.matmul; a yardstick the port never calls) "
                f"{res['sep_block']['pair_ms']:.4f} ms on {card}")
        del rec
        if label == "mobilenetv2 v4":
            mbv2_times = res
            progs[label] = (mprog, a, shape)
        else:
            e2e_check(label, mprog, a, model(name, "cpu")[0], xb)
        results.update({k: v for k, v in res.items()
                        if KERNELS[k][3] == label})
        if "matmul_epilogue" in res:
            gemm_forwards[label] = res["matmul_epilogue"]
        if "fused_conv" in res:
            conv_forwards[label] = res["fused_conv"]
        for k in pool_forwards:
            if k in res:
                pool_forwards[k][label] = res[k]

    # 3c) the report, int8 PTQ and the rewritten graphs of the six CNNs
    report_phase(dev, card)

    # 4) the main paths: serve through the async engine, counts from 0
    params_cpu, _, _ = model("resnet50", "cpu")
    launches, wall = serve_phase("resnet50 v4", prog, apply, in_shape,
                                 params_cpu, card)
    kernel_ms = sum(results[k]["ms"] for k in PER_FORWARD["resnet50 v4"])
    log(f"resnet50 v4: batch-{BATCH} forward {wall:.2f} ms wall (median of "
        f"5), of which its kernels' device time {kernel_ms:.3f} ms")

    # 4b) MobileNetV2 at v4, the slice's serving path
    mprog, mapply, mshape = progs["mobilenetv2 v4"]
    mparams_cpu, _, _ = model("mobilenetv2", "cpu")
    mlaunches, mwall = serve_phase("mobilenetv2 v4", mprog, mapply, mshape,
                                   mparams_cpu, card)
    mkernel_ms = sum(r["ms"] for r in mbv2_times.values())
    log(f"mobilenetv2 v4: batch-{BATCH} forward {mwall:.2f} ms wall (median "
        f"of 5), of which its kernels' device time {mkernel_ms:.3f} ms ("
        + ", ".join(f"{k} {r['ms']:.4f}" for k, r in mbv2_times.items())
        + ")")

    # 6) the dense-LM path: qwen3-8b at full width
    prefill, dec, _, lm_launches = lm_phases(dev, card)
    free_card()
    results.update({k: v for k, v in prefill.items()
                    if KERNELS[k][3] == f"{LM_ARCH} v4 prefill"})

    # 8) the rnn_lm path: rwkv6-1.6b at full width; mac_matmul_int8 on its
    # cases
    rwkv_prefill = rwkv_phases(dev, card)
    results.update({k: v for k, v in rwkv_prefill.items()
                    if KERNELS[k][3] == f"{RWKV_ARCH} v4 prefill"})
    mac_results, mac_launches = mac_phase(dev, card)
    results.update(mac_results)
    free_card()

    # 11) the hybrid_lm path: hymba-1.5b at full width; the ssm_lm stack
    hy_prefill, hy_dec = hymba_phases(dev, card)

    # 12) the enc_dec path: whisper-tiny at full width and depth
    wh_prefill, wh_dec, wh_smoke = whisper_phases(dev, card)

    # 13) the vlm path: internvl2-26b at full width and depth
    vl_prefill, vl_dec = vlm_phases(dev, card)
    free_card()

    # 14) granite-34b's one KV head at full width, its depth cut
    mq_prefill, mq_dec = mqa_phases(dev, card)
    free_card()
    log(f"{torch.cuda.memory_allocated() / 1e9:.2f} GB held on the card "
        f"before the supervised phases")

    # 10) supervised serving: in-process workers, process-isolated workers
    # sharing the card (ResNet50 and qwen3-8b)
    supervised_phases(prog, apply, in_shape, params_cpu, card)

    # 9) the kernels line, then the device line
    path_launches = {k: launches[k] for k in PER_FORWARD["resnet50 v4"]}
    path_launches["sep_block"] = mlaunches["sep_block"]
    path_launches["depthwise_conv"] = path_counts["mobilenetv2 v2"][
        "depthwise_conv"]
    path_launches["residual_rmsnorm"] = lm_launches["residual_rmsnorm"]
    path_launches["flash_attention"] = prefill["flash_attention"][
        "per_forward"]
    path_launches["wkv_chunk"] = rwkv_prefill["wkv_chunk"]["per_forward"]
    path_launches["mac_matmul_int8"] = mac_launches
    paths = {"sep_block": "mobilenetv2 v4 serve",
             "depthwise_conv": "mobilenetv2 v2 forward",
             "residual_rmsnorm": f"{LM_ARCH} v4 serve",
             "flash_attention": f"{LM_ARCH} v4 prefill forward",
             "wkv_chunk": f"{RWKV_ARCH} v4 prefill forward",
             "mac_matmul_int8": MAC_PATH}
    batches = {"qwen3-8b v4 prefill": "B=%d S=%d" % LM_PREFILL,
               f"{RWKV_ARCH} v4 prefill": "B=%d S=%d" % RWKV_PREFILL,
               "mac_matmul_int8 cases": "(M, K, N) in %s" % (MAC_CASES,)}
    def form_entry(forward, agg, form):
        return {"form": form, "forward": forward,
                "launches": agg["per_forward"], "ms": agg["ms"],
                "fma_ms": agg.get("fma_ms"), "plain_ms": agg["plain_ms"],
                "bound_ms": agg["bound_ms"],
                "bound_bytes_ms": agg["t_bytes"],
                "bound_ops_ms": agg["t_ops"],
                "library_ms": agg["library_ms"],
                **({"pair_ms": agg["pair_ms"]} if "pair_ms" in agg else {})}

    vl_prefill_label = (f"{VLM_ARCH} v4 prefill B=%d, %d patches + %d "
                        "tokens" % VLM_PREFILL)
    mq_prefill_label = (f"{MQA_ARCH} {MQA_LAYERS}-layer v4 prefill "
                        "B=%d S=%d" % MQA_PREFILL)
    # the tensor-core forms, on the forwards that run them
    tensor_core = {
        "matmul_epilogue": [
            form_entry(f"{LM_ARCH} v4 prefill", prefill["matmul_epilogue"],
                       "wgmma"),
            form_entry(f"{LM_ARCH} v4 decode step, {LM_SLOTS} slots",
                       dec["matmul_epilogue"], "decode"),
            form_entry(f"{RWKV_ARCH} v4 prefill",
                       rwkv_prefill["matmul_epilogue"], "wgmma"),
            form_entry(f"{HYMBA_ARCH} v4 prefill",
                       hy_prefill["matmul_epilogue"], "wgmma"),
            form_entry(f"{HYMBA_ARCH} v4 decode step, {LM_SLOTS} slots",
                       hy_dec["matmul_epilogue"], "decode"),
            form_entry(f"{WHISPER_ARCH} v4 prefill B=%d F=%d S=%d"
                       % WHISPER_PREFILL, wh_prefill["matmul_epilogue"],
                       "wgmma"),
            form_entry(f"{WHISPER_ARCH} v4 decode step, {LM_SLOTS} slots",
                       wh_dec["matmul_epilogue"], "decode"),
            form_entry(vl_prefill_label, vl_prefill["matmul_epilogue"],
                       "wgmma"),
            form_entry(f"{VLM_ARCH} v4 decode step, {LM_SLOTS} slots",
                       vl_dec["matmul_epilogue"], "decode"),
            form_entry(mq_prefill_label, mq_prefill["matmul_epilogue"],
                       "wgmma"),
            form_entry(f"{MQA_ARCH} {MQA_LAYERS}-layer v4 decode step, "
                       f"{LM_SLOTS} slots", mq_dec["matmul_epilogue"],
                       "decode")],
        "flash_attention": [
            form_entry(f"{LM_ARCH} v4 prefill", prefill["flash_attention"],
                       "wgmma"),
            form_entry(f"{WHISPER_ARCH} v4 prefill B=%d F=%d S=%d"
                       % WHISPER_PREFILL, wh_prefill["flash_attention"],
                       "wgmma"),
            form_entry(f"{WHISPER_ARCH} smoke v4 B=%d S=%d" % WHISPER_SMOKE
                       + " (non-causal Sq != Skv launches among them)",
                       wh_smoke["flash_attention"], "fma"),
            form_entry(vl_prefill_label, vl_prefill["flash_attention"],
                       "wgmma"),
            form_entry(mq_prefill_label, mq_prefill["flash_attention"],
                       "wgmma")],
    }
    # the norm on internvl2-26b's and granite-34b's forwards, rows of 6144
    # (their GEMMs and flash attention are under tensor_core)
    wide = {"residual_rmsnorm": [
        form_entry(vl_prefill_label, vl_prefill["residual_rmsnorm"], "rows"),
        form_entry(f"{VLM_ARCH} v4 decode step, {LM_SLOTS} slots",
                   vl_dec["residual_rmsnorm"], "rows"),
        form_entry(mq_prefill_label, mq_prefill["residual_rmsnorm"], "rows"),
        form_entry(f"{MQA_ARCH} {MQA_LAYERS}-layer v4 decode step, "
                   f"{LM_SLOTS} slots", mq_dec["residual_rmsnorm"], "rows")]}
    # the norm on whisper-tiny's forwards (its GEMMs and flash attention
    # are under tensor_core)
    enc_dec = {"residual_rmsnorm": [
        form_entry(f"{WHISPER_ARCH} v4 prefill B=%d F=%d S=%d"
                   % WHISPER_PREFILL, wh_prefill["residual_rmsnorm"],
                   "rows"),
        form_entry(f"{WHISPER_ARCH} v4 decode step, {LM_SLOTS} slots",
                   wh_dec["residual_rmsnorm"], "rows")]}
    # the norm on hymba-1.5b's forwards (its GEMMs are under tensor_core)
    hybrid = {"residual_rmsnorm": [
        form_entry(f"{HYMBA_ARCH} v4 prefill", hy_prefill["residual_rmsnorm"],
                   "rows"),
        form_entry(f"{HYMBA_ARCH} v4 decode step, {LM_SLOTS} slots",
                   hy_dec["residual_rmsnorm"], "rows")]}
    # the f32 GEMM (fma form), the int8 conv (on int8 tensor cores) and the
    # pools (vector form) on each CNN forward that times them
    cnn_forwards = {
        "matmul_epilogue": [form_entry(f"{label} batch {BATCH}", agg, "fma")
                            for label, agg in gemm_forwards.items()],
        "fused_conv": [form_entry(f"{label} batch {BATCH}", agg, "imma")
                       for label, agg in conv_forwards.items()]}
    for name, per in pool_forwards.items():
        cnn_forwards[name] = [form_entry(f"{label} batch {BATCH}", agg,
                                         "vector")
                              for label, agg in per.items()]
    for name, lib_name in (("matmul_epilogue", "torch.matmul"),
                           ("fused_conv", "cuDNN f32"),
                           ("windowed_pool", "F.max_pool2d / F.avg_pool2d"),
                           ("global_avgpool", "x.mean")):
        for entry in cnn_forwards[name]:
            lib = entry["library_ms"]
            log(f"{name} {entry['form']} form, {entry['forward']}: "
                f"{entry['launches']} launches, {entry['ms']:.4f} ms ("
                f"{lib_name} {'null' if lib is None else f'{lib:.4f}'}, "
                f"plain {entry['plain_ms']:.4f}, bound "
                f"{entry['bound_ms']:.5f})")
    kernels = []
    for name, (_, source, replaces, forward) in KERNELS.items():
        agg = results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": path_launches[name],
            "max_abs_err": agg["max_abs_err"], "ms": agg["ms"],
            "plain_ms": agg["plain_ms"], "bound_ms": agg["bound_ms"],
            "bound_by": "bytes" if agg["t_bytes"] >= agg["t_ops"]
            else "operations",
            "bound_bytes_ms": agg["t_bytes"], "bound_ops_ms": agg["t_ops"],
            "library_ms": agg["library_ms"],
            **({"pair_ms": agg["pair_ms"]} if "pair_ms" in agg else {}),
            "forward": f"{forward} {batches.get(forward, f'batch {BATCH}')}",
            "path": paths.get(name, "resnet50 v4 serve"),
            "tensor_core_forms": tensor_core.get(name, []),
            "hybrid_forwards": hybrid.get(name, []),
            "enc_dec_forwards": enc_dec.get(name, []),
            "vlm_and_mqa_forwards": wide.get(name, []),
            "cnn_forwards": cnn_forwards.get(name, []),
        })
    records = RETIRED + [(p.summary(), p.rewrite_fallbacks, p.rewrite_baked)
                         for p in PROGRAMS]
    fell_back = [summary for summary, fallbacks, _ in records if fallbacks]
    log(f"{len(records)} programs compiled, "
        f"{sum(baked for *_, baked in records)} rewritten at compile, "
        f"{len(fell_back)} with a bucket whose rewrite failed")
    assert not fell_back, fell_back
    log("(kernel times are per forward, the one each entry names: the sum "
        "over its launches of each launch's median)")
    print(json.dumps({"kernels": kernels}), flush=True)
    assert all(math.isfinite(k["ms"]) and k["launches"] > 0 for k in kernels)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
