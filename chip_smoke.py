#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases, each fatal on failure:
  1. device: needs CUDA; prints the card's name and power limit; TF32 off
     (fp32 products stay fp32, or fp32 parity would mean nothing);
  2. build: compiles the eight kernel sources from
     ``src/repro_torch/kernels/csrc`` (one nvcc each, in parallel) and prints
     ``-Xptxas -v``'s summary, and its lines for the attention kernels on
     the tensor cores (``fwd_tc_kernel``, ``fwd_tf32_kernel``,
     ``dq_tc_kernel``, ``dkv_tc_kernel``, ``dq_tf32_kernel``,
     ``dkv_tf32_kernel``: registers, spills), and one line (registers,
     shared memory, spills) per instantiation of the paged kernels
     (``paged_decode_kernel``, ``prefill_tc_kernel``,
     ``prefill_tf32_kernel``);
  3. kernels: each of the thirteen kernels against its plain PyTorch
     version on the card, at the serving and training paths' shapes (max
     |err| <= 2e-4 + 2e-4 |ref| for fp32 outputs from identical inputs,
     summed in another order; a bf16 output may also differ by its one
     final rounding, 2^-7 |ref|), timed by CUDA-graph replay (the
     gate-residual forward and its library call as the median of three
     readings) beside its bound (fp32 attention at the larger of the fp32
     and the 3xTF32 tensor-core rate), the plain version and, where one
     PyTorch call computes the same function, that call (the bf16
     attention dq and dk/dv, the fp32 forward, dq and dk/dv at DiT's shape,
     the gate-residual forward's (d) fp32 and (m) cases, decode (a),
     prefill (c) in bf16 and in fp32 and the ln-modulate forward's main
     case also printed beside the times PERF.md records for their
     predecessors, which this run does not measure, and DiT's fp32 dq +
     dk/dv beside SDPA's whole backward); the paged kernels at stablelm's
     (a, c) and h2o-danube3's (b) shapes, each case with the kernel it ran
     (prefill (c) through both routes: bf16 q and pages on the bf16
     tensor-core kernel; fp32 q over fp32 pages and over int8 pages, the
     fp32 and fp32_kvint8 policies, on the 3xTF32 one); the row-wise
     kernels (ln-modulate, gate-residual backward, EDM loss; each AdaLN
     kernel's launch plan printed) and the attention calls of a two-pass
     layer at olmo-1b's shapes; a ragged causal attention case
     at S=1000 in bf16;
     the Euler step forward and backward at the DiT sampler's (256, 256, 16)
     and the recurrent sampler's (8, 512, 512) with F strided, in bf16 and
     at a ragged S, plus one ``torch.autograd.grad`` through
     ``fused_euler`` (the backward kernel must run); the kernels of the
     DiT-S/2 step at its shapes (attention ``full`` B=256 H=6 S=256 hd 64,
     gate-residual forward and backward (256, 256, 384), EDM loss
     (256, 256, 16), fp32), Huginn's attention (causal and db_concat,
     B=8 H=8 hd 64, fp32), ViT's (attention ``full`` B=128 H=4 S=66 at
     hd 32, the fp32 kernels' hd-32 instantiations; the Euler step at
     predict's (128, 1, 128) with F the label row of the stream) and the
     MDM's (attention ``full`` B=64 H=12 S=256 hd 64, gate-residual forward
     and backward (64, 256, 768), fp32);
  4. serve: stablelm-1.6b at full width (24 layers, d=2048), DEFAULT_DB
     (4 blocks), random weights from seed 0 with the AdaLN heads randomised,
     bf16 policy, greedy, 8 requests with prompts padded to 512 (ragged
     128-512), chunk 64, 32 new tokens; the launch counters of that run must
     equal the path's arithmetic;
  5. cross-check: the fp32 policy's prefill of phase 4's prompts through
     the kernels (the 3xTF32 prefill route; after a warm-up, under the
     profiler: device busy ms and the prefill kernel's ms, launch counts
     checked) and through their plain versions (``impl="ref"``), the
     committed pools (pages 1 and up: padding writes the trash page)
     within 1e-3 relative; one fp32 serve step from the kernels' pool and
     one z, through the kernels and through their plain versions; logits
     must agree to 1e-3 relative. Then its bf16 counterpart: the prefill
     (the tensor-core prefill route) and one serve step through the kernels,
     and both again through the plain versions, from the same z; the
     first-step logits within 5e-2 x max|ref| (the bound
     tests/test_torch_serve.py holds bf16 first-step logits to), greedy
     agreement printed;
 5b. continuous: the same model served by ``ContinuousBatcher`` (bf16,
     greedy, 8 slots, page 16, chunk 64, seg_len 16, prefix cache on): 32
     ``MarkovLM`` prompts from seed 1, ragged over 128-512 tokens, the even
     ones behind one shared 256-token prefix, all submitted before the
     first step, 64 new tokens each; the decode segments replayed from one
     CUDA graph (captured before the clock). Wall, tok/s, TTFT median and
     max (host clock), ms per segment step and per chunk dispatch (CUDA
     events) and the share of the wall spent inside a dispatch, dispatches,
     prefix hits, shared tokens, CoW copies, pool MB by dtype; the
     device-busy share under the profiler over a window, the graphed run
     of the graph-against-eager check below. Fatal:
     a request short of its 64 tokens, a page not back on the free list
     (beyond the prefix cache's own refs), launch counts other than 2 · 24
     paged decodes and gate-residuals a segment step and 24 prefills a
     chunk dispatch; the first 4 segments replayed from the graph and run
     eagerly (same schedule and draws) not giving identical tokens and
     bit-equal pools; the same queue on a pool at 60% of the worst case
     (the 8 interactive requests submitted after 2 steps) without a
     preemption and a restore, or with a request short or a page leaked;
     8 requests under the fp32 policy for 2 segments through the kernels
     and through ``impl="ref"`` with the first segment's logits (steps up
     to the first token that differs) past 1e-3 relative. Prints the
     greedy agreement, and the bf16 and int8-pool top-1 agreement with
     fp32 on the same schedule and draws;
 5c. the serving system: ``InferenceServer`` (HTTP/SSE on 127.0.0.1, an
     ephemeral port) over ``ContinuousBatcher``s whose graphs its engine
     thread captures before it listens and replays; clients are the port's
     ``stream_generate`` on an event loop in the main thread. Parity: two
     requests one at a time through a one-slot fp32 server at stablelm's
     widths with 4 layers, bit-equal to a direct graphed ``step()`` loop
     under the same generator seed, and a ``"stream": false`` twin equal to
     its SSE stream. Then phase 5b's model, bf16, 8 slots, seg_len 16,
     prefix cache on: trace A, 48 requests arriving Poisson at 60% of the
     requests/s phase 5b finished; trace B, the same shape in geometric
     bursts (mean 4) at 150%, with ``max_queue`` 8 and a shed below an
     eighth of the pool's pages; prompts clipped-lognormal in 128-512
     tokens (median 256), a quarter behind one 256-token prefix, 16-64 new
     tokens (median 32), 20% interactive (TTFT SLO 2 s, TPOT 100 ms), 60%
     standard, 20% batch. Per trace and class: TTFT and TPOT p50 and p99
     (client clock), sheds (each 429 must carry ``Retry-After``), deadline
     cancels, preemptions, SLO attainment, tok/s and the wall's share
     inside a dispatch (CUDA events). Faults: a mid-stream cancel, a
     closed connection, a slow consumer of the bridge (paused at least
     once, its 64 tokens complete) and an injected ``engine_crash`` while
     four requests stream (one restart; each request exactly its tokens,
     what it streamed a prefix of its output). Drain: the requests in
     flight complete, a new one gets 503, the pool ends whole (free pages
     and the prefix cache's refs make it); launch counts equal the
     dispatches' arithmetic (each capture's warm-up step included); with
     the servers dropped and no gc pass, memory allocated within 0.5 GiB
     of its value before the phase;
  6. train: the same model, bf16 policy, MarkovLM batches of 8 x 512 (the
     memory resident at its start beside the fp32 masters; fatal if the
     serving phases left more than 1 GiB or a batcher behind): one
     DiffusionBlocks step on each of the 4 blocks (each block with its own
     AdamW state, freed after its step), one iteration of ``train_db``
     (every block's state resident), then one end-to-end step; loss,
     wall and device time and peak memory of each, the DB steps' wall as
     median and min-max over the blocks; launch counts equal to
     the path's arithmetic (one attention forward, dq and dk/dv per layer);
     finite losses; params change only in the trained block and the
     periphery;
  7. train cross-check: one fp32 DB step on block 0 through the kernels and
     through the plain attention; loss, grad norm and one layer's gradient
     agree to 1e-3 relative;
  8. two-pass l2 train: stablelm freed first; olmo-1b at full width (16
     layers, d=2048, 16 heads of 128, non-parametric LayerNorm), random
     weights from seed 0 with the AdaLN heads randomised,
     ``DBConfig(num_blocks=4, overlap_gamma=0.1, causal_mode="two_pass",
     loss="l2")``, bf16 policy, MarkovLM batches of 8 x 512: one DB step per
     block and one ``train_db`` iteration; loss, wall and device time (the
     DB steps' wall as median and min-max), peak memory, device-busy share
     under the profiler; launch counts equal to
     the path's arithmetic (per layer two attention calls, two ln-modulate
     and two gate-residual calls on the noisy stream, forward and backward;
     one EDM loss forward and backward); finite losses; params change only
     in the trained block and the periphery;
  9. two-pass cross-check: one fp32 two-pass l2 DB step on block 0 through
     the kernels and through the plain versions (``impl="ref"``); loss,
     grad norm and one layer's gradients agree to 1e-3 relative;
 10. DiT-S/2 (paper §5.2) at full width (12 layers, d=384, 6 heads of 64,
     LayerNorm, gelu; ``DIT_DB``: 3 blocks of 4, l2), 256 tokens of 16
     dims (a 32x32x4 latent, patch 2), fp32, olmo freed first: one DB step
     per block and one e2e step at batch 256 of
     ``MixtureImagesContinuous`` (wall, device busy, peak memory; launch
     counts per step: attention 4 or 12 per kernel, gate-residual 8 or 24
     forward and backward, EDM loss 1/1), Euler sampling of 256 samples in
     18 steps, blockwise (72 layer evaluations) and full stack (216), with
     launch counts of attention forward = layer evaluations, gate-residual
     twice that, Euler 18; one fp32 DB step on block 0 at batch 256 with σ
     from block 0's range, through the kernels against ``impl="ref"``
     within 1e-3;
 11. Huginn (paper §5.5) at full width (prelude 2, core 4, coda 2, d=512,
     8 heads of 64, rmsnorm, swiglu, vocab 32000, K=32, bptt_k 8), fp32,
     MarkovLM batches of 8 x 512: one ``db_loss`` step (attention 8 per
     kernel) and one ``baseline_loss`` step (132 forward, 36 dq and dk/dv),
     each also as one fp32 step of every param through the kernels against
     ``impl="ref"`` within 1e-3 (loss, grad norm, the first core layer's
     moments), then ``db_generate_logits`` with 32 Euler steps (132
     attention forward, 32 Euler), its logits within 1e-3 of the plain
     versions';
 12. ViT (paper §5.1) at full width (``VIT_CIFAR``: 12 layers, d=128, 4
     heads of 32, ff 512, 100 classes; ``VIT_DB``: 3 blocks of 4), fp32,
     ``GaussianMixtureImages`` batches of 128 32x32x3 images (patch 4: 66
     tokens): one DB step per block (4 attention launches of each kind, no
     AdaLN kernel: the label token's ``cond_mask``) and one e2e step (12
     each), wall, device busy and peak memory; ``predict`` of the 128
     images in 8 Euler steps (32 attention forwards, 8 Euler) with its
     logits within 1e-3 of ``impl="ref"``'s, and ``predict_e2e`` (12);
     accuracy printed (untrained: sanity only); one fp32 DB step on block
     0 through the kernels against ``impl="ref"`` within 1e-3;
 13. the masked-diffusion LM (paper §5.3) at full width (``MDM``: 12
     layers, d=768, 12 heads of 64, ff 3072, vocab 32 with [MASK] = 31;
     ``MDM_DB``: 3 blocks), fp32, ``MarkovLM`` batches of 64 x 256: one DB
     step per block (4 attention launches of each kind, 8 gate-residual
     forward and backward) and one e2e step (12, 24); ``nelbo_bpc`` with 2
     samples; ``generate`` of 8 x 256 in 50 steps and the final fill (51
     forwards of a 4-layer block: 204 attention and 408 gate-residual
     forwards); one fp32 DB step on block 0 through the kernels against
     ``impl="ref"`` within 1e-3;
 14. the fault-tolerant training system. 14a: stablelm-1.6b at full width
     and depth again (``DEFAULT_DB``: 4 blocks of 6 layers, random weights
     from seed 0, AdaLN heads randomised) through the round-robin
     ``BlockParallelTrainer``, bf16 policy with fp32 masters,
     replicate+psum-mean, ``MarkovStream`` batches of 8 x 512 through
     ``HostDataLoader``: a warm-up batch, a timed batch (wall, CUDA-event
     ms, peak memory beside phase 6's ``train_db`` and e2e peaks), a
     profiled batch (device-busy share), and a batch with a NaN injected
     into block 2's loss, whose stack, moments and step counter must stay
     bit-unchanged while the other blocks and the periphery move; each
     block update launches one DB step's kernels; then one fp32 batch at
     stablelm's widths with 4 layers (4 blocks of 1) through the kernels
     against ``impl="ref"`` (losses within 1e-3 relative, params within
     1e-3, first moments within 1e-3 of their largest). 14b:
     ``TrainRunner`` at stablelm's widths and vocabulary with 4 layers,
     bf16, checkpoints in a temporary directory on the machine's disk
     (bytes, seconds and sha256 seconds of each save and load printed;
     deleted at the end): block-parallel (4 blocks of 1, 6 batches,
     checkpoints every 2, 2 kept) under ``RUNNER_FAULTS`` (a NaN block,
     a pod death and re-adoption, a torn generation) with its counters
     equal to ``RUNNER_COUNTERS``; the same run killed after batch 5 and
     resumed, which must fall back past the torn generation and end
     bit-equal to the uninterrupted run (params, moments, step counters,
     history, heartbeats, guard state); and db mode (2 blocks of 2
     layers) with one ``pod_die`` restart, killed after step 3 of 4.

Prints one JSON line ``{"kernels": [...]}`` and, last, ``{"ok": true,
"device": {...}}``. The Euler backward runs on no main path (the samplers
run under ``no_grad``): it is checked in phase 3 only and reports 0
launches. Exits non-zero without a CUDA device or without the
repository's ``src`` beside it.
"""
import dataclasses
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
import weakref
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "build" / "chip_smoke"      # full -Xptxas -v logs
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
PEAK_BF16 = 989e12             # dense tensor-core bf16
PEAK_FP32 = 67e12              # fp32 outside the tensor cores
# fp32-accurate products on the tensor cores: three tf32 products each
# (3xTF32) at the dense tf32 rate. The fp32 attention bounds take the larger
# of this and PEAK_FP32, the least time for the work whatever kernel does it
PEAK_FP32_TC = 494.7e12 / 3
TOL = 2e-4
BF16_ULP = 2.0 ** -7           # one rounding of a bf16 output, relative
ARCH = "stablelm-1.6b"
TWO_PASS_ARCH = "olmo-1b"
BATCH, PROMPT, CHUNK, MAX_NEW, PSZ = 8, 512, 64, 32, 16
TRAIN_BATCH, TRAIN_SEQ = 8, 512
ATTN = ("flash_attention_fwd", "flash_attention_bwd_dq",
        "flash_attention_bwd_dkv")
DIT_TOKENS, DIT_DIM, DIT_BATCH = 256, 16, 256   # DiT-S/2: 32x32x4, patch 2
DIT_SAMPLES, DIT_STEPS = 256, 18
VIT_BATCH, VIT_STEPS = 128, 8                   # predict as Table 1 calls it
MDM_BATCH, MDM_SEQ, MDM_GEN = 64, 256, 8        # 256: MD4's text8 context
HUGINN_BPTT = 8
TC_KERNELS = ("fwd_tc_kernel", "fwd_tf32_kernel", "dq_tc_kernel",
              "dkv_tc_kernel", "dq_tf32_kernel", "dkv_tf32_kernel")
PAGED_KERNELS = ("paged_decode_kernel", "prefill_tc_kernel",
                 "prefill_tf32_kernel")
# kernel ms that PERF.md records for the kernels the paged redesigns
# replaced (NVIDIA H100 80GB HBM3, 700.00 W): decode (a), prefill (c) in
# bf16, and (c) with fp32 q and pages (the CUDA-core
# paged_attention_kernel); printed beside this run's times, never measured
# here
PRIOR_DECODE_A_MS, PRIOR_PREFILL_C_MS = 0.0548, 0.3148
PRIOR_PREFILL_C_FP32_MS = 0.2593
# the bf16 serve cross-check (phase 5): prompts and z of each seed, and the
# limits set from its readings (PERF.md): the whole path's logits, and the
# pages the tensor-core prefill reaches, above every sound seed and below
# the bf16-P control
BF16_CROSS_SEEDS = (0, 1, 2)
BF16_LOGITS_LIMIT, BF16_PAGES_LIMIT = 4.5e-5, 1.5e-3
# the continuous phase (5b): traffic and its graph-against-eager window
CB_SLOTS, CB_REQUESTS, CB_NEW, CB_SEG = 8, 32, 64, 16
CB_MIN, CB_MAX, CB_SHARED, CB_CHECK_SEGMENTS = 128, 512, 256, 4
# the serving system (5c): each trace's requests, prompt median, new tokens
# (median 32), arrival rates as shares of the requests/s phase 5b finished,
# trace B's mean burst, the class mix and the interactive SLOs; the memory
# the dropped servers may leave allocated
SRV_REQUESTS, SRV_PROMPT, SRV_NEW = 48, 256, (16, 64)
SRV_RATE_A, SRV_RATE_B, SRV_BURST = 0.6, 1.5, 4
SRV_MIX = (("interactive", 0.2), ("standard", 0.6), ("batch", 0.2))
SRV_TTFT_SLO_MS, SRV_TPOT_SLO_MS = 2000, 100
SRV_HOST, SRV_MEM_SLACK = "127.0.0.1", 0.5 * 2**30


class SmokeError(RuntimeError):
    pass


def say(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------

def gpu_query(fields: str) -> str:
    res = subprocess.run(["nvidia-smi", f"--query-gpu={fields}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def phase_device() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_query("name,power.limit")
    say(f"[device] {card}")
    say(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} | {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()} | tf32 off")


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------

def ptxas_summary(entry: str) -> str:
    """One instantiation's ``-Xptxas -v`` entry as one line: its mangled
    name, registers, shared memory, spills."""
    name = re.search(r"Compiling entry function '(\S+)'", entry)
    regs = re.search(r"Used (\d+) registers", entry)
    smem = re.search(r"(\d+) bytes smem", entry)
    spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      entry)
    return (f"{name.group(1) if name else '?'}: "
            f"{regs.group(1) if regs else '?'} registers, "
            f"{smem.group(1) if smem else 0} B static smem, spills "
            f"{spill.groups() if spill else (0, 0)}")


def phase_build() -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    built = _build.build()
    say(f"[build] {len(built)} kernel libraries built in "
        f"{time.perf_counter() - t0:.1f} s into {_build.build_dir()}")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    for name, info in built.items():
        log = info["log"]
        (OUT_DIR / f"ptxas_{name}.log").write_text(log)
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        smem = [int(b) for b in re.findall(r"(\d+) bytes smem", log)]
        spills = [line.strip() for line in log.splitlines()
                  if "spill stores" in line
                  and "0 bytes spill stores, 0 bytes spill loads" not in line]
        say(f"[build] {name}: {info['seconds']:.1f} s, {len(regs)} kernels, "
            f"registers max {max(regs, default=0)}, smem max "
            f"{max(smem, default=0)} B, kernels that spill: {len(spills)}")
        for line in spills[:4]:
            say(f"[build]   {line}")
        # the attention kernels on the tensor cores, line by line; the
        # paged kernels, a line an instantiation
        for entry in re.split(r"(?=ptxas info\s*: Compiling entry)", log):
            if any(k in entry for k in TC_KERNELS):
                for line in entry.splitlines():
                    if "Compile time" not in line:
                        say(f"[build]   {line.strip()}")
            elif any(k in entry for k in PAGED_KERNELS):
                say(f"[build]   {ptxas_summary(entry)}")
    for name in _build.SOURCES:
        _build.load(name)


# ---------------------------------------------------------------------------
# 3. kernels against their plain versions
# ---------------------------------------------------------------------------

def eager_ms(fn, n_inputs: int, iters: int = 40) -> float:
    """ms per eager call of fn(i), CUDA events around a loop: what the
    serving path pays per launch, host overhead (Python, wrapper checks,
    ctypes) included when the host is the slower side."""
    for i in range(3):
        fn(i % n_inputs)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i % n_inputs)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_trials(fn, n_inputs: int, calls: int = 16, reps: int = 10,
                  trials: int = 1) -> list:
    """Device ms per call of fn(i), ``trials`` readings: ``calls`` calls
    captured in one CUDA graph, replayed ``reps`` times between CUDA events
    per reading, so no host time is counted. Inputs cycle over n_inputs
    copies that together exceed the 50 MB L2, so each call finds its pages
    cold, as on the serving path."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i % n_inputs)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fn(i % n_inputs)
    graph.replay()
    torch.cuda.synchronize()
    readings = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        readings.append(start.elapsed_time(end) / (reps * calls))
    return readings


def device_ms(fn, n_inputs: int, calls: int = 16, reps: int = 10) -> float:
    return device_trials(fn, n_inputs, calls, reps)[0]


def compare(name: str, got, want, bf16_rounding: bool = False) -> float:
    """Max |err|; raises past TOL + TOL |ref|, or, for bf16 outputs with
    ``bf16_rounding``, past TOL + 2^-7 |ref| (one rounding of the output:
    the kernel and the plain version accumulate in fp32 in another order,
    which moves a value across a bf16 rounding boundary now and then)."""
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    worst = 0.0
    for g, w in zip(got, want):
        rel = BF16_ULP if bf16_rounding and g.dtype == torch.bfloat16 \
            else TOL
        g, w = g.float(), w.float()
        if not torch.isfinite(g).all():
            raise SmokeError(f"{name}: kernel output is not finite")
        err = (g - w).abs()
        worst = max(worst, err.max().item())
        if (err > TOL + rel * w.abs()).any():
            raise SmokeError(f"{name}: kernel disagrees with its plain "
                             f"version, max |err| {err.max().item():.3e}")
    return worst


def rotations(nbytes: int) -> int:
    return max(2, math.ceil(3 * 50e6 / max(nbytes, 1)) + 1)


def attn_work(q, pages, lengths, npg, window, prefill, quantized):
    """(bytes, flops, peak) the call needs with this run's lengths: q read,
    each key row some query can see read once as K and V (plus its page's
    scales), table and lengths read, out (and lse) written; flops count the
    (row, key) pairs the masks admit, 2 for q.k and 2 for p.v per dim."""
    B, KV, hd, psz = q.shape[0], pages.shape[2], pages.shape[3], \
        pages.shape[1]
    C = q.shape[1] if prefill else 1
    G = q.shape[-2]
    L = npg * psz
    keys, pairs, pages_read = 0, 0, 0
    for n in lengths.tolist():
        q_first, q_last = (n, n + C - 1) if prefill else (n, n)
        kend = min(q_last + 1 if prefill else n, L)
        kbeg = max(0, q_first - window + 1) if window else 0
        keys += max(0, kend - kbeg)
        pages_read += max(0, -(-kend // psz) - kbeg // psz)
        for i in range(C):
            qpos = n + i if prefill else n
            hi = min(qpos + 1 if prefill else qpos, L)
            lo = max(0, qpos - window + 1) if window else 0
            pairs += max(0, hi - lo)
    nbytes = (q.numel() * q.element_size()
              + keys * KV * hd * pages.element_size() * 2
              + (pages_read * 8 if quantized else 0)
              + B * npg * 4 + B * 4 + B * C * KV * G * hd * 4
              + (0 if prefill else B * KV * G * 4))
    flops = pairs * KV * G * hd * 4
    # fp32 q: the fp32 rate the card reaches, on the tensor cores by 3xTF32
    peak = PEAK_BF16 if q.dtype == torch.bfloat16 else max(PEAK_FP32,
                                                           PEAK_FP32_TC)
    return nbytes, flops, peak


def bound(nbytes: float, flops: float, peak: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def make_pool(gen, dtype, P, KV, hd, dev):
    shape = (P, PSZ, KV, hd)
    if dtype == torch.int8:
        k = torch.randint(-127, 128, shape, generator=gen, device=dev,
                          dtype=torch.int8)
        v = torch.randint(-127, 128, shape, generator=gen, device=dev,
                          dtype=torch.int8)
        ks = torch.rand(P, generator=gen, device=dev) * 0.02 + 1e-3
        vs = torch.rand(P, generator=gen, device=dev) * 0.02 + 1e-3
        return k, v, ks, vs
    k = torch.randn(shape, generator=gen, device=dev).to(dtype)
    v = torch.randn(shape, generator=gen, device=dev).to(dtype)
    return k, v, None, None


def paged_case(label, kind, *, KV, G, hd, page_dtype, q_dtype, window,
               lengths, dev, gen, C=1, prior=None, cap=PROMPT + MAX_NEW):
    """One paged kernel case against its plain version, timed by CUDA-graph
    replay: one slot a length, each with pages for ``cap`` keys; ``prior``:
    the ms PERF.md records for the kernel this one replaced at the same
    case, printed beside this run's (not measured here, so kept out of the
    row)."""
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.kernels import flash_prefill as FP
    B = len(lengths)
    npg = -(-cap // PSZ)
    P = 1 + B * npg
    prefill = kind == "flash_prefill"
    kern, ref = ((FP.flash_prefill, FP.flash_prefill_ref) if prefill
                 else (FD.flash_decode, FD.flash_decode_ref))
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    table = (1 + torch.randperm(B * npg, generator=gen, device=dev)
             ).to(torch.int32).reshape(B, npg)
    qshape = (B, C, KV, G, hd) if prefill else (B, KV, G, hd)
    one = make_pool(gen, page_dtype, P, KV, hd, dev)
    pool_bytes = sum(t.numel() * t.element_size() for t in one
                     if t is not None)
    sets = [one] + [make_pool(gen, page_dtype, P, KV, hd, dev)
                    for _ in range(rotations(pool_bytes) - 1)]
    q = torch.randn(qshape, generator=gen, device=dev).to(q_dtype)
    kw = lambda s: dict(window=window, k_scale=s[2], v_scale=s[3])
    got = kern(q, sets[0][0], sets[0][1], table, lens, **kw(sets[0]))
    torch.cuda.synchronize()
    want = ref(q, sets[0][0], sets[0][1], table, lens, **kw(sets[0]))
    err = compare(label, got, want)
    call_k = lambda i: kern(q, sets[i][0], sets[i][1], table, lens,
                            **kw(sets[i]))
    call_r = lambda i: ref(q, sets[i][0], sets[i][1], table, lens,
                           **kw(sets[i]))
    ms, e_ms = device_ms(call_k, len(sets)), eager_ms(call_k, len(sets))
    plain_ms = device_ms(call_r, len(sets), calls=4, reps=3)
    nbytes, flops, peak = attn_work(q, one[0], lens, npg, window, prefill,
                                    page_dtype == torch.int8)
    bound_ms, by = bound(nbytes, flops, peak)
    row = {"case": label, "max_abs_err": err, "ms": ms, "eager_ms": e_ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
           "library_ms": None, "bytes": nbytes, "flops": flops}
    if prefill:
        route = {"tc": "prefill_tc_kernel", "tf32": "prefill_tf32_kernel"
                 }[FP.prefill_route(q_dtype, page_dtype)]
    else:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        ns = FD.decode_splits(B * KV, FD.max_tiles(npg * PSZ, window), sms)
        route = f"paged_decode_kernel, {ns} blocks a pair"
    say(f"[kernels] {label} [{route}]: max|err| {err:.2e} | kernel {ms:.4f} "
        f"ms device ({e_ms:.4f} ms per eager call) | bound {bound_ms:.4f} ms "
        f"({by}; {nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP) | plain "
        f"{plain_ms:.3f} ms | library none")
    if prior is not None:
        say(f"[kernels] {label}: {ms:.4f} ms this run; the kernel it "
            f"replaced {prior:.4f} ms (recorded in PERF.md, NVIDIA H100 80GB "
            "HBM3, 700.00 W; not this run)")
    return row


def gate_case(label, shape, x_dtype, gate_dtype, dev, gen, prior=None):
    """The gate-residual forward on a strided (B, 6d) head slice; ``prior``:
    its predecessor's ms as PERF.md records it, printed beside this run's
    (not measured here, so kept out of the row)."""
    from repro_torch.kernels import fused_adaln as AD
    B, S, d = shape
    res = torch.randn(shape, generator=gen, device=dev).to(x_dtype)
    br = torch.randn(shape, generator=gen, device=dev).to(x_dtype)
    heads = (0.1 * torch.randn(B, 6 * d, generator=gen, device=dev)
             ).to(gate_dtype)
    gate = heads[:, 2 * d:3 * d]            # the probe's strided slice
    got = AD.gate_residual(res, br, gate)
    torch.cuda.synchronize()
    err = compare(label, got, AD.gate_residual_ref(res, br, gate))
    call_k = lambda i: AD.gate_residual(res, br, gate)
    g1 = 1.0 + gate[:, None, :].to(x_dtype)
    call_l = lambda i: torch.addcmul(res, br, g1)
    # a launch lasts about a microsecond at the probe's shape, where one
    # reading of kernel and library each swings by ~10%: median of three
    ms = statistics.median(device_trials(call_k, 1, calls=64, trials=3))
    library_ms = statistics.median(device_trials(call_l, 1, calls=64,
                                                 trials=3))
    e_ms = eager_ms(call_k, 1, iters=200)
    plain_ms = device_ms(lambda i: AD.gate_residual_ref(res, br, gate), 1,
                         calls=64)
    nbytes = 3 * res.numel() * res.element_size() + B * d * \
        gate.element_size()
    flops = 2 * res.numel()
    bound_ms, by = bound(nbytes, flops, PEAK_FP32)
    say(f"[kernels] {label}: max|err| {err:.2e} | kernel {ms:.5f} ms device "
        f"({e_ms:.4f} ms per eager call) | bound {bound_ms:.5f} ms ({by}; "
        f"{nbytes / 1e6:.3f} MB) | plain {plain_ms:.5f} ms | library "
        f"(addcmul, 1+gate made outside) {library_ms:.5f} ms")
    if prior is not None:
        say(f"[kernels] {label}: {ms:.5f} ms this run; the grid-stride "
            f"kernel it replaced {prior:.4f} ms (recorded in PERF.md, NVIDIA "
            "H100 80GB HBM3, 700.00 W; not this run)")
    return {"case": label, "max_abs_err": err, "ms": ms, "eager_ms": e_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
            "library_ms": library_ms, "bytes": nbytes, "flops": flops}


def rowwise_case(label, kern, ref, sets, nbytes, flops, prior=None) -> dict:
    """One row-wise kernel (its wrapper, with any launch it makes) against
    its plain version on input set 0, then timed by CUDA-graph replay over the
    sets, which together exceed the 50 MB L2 (each call finds its inputs
    cold, as a layer of the training step does). No single PyTorch call
    computes these functions: F.layer_norm takes no per-example affine, and
    the loss needs its target formed first. ``prior``: the predecessor's ms
    at this case as PERF.md records it, printed beside this run's (not
    measured here, so kept out of the row)."""
    got = kern(*sets[0])
    torch.cuda.synchronize()
    err = compare(label, got, ref(*sets[0]), bf16_rounding=True)
    n = len(sets)
    ms = device_ms(lambda i: kern(*sets[i]), n)
    plain_ms = device_ms(lambda i: ref(*sets[i]), n, calls=4, reps=3)
    bound_ms, by = bound(nbytes, flops, PEAK_FP32)
    say(f"[kernels] {label}: max|err| {err:.2e} | kernel {ms:.4f} ms device "
        f"| bound {bound_ms:.4f} ms ({by}; {nbytes / 1e6:.1f} MB, "
        f"{flops / 1e9:.3f} GFLOP) | plain {plain_ms:.4f} ms | library none")
    if prior is not None:
        say(f"[kernels] {label}: {ms:.4f} ms this run; the kernel it "
            f"replaced {prior:.4f} ms (recorded in PERF.md, "
            "NVIDIA H100 80GB HBM3, 700.00 W; not this run)")
    return {"case": label, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
            "library_ms": None, "bytes": nbytes, "flops": flops}


def adaln_sets(gen, dev, B, S, d, dt):
    """(x, scale, shift, g) input sets for the AdaLN kernels, enough to
    exceed the L2 together: x off-centre, the (B, d) vectors fp32 column
    slices of one (B, 6d) head output (row stride 6d)."""
    one = 2 * B * S * d * torch.tensor([], dtype=dt).element_size()
    out = []
    for _ in range(rotations(one)):
        x = (1.0 + torch.randn(B, S, d, generator=gen, device=dev)).to(dt)
        g = torch.randn(B, S, d, generator=gen, device=dev).to(dt)
        heads = 0.1 * torch.randn(B, 6 * d, generator=gen, device=dev)
        out.append((x, heads[:, d:2 * d], heads[:, :d], g))
    return out


def adaln_plan(name, x, vec) -> str:
    """A redesigned AdaLN kernel's launch plan at these inputs."""
    from repro_torch.kernels import fused_adaln as AD
    B, S, d = x.shape
    p = AD.launch_plan(name, B, S, d, x.dtype, vec.dtype, x.device)
    tiles = (f"blocks ({p['cx']}, {p['ry']}) threads, {p['n_tiles']} tiles "
             f"of {p['tile_rows']} rows an example")
    if name == "ln_modulate_fwd":
        return tiles
    return (f"{tiles} in clusters of {p['cl']}, "
            f"{p['scratch'] * 4 / 1e6:.3f} MB scratch; the tiles are summed "
            "in the kernel (no partial-sum launch)")


# ms of the AdaLN backwards the redesign replaced, at phase 3's cases, from
# PR 20's chip_smoke.py run (NVIDIA H100 80GB HBM3, 700.00 W; recorded in
# PERF.md): printed beside this run's, never measured here
PRIOR_LN_BWD_MS = {"bf16": 0.0564, "fp32": 0.0755, "ragged": 0.0336}
# the warp-per-row ln-modulate forward the row-tile redesign replaced, at
# the main case (recorded in PERF.md, NVIDIA H100 80GB HBM3, 700.00 W; not
# measured here)
PRIOR_LN_FWD_MS = 0.0193
PRIOR_GATE_BWD_MS = {"bf16": 0.0318, "fp32": 0.0433, "ragged": 0.0207,
                     "dit": 0.1101}


def phase_rowwise(dev) -> dict:
    """The ln-modulate, gate-residual backward and EDM-loss kernels at the
    two-pass olmo-1b path's shapes (8 x 512 rows of d = 2048; the AdaLN
    vectors fp32 column slices of a (B, 6d) head output, row stride 6d),
    the first case of each being its main case; plus an fp32-stream case,
    a ragged one (S not a multiple of the kernels' tiles) and, for the
    gate backward and the loss, the DiT-S/2 step's (256, 256, 384) and
    (256, 256, 16) fp32 (and the gate backward at the MDM step's (64, 256,
    768) fp32). Bytes: each
    input read once, each output written once; flops per element: ln
    forward 8, ln backward 16, gate backward 3, loss forward 6, loss
    backward 9."""
    from repro_torch.kernels import edm_loss as EDM
    from repro_torch.kernels import fused_adaln as AD
    gen = torch.Generator(device=dev).manual_seed(3)
    rows = {n: [] for n in ("ln_modulate_fwd", "ln_modulate_bwd",
                            "gate_residual_bwd", "edm_loss_fwd",
                            "edm_loss_bwd")}
    bf16, f32 = torch.bfloat16, torch.float32

    d = 2048
    for B, S, dt, tag, key in ((8, 512, bf16, "bf16 (two-pass path)", "bf16"),
                               (8, 512, f32, "fp32", "fp32"),
                               (8, 130, bf16, "bf16, ragged S=130",
                                "ragged")):
        sets = adaln_sets(gen, dev, B, S, d, dt)
        n, elt, vec = B * S * d, sets[0][0].element_size(), B * d * 4
        shape = f"({B},{S},{d}) {tag}, fp32 slices"
        label = f"(i) ln_modulate fwd {shape}"
        say(f"[kernels] {label}: "
            f"{adaln_plan('ln_modulate_fwd', sets[0][0], sets[0][1])}")
        rows["ln_modulate_fwd"].append(rowwise_case(
            label, lambda x, sc, sh, g: AD.ln_modulate_fwd(x, sc, sh),
            lambda x, sc, sh, g: AD.ln_modulate_ref(x, sc, sh),
            sets, 2 * n * elt + 2 * vec, 8 * n,
            PRIOR_LN_FWD_MS if key == "bf16" else None))
        label = f"(i) ln_modulate bwd {shape}"
        say(f"[kernels] {label}: "
            f"{adaln_plan('ln_modulate_bwd', sets[0][0], sets[0][1])}")
        rows["ln_modulate_bwd"].append(rowwise_case(
            label, lambda x, sc, sh, g: AD.ln_modulate_bwd(x, sc, g),
            lambda x, sc, sh, g: AD.ln_modulate_bwd_ref(x, sc, g),
            sets, 3 * n * elt + 3 * vec, 16 * n, PRIOR_LN_BWD_MS[key]))
        # gate backward: the same streams as branch and cotangent
        label = f"(j) gate_residual bwd {shape}"
        say(f"[kernels] {label}: "
            f"{adaln_plan('gate_residual_bwd', sets[0][0], sets[0][1])}")
        rows["gate_residual_bwd"].append(rowwise_case(
            label, lambda x, sc, sh, g: AD.gate_residual_bwd(x, sc, g),
            lambda x, sc, sh, g: AD.gate_residual_bwd_ref(x, sc, g),
            sets, 3 * n * elt + 2 * vec, 3 * n, PRIOR_GATE_BWD_MS[key]))
    B, S, d = 256, 256, 384            # the DiT-S/2 layer's σ-gates
    sets, n = adaln_sets(gen, dev, B, S, d, f32), B * S * d
    label = (f"(m) gate_residual bwd ({B},{S},{d}) fp32 (DiT-S/2 step), fp32 "
             "slices")
    say(f"[kernels] {label}: "
        f"{adaln_plan('gate_residual_bwd', sets[0][0], sets[0][1])}")
    rows["gate_residual_bwd"].append(rowwise_case(
        label, lambda x, sc, sh, g: AD.gate_residual_bwd(x, sc, g),
        lambda x, sc, sh, g: AD.gate_residual_bwd_ref(x, sc, g),
        sets, 3 * n * 4 + 2 * B * d * 4, 3 * n, PRIOR_GATE_BWD_MS["dit"]))
    B, S, d = 64, 256, 768             # the MDM layer's σ-gates
    sets, n = adaln_sets(gen, dev, B, S, d, f32), B * S * d
    label = (f"(q) gate_residual bwd ({B},{S},{d}) fp32 (MDM step), fp32 "
             "slices")
    say(f"[kernels] {label}: "
        f"{adaln_plan('gate_residual_bwd', sets[0][0], sets[0][1])}")
    rows["gate_residual_bwd"].append(rowwise_case(
        label, lambda x, sc, sh, g: AD.gate_residual_bwd(x, sc, g),
        lambda x, sc, sh, g: AD.gate_residual_bwd_ref(x, sc, g),
        sets, 3 * n * 4 + 2 * B * d * 4, 3 * n))
    for B, S, d, tag in ((8, 512, 2048, "(two-pass l2 path)"),
                         (8, 300, 2048, "ragged S=300"),
                         (256, 256, 16, "(DiT-S/2 l2 path)")):
        nt = -(-S // EDM.BLOCK_ROWS)
        n = B * S * d
        sets = []
        for _ in range(rotations(3 * n * 4)):
            f, z, y = (torch.randn(B, S, d, generator=gen, device=dev)
                       for _ in range(3))
            sigma = torch.rand(B, generator=gen, device=dev) * 3 + 0.01
            cs, co = EDM._coeffs(sigma, 0.5)
            g = torch.randn(B, nt, generator=gen, device=dev)
            sets.append((f, z, y, cs, co, g))
        shape = f"({B},{S},{d}) fp32 {tag}"
        rows["edm_loss_fwd"].append(rowwise_case(
            f"(k) edm_loss fwd {shape}",
            lambda f, z, y, cs, co, g: EDM.edm_loss_fwd(f, z, y, cs, co),
            lambda f, z, y, cs, co, g: EDM.edm_loss_partials_ref(
                f, z, y, cs, co, EDM.BLOCK_ROWS),
            sets, 3 * n * 4 + 2 * B * 4 + B * nt * 4, 6 * n))
        rows["edm_loss_bwd"].append(rowwise_case(
            f"(k) edm_loss bwd {shape}",
            lambda f, z, y, cs, co, g: EDM.edm_loss_bwd(f, z, y, cs, co, g),
            lambda f, z, y, cs, co, g: EDM.edm_loss_bwd_ref(
                f, z, y, cs, co, g, EDM.BLOCK_ROWS),
            sets, 6 * n * 4 + 2 * B * 4 + B * nt * 4, 9 * n))
    return rows


def phase_euler(dev) -> dict:
    """The Euler step's kernels: the DiT sampler's (256, 256, 16) fp32 (the
    main case), the recurrent sampler's (8, 512, 512) fp32 with F the
    strided noisy half of a (8, 1024, 512) stream (read in place: no copy,
    so the bytes are those of the half), a bf16 case, a ragged S and ViT's
    predict (128, 1, 128) with F the label row of a (128, 66, 128) stream.
    Bytes:
    z, F (or g) read once, outputs written once, a and b (B,) fp32; flops 3
    per element forward, 2 backward. Then one ``torch.autograd.grad``
    through ``fused_euler`` on the card: the backward kernel must run and
    give the plain version's gradients."""
    from repro_torch.kernels import fused_adaln as AD
    gen = torch.Generator(device=dev).manual_seed(4)
    rows = {"euler_fwd": [], "euler_bwd": []}
    f32, bf16 = torch.float32, torch.bfloat16

    def coeffs(B):
        sigma = torch.rand(B, generator=gen, device=dev) * 40 + 0.01
        sigma_to = sigma * torch.rand(B, generator=gen, device=dev)
        sigma_to[0] = 0.0                     # the chain's last step
        return sigma, sigma_to

    def stream(B, S, d, dt, span):
        """F: the last S of ``span`` rows of each example (strided where
        span > S)."""
        return torch.randn(B, span, d, generator=gen,
                           device=dev).to(dt)[:, span - S:]

    for (B, S, d), dt, span, tag in (
            ((256, 256, 16), f32, 256, "DiT-S/2 sampler, 256 samples"),
            ((8, 512, 512), f32, 1024, "Huginn sampler, F strided"),
            ((8, 512, 512), bf16, 1024, "bf16, F strided"),
            ((8, 333, 512), f32, 333, "ragged S=333"),
            ((128, 1, 128), f32, 66, "ViT predict, F the label token of "
             "66")):
        n, elt = B * S * d, torch.tensor([], dtype=dt).element_size()
        sets = []
        for _ in range(rotations(3 * n * elt)):
            z = torch.randn(B, S, d, generator=gen, device=dev).to(dt)
            a, b = AD.euler_coeffs(*coeffs(B), 0.5)
            g = torch.randn(B, S, d, generator=gen, device=dev).to(dt)
            sets.append((z, stream(B, S, d, dt, span), a, b, g))
        shape = f"({B},{S},{d}) {str(dt)[6:]} {tag}"
        rows["euler_fwd"].append(rowwise_case(
            f"(l) euler fwd {shape}",
            lambda z, f, a, b, g: AD.euler_fwd(z, f, a, b),
            lambda z, f, a, b, g: AD.euler_ref(z, f, a, b),
            sets, 3 * n * elt + 2 * B * 4, 3 * n))
        rows["euler_bwd"].append(rowwise_case(
            f"(l) euler bwd {shape}",
            lambda z, f, a, b, g: AD.euler_bwd(g, a, b),
            lambda z, f, a, b, g: AD.euler_bwd_ref(g, a, b),
            sets, 3 * n * elt + 2 * B * 4, 2 * n))

    B, S, d = 8, 512, 512
    z = torch.randn(B, S, d, generator=gen, device=dev).requires_grad_()
    f2 = torch.randn(B, 2 * S, d, generator=gen, device=dev).requires_grad_()
    sigma, sigma_to = coeffs(B)
    n0 = AD.euler_bwd.launches
    out = AD.fused_euler(z, f2[:, S:], sigma, sigma_to, 0.5)
    g = torch.randn(B, S, d, generator=gen, device=dev)
    dz, df2 = torch.autograd.grad(out, (z, f2), g)
    torch.cuda.synchronize()
    if AD.euler_bwd.launches != n0 + 1:
        raise SmokeError("autograd through fused_euler did not launch the "
                         "backward kernel")
    want = AD.euler_bwd_ref(g, *AD.euler_coeffs(sigma, sigma_to, 0.5))
    err = compare("fused_euler autograd", (dz, df2[:, S:]), want)
    if (df2[:, :S] != 0).any():
        raise SmokeError("fused_euler autograd: gradient outside F's view")
    say(f"[kernels] autograd.grad through fused_euler (8,512,512), F "
        f"strided: euler_bwd launched, max|err| {err:.2e} against the plain "
        f"backward")
    return rows


def attention_work(cfg, B, H, KV, S, Sk, hd, elt):
    """Bytes and flops of each attention kernel at these shapes (S queries,
    Sk keys): every input read once, every output written once (fp32 lse
    and delta); flops over the (q, k) pairs this mask keeps: 4 hd per pair
    and head for the forward (q.k, p.v), 6 hd for dq (q.k, dO.v, ds.k), 8 hd
    for dk/dv."""
    from repro_torch.kernels import flash_attention as FA
    pairs = int(FA.keep_mask(cfg, S, Sk).sum())
    q_b, kv_b, row_b = B * H * S * hd * elt, B * KV * Sk * hd * elt, \
        B * H * S * 4
    return {"flash_attention_fwd": (2 * q_b + 2 * kv_b + row_b,
                                    4 * hd * pairs * B * H),
            "flash_attention_bwd_dq": (3 * q_b + 2 * kv_b + 2 * row_b,
                                       6 * hd * pairs * B * H),
            "flash_attention_bwd_dkv": (2 * q_b + 4 * kv_b + 2 * row_b,
                                        8 * hd * pairs * B * H)}


def attention_case(label, kind, *, B, H, KV, S, hd, dtype, Sk=None,
                   window=None, mask_seq=None, dev, gen) -> dict:
    """The three attention kernels at one shape (S queries, Sk keys,
    default S), against their plain versions (the backward ones on the
    kernel forward's lse and delta, so each kernel is checked alone);
    (B, S, H, hd) tensors passed as transposed views, as the model passes
    them. Library yardstick: ``scaled_dot_product_attention`` with the same
    boolean mask, forward, and forward + backward less forward (one call
    computes dq, dk, dv), each the median of three CUDA-graph readings."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    cfg = FA.FlashConfig(kind, window=window, mask_seq=mask_seq)
    Sk = S if Sk is None else Sk
    mk = lambda n, L: torch.randn(B, L, n, hd, generator=gen,  # noqa: E731
                                  device=dev).to(dtype).transpose(1, 2)
    q, k, v, do = mk(H, S), mk(KV, Sk), mk(KV, Sk), mk(H, S)
    out, lse = FA.flash_attention_fwd(q, k, v, cfg)
    delta = FA.attention_delta(out, do)
    dq = FA.flash_attention_bwd_dq(q, k, v, do, lse, delta, cfg)
    dk, dv = FA.flash_attention_bwd_dkv(q, k, v, do, lse, delta, cfg)
    torch.cuda.synchronize()
    calls = {
        "flash_attention_fwd": (
            lambda i: FA.flash_attention_fwd(q, k, v, cfg),
            lambda i: FA.flash_attention_fwd_ref(q, k, v, cfg)),
        "flash_attention_bwd_dq": (
            lambda i: FA.flash_attention_bwd_dq(q, k, v, do, lse, delta, cfg),
            lambda i: FA._bwd_dq_ref(q, k, v, do, lse, delta, cfg)),
        "flash_attention_bwd_dkv": (
            lambda i: FA.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                 cfg),
            lambda i: FA._bwd_dkv_ref(q, k, v, do, lse, delta, cfg)),
    }
    got = {"flash_attention_fwd": (out, lse), "flash_attention_bwd_dq": dq,
           "flash_attention_bwd_dkv": (dk, dv)}
    mask = FA.keep_mask(cfg, S, Sk, dev)
    gqa = {"enable_gqa": True} if H != KV else {}
    # GQA in one call needs torch >= 2.5 (enable_gqa); else no yardstick
    lib_fwd = lib_bwd = lib_spread = None
    if not gqa or tuple(int(x) for x in
                        torch.__version__.split(".")[:2]) >= (2, 5):
        # timed as the kernels are (CUDA-graph replay, device time only);
        # the backward is forward + backward less forward, both captured
        qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))

        def sdpa_fwd_bwd(i):
            o = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask,
                                               **gqa)
            torch.autograd.grad(o, (qg, kg, vg), do)
        fwd_t = device_trials(lambda i: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, **gqa), 1, calls=3, reps=3, trials=3)
        both_t = device_trials(sdpa_fwd_bwd, 1, calls=3, reps=3, trials=3)
        lib_fwd, both = statistics.median(fwd_t), statistics.median(both_t)
        lib_bwd = both - lib_fwd
        lib_spread = {"fwd": [min(fwd_t), max(fwd_t)],
                      "fwd_bwd": [min(both_t), max(both_t)]}
    work = attention_work(cfg, B, H, KV, S, Sk, hd, q.element_size())
    peak = PEAK_BF16 if dtype == torch.bfloat16 else max(PEAK_FP32,
                                                         PEAK_FP32_TC)
    rows = {}
    for name, (kern, ref) in calls.items():
        err = compare(f"{name} {label}", got[name], ref(0),
                      bf16_rounding=True)
        ms = device_ms(kern, 1, calls=3, reps=3)
        plain_ms = device_ms(ref, 1, calls=2, reps=2)
        nbytes, flops = work[name]
        bound_ms, by = bound(nbytes, flops, peak)
        lib = lib_fwd if name == "flash_attention_fwd" else lib_bwd
        rows[name] = {"case": label, "max_abs_err": err, "ms": ms,
                      "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "bound_by": by, "library_ms": lib,
                      "library_spread_ms": lib_spread, "bytes": nbytes,
                      "flops": flops}
        say(f"[kernels] {name} {label}: max|err| {err:.2e} | kernel "
            f"{ms:.4f} ms device | bound {bound_ms:.4f} ms ({by}; "
            f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP) | plain "
            f"{plain_ms:.3f} ms | library (sdpa, bool mask"
            f"{', fwd' if name.endswith('fwd') else ', whole backward'}) "
            f"{'none' if lib is None else f'{lib:.4f} ms'}"
            + ("" if lib_spread is None else
               f" (3 readings: fwd {lib_spread['fwd'][0]:.4f}-"
               f"{lib_spread['fwd'][1]:.4f}, fwd+bwd "
               f"{lib_spread['fwd_bwd'][0]:.4f}-"
               f"{lib_spread['fwd_bwd'][1]:.4f} ms)"))
    return rows


def phase_attention(dev) -> dict:
    """Attention kernels at the training path's shapes: the DB step's
    db_concat stream (8 x 1024 rows, mask_seq 512) and the e2e step's causal
    512, in bf16 (the path's policy) and fp32, one GQA G=4 window case at hd
    128, the two calls of an olmo-1b two-pass layer (hd 128), the DiT-S/2
    layer's ``full`` attention and Huginn's causal and db_concat ones (fp32,
    hd 64), ViT's (fp32, hd 32) and the MDM's (fp32, hd 64) ``full`` ones.
    The first case of each kernel is its main case."""
    gen = torch.Generator(device=dev).manual_seed(2)
    rows = {n: [] for n in ATTN}
    bf16, f32 = torch.bfloat16, torch.float32
    # ``pr16``: the bf16 (dq, dk/dv) ms of the CUDA-core kernels that the
    # tensor-core ones replaced, as PERF.md records them from an earlier
    # run of this script (NVIDIA H100 80GB HBM3, 700.00 W); ``cuda_core_fwd``
    # and ``cuda_core_bwd``: the fp32 forward's and (dq, dk/dv)'s on the CUDA
    # cores, likewise. Printed beside this run's times for comparison; not
    # measured here, so kept out of the rows and the kernels line.
    cases = [
        ("(e) db_concat B=8 H=32 S=2x512 hd=64 bf16 (DB step)", "db_concat",
         dict(B=8, H=32, KV=32, S=1024, hd=64, dtype=bf16, mask_seq=512,
              pr16=(1.5059, 1.9363))),
        ("(e) db_concat B=8 H=32 S=2x512 hd=64 fp32", "db_concat",
         dict(B=8, H=32, KV=32, S=1024, hd=64, dtype=f32, mask_seq=512)),
        ("(f) causal B=8 H=32 S=512 hd=64 bf16 (e2e step)", "causal",
         dict(B=8, H=32, KV=32, S=512, hd=64, dtype=bf16,
              pr16=(0.7224, 0.8770))),
        ("(f) causal B=8 H=32 S=512 hd=64 fp32", "causal",
         dict(B=8, H=32, KV=32, S=512, hd=64, dtype=f32)),
        # ragged: 16 key tiles, the last one 40 keys long
        ("(f) causal B=8 H=32 S=1000 hd=64 bf16 (ragged)", "causal",
         dict(B=8, H=32, KV=32, S=1000, hd=64, dtype=bf16,
              pr16=(2.4825, 3.0347))),
        ("(g) window=256 GQA H=32 KV=8 S=1024 hd=128 bf16", "window",
         dict(B=4, H=32, KV=8, S=1024, hd=128, dtype=bf16, window=256,
              pr16=(1.5950, 2.0039))),
        ("(g) window=256 GQA H=32 KV=8 S=1024 hd=128 fp32", "window",
         dict(B=4, H=32, KV=8, S=1024, hd=128, dtype=f32, window=256)),
        # the two calls of an olmo-1b two-pass layer (phase 8)
        ("(h) causal B=8 H=16 S=512 hd=128 bf16 (two-pass clean stream)",
         "causal", dict(B=8, H=16, KV=16, S=512, hd=128, dtype=bf16,
                        pr16=(1.0059, 1.0849))),
        ("(h) two_pass B=8 H=16 Sq=512 Sk=2x512 hd=128 bf16 (two-pass "
         "noisy stream)", "two_pass",
         dict(B=8, H=16, KV=16, S=512, Sk=1024, hd=128, dtype=bf16,
              mask_seq=512, pr16=(1.1898, 1.3607))),
        # the DiT-S/2 step's layers (phase 10) and Huginn's (phase 11)
        ("(m) full B=256 H=6 S=256 hd=64 fp32 (DiT-S/2 step)", "full",
         dict(B=256, H=6, KV=6, S=256, hd=64, dtype=f32,
              cuda_core_fwd=1.3070, cuda_core_bwd=(1.5936, 2.1385))),
        ("(n) causal B=8 H=8 S=512 hd=64 fp32 (Huginn prelude, coda, "
         "baseline core)", "causal",
         dict(B=8, H=8, KV=8, S=512, hd=64, dtype=f32)),
        ("(n) db_concat B=8 H=8 S=2x512 hd=64 fp32 (Huginn db core)",
         "db_concat", dict(B=8, H=8, KV=8, S=1024, hd=64, dtype=f32,
                           mask_seq=512)),
        # ViT's layers (phase 12: hd 32, 66 tokens, so the second 64-row
        # tile of each side holds 2 rows) and the MDM's (phase 13)
        ("(p) full B=128 H=4 S=66 hd=32 fp32 (ViT step)", "full",
         dict(B=128, H=4, KV=4, S=66, hd=32, dtype=f32)),
        ("(q) full B=64 H=12 S=256 hd=64 fp32 (MDM step)", "full",
         dict(B=64, H=12, KV=12, S=256, hd=64, dtype=f32)),
    ]
    for label, kind, kw in cases:
        pr16 = kw.pop("pr16", None)
        cuda_core_fwd = kw.pop("cuda_core_fwd", None)
        cuda_core_bwd = kw.pop("cuda_core_bwd", None)
        got = attention_case(label, kind, dev=dev, gen=gen, **kw)
        for name, row in got.items():
            rows[name].append(row)
        if pr16 is not None:
            say(f"[kernels] {label}: dq / dk/dv {got[ATTN[1]]['ms']:.4f} / "
                f"{got[ATTN[2]]['ms']:.4f} ms this run; PR 16's CUDA-core "
                f"kernels {pr16[0]:.4f} / {pr16[1]:.4f} ms (recorded in "
                "PERF.md, NVIDIA H100 80GB HBM3, 700.00 W; not this run)")
        if cuda_core_fwd is not None:
            say(f"[kernels] {label}: forward {got[ATTN[0]]['ms']:.4f} ms "
                f"this run; the CUDA-core fp32 forward it replaced "
                f"{cuda_core_fwd:.4f} ms (recorded in PERF.md, NVIDIA H100 "
                "80GB HBM3, 700.00 W; not this run)")
        if cuda_core_bwd is not None:
            dq_ms, dkv_ms = got[ATTN[1]]["ms"], got[ATTN[2]]["ms"]
            lib = got[ATTN[1]]["library_ms"]
            say(f"[kernels] {label}: dq / dk/dv {dq_ms:.4f} / {dkv_ms:.4f} "
                f"ms this run; the CUDA-core fp32 kernels they replaced "
                f"{cuda_core_bwd[0]:.4f} / {cuda_core_bwd[1]:.4f} ms "
                "(recorded in PERF.md, NVIDIA H100 80GB HBM3, 700.00 W; not "
                f"this run); dq + dk/dv {dq_ms + dkv_ms:.4f} ms against "
                "SDPA's whole backward "
                f"{'none' if lib is None else f'{lib:.4f} ms'} this run")
    return rows


def phase_kernels(dev) -> dict:
    from repro_torch.kernels import flash_decode as FD
    gen = torch.Generator(device=dev).manual_seed(1)
    ragged = [0, 128, 200, 333, 416, 480, 511, 544]
    starts = [0, 64, 128, 192, 256, 320, 384, 448]
    rows = {"flash_decode": [], "flash_prefill": [], "gate_residual": []}
    bf16, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    # (a) decode at stablelm widths: the probe's fp32 q, the commit's bf16 q
    rows["flash_decode"].append(paged_case(
        "(a) decode B=8 KV=32 G=1 hd=64 bf16 pages, fp32 q (probe)",
        "flash_decode", KV=32, G=1, hd=64, page_dtype=bf16, q_dtype=f32,
        window=None, lengths=ragged, dev=dev, gen=gen,
        prior=PRIOR_DECODE_A_MS))
    rows["flash_decode"].append(paged_case(
        "(a) decode B=8 KV=32 G=1 hd=64 bf16 pages, bf16 q (commit)",
        "flash_decode", KV=32, G=1, hd=64, page_dtype=bf16, q_dtype=bf16,
        window=None, lengths=ragged, dev=dev, gen=gen))
    # (b) GQA + window + int8 at h2o-danube3 widths
    rows["flash_decode"].append(paged_case(
        "(b) decode KV=8 G=4 hd=120 window=64 int8 pages",
        "flash_decode", KV=8, G=4, hd=120, page_dtype=i8, q_dtype=bf16,
        window=64, lengths=ragged, dev=dev, gen=gen))
    rows["flash_prefill"].append(paged_case(
        "(b) prefill C=64 KV=8 G=4 hd=120 window=64 int8 pages",
        "flash_prefill", KV=8, G=4, hd=120, page_dtype=i8, q_dtype=bf16,
        window=64, lengths=starts, dev=dev, gen=gen, C=CHUNK))
    # (o) decode split across blocks where the pairs do not fill the SMs:
    # KV=8 G=4 hd 128 (llama-3.2-vision-11b, phi3.5-moe, grok-1) at phase
    # 4's lengths x8, against one block a pair
    long = [8 * n for n in ragged]
    split = dict(KV=8, G=4, hd=128, page_dtype=bf16, q_dtype=bf16,
                 window=None, lengths=long, cap=8 * (PROMPT + MAX_NEW),
                 dev=dev)
    row = paged_case("(o) decode B=8 KV=8 G=4 hd=128 bf16 pages, lengths "
                     "to 4352 (split)", "flash_decode", gen=gen, **split)
    heuristic = FD.decode_splits
    FD.decode_splits = lambda *args: 1
    try:
        one = paged_case("(o) the same, one block a pair", "flash_decode",
                         gen=torch.Generator(device=dev).manual_seed(1),
                         **split)
    finally:
        FD.decode_splits = heuristic
    row["one_block_ms"] = one["ms"]
    rows["flash_decode"].append(row)
    say(f"[kernels] (o) decode split: {row['ms']:.4f} ms against one block "
        f"a pair {one['ms']:.4f} ms, this run")
    # (c) prefill at stablelm widths (commit_prompt_chunk: bf16 q)
    rows["flash_prefill"].insert(0, paged_case(
        "(c) prefill C=64 B=8 KV=32 G=1 hd=64 bf16 pages, bf16 q",
        "flash_prefill", KV=32, G=1, hd=64, page_dtype=bf16, q_dtype=bf16,
        window=None, lengths=starts, dev=dev, gen=gen, C=CHUNK,
        prior=PRIOR_PREFILL_C_MS))
    # (c) through the 3xTF32 route: the fp32 policy's prefill (fp32 q and
    # pages) and the fp32_kvint8 policy's (fp32 q, int8 pages)
    rows["flash_prefill"].append(paged_case(
        "(c) prefill C=64 B=8 KV=32 G=1 hd=64 fp32 pages, fp32 q",
        "flash_prefill", KV=32, G=1, hd=64, page_dtype=f32, q_dtype=f32,
        window=None, lengths=starts, dev=dev, gen=gen, C=CHUNK,
        prior=PRIOR_PREFILL_C_FP32_MS))
    rows["flash_prefill"].append(paged_case(
        "(c) prefill C=64 B=8 KV=32 G=1 hd=64 int8 pages, fp32 q",
        "flash_prefill", KV=32, G=1, hd=64, page_dtype=i8, q_dtype=f32,
        window=None, lengths=starts, dev=dev, gen=gen, C=CHUNK))
    # (d) gate-residual: the probe's (8,1,2048) fp32, a (8,64,2048) bf16
    rows["gate_residual"].append(gate_case(
        "(d) gate_residual (8,1,2048) fp32, fp32 gate slice", (8, 1, 2048),
        f32, f32, dev, gen, prior=0.0017))
    rows["gate_residual"].append(gate_case(
        "(d) gate_residual (8,64,2048) bf16, bf16 gate slice", (8, 64, 2048),
        bf16, bf16, dev, gen))
    # (m) the DiT-S/2 layer's two σ-gates (phase 10: batch 256, d 384)
    rows["gate_residual"].append(gate_case(
        "(m) gate_residual (256,256,384) fp32, fp32 gate slice (DiT-S/2)",
        (256, 256, 384), f32, f32, dev, gen, prior=0.1013))
    # (q) the MDM layer's two σ-gates (phase 13: batch 64 x 256, d 768)
    rows["gate_residual"].append(gate_case(
        "(q) gate_residual (64,256,768) fp32, fp32 gate slice (MDM)",
        (64, 256, 768), f32, f32, dev, gen))
    return rows


# ---------------------------------------------------------------------------
# launch counts a path must show
# ---------------------------------------------------------------------------

def expected_counts(**nonzero) -> dict:
    """Every kernel's count: the named ones, the rest 0."""
    from repro_torch import kernels as K
    unknown = set(nonzero) - set(K.WRAPPERS)
    if unknown:
        raise SmokeError(f"no kernel wrapper named {sorted(unknown)}")
    return {**{n: 0 for n in K.WRAPPERS}, **nonzero}


def check_counts(tag: str, counts: dict, expect: dict) -> None:
    if counts != expect:
        raise SmokeError(f"{tag}: launch counts {counts} != path arithmetic "
                         f"{expect}")


def db_step_counts(dbm, size: int) -> dict:
    """Launches of one DB step over a block of ``size`` layers. concat: one
    attention forward, dq and dk/dv per layer (the clean||noisy stream
    carries a cond_mask, so no AdaLN kernel). two_pass: per layer a causal
    clean call and a two_pass noisy call, whose backward runs for all but
    the last layer's clean call (its output reaches no loss); on the noisy
    stream two gate-residual calls and, for a non-parametric LayerNorm, two
    ln-modulate calls, forward and backward. l2: one EDM loss forward and
    backward."""
    l2 = int(dbm.db.loss == "l2")
    if dbm.db.causal_mode == "concat":
        return expected_counts(**{n: size for n in ATTN}, edm_loss_fwd=l2,
                               edm_loss_bwd=l2)
    ln = 2 * size if dbm.cfg.norm == "nonparam_ln" else 0
    return expected_counts(
        flash_attention_fwd=2 * size, flash_attention_bwd_dq=2 * size - 1,
        flash_attention_bwd_dkv=2 * size - 1, gate_residual=2 * size,
        gate_residual_bwd=2 * size, ln_modulate_fwd=ln, ln_modulate_bwd=ln,
        edm_loss_fwd=l2, edm_loss_bwd=l2)


def add_counts(total: dict, counts: dict) -> None:
    for n, c in counts.items():
        total[n] = total.get(n, 0) + c


# ---------------------------------------------------------------------------
# 4. full-width serve, 5. fp32 cross-check
# ---------------------------------------------------------------------------

def build_model(dev):
    from repro_torch.configs import DEFAULT_DB, get_config
    from repro_torch.core.blocks import DiffusionBlocksModel
    cfg = get_config(ARCH)
    dbm = DiffusionBlocksModel(cfg, DEFAULT_DB)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = dbm.init(gen)
    # AdaLN heads are zero at init (identity modulation, gates of 1):
    # randomise them so the σ conditioning and the gate kernel do real work
    ad = params["layers"]["adaln"]
    for k in ("w", "b"):
        ad[k].normal_(0.0, 0.02, generator=gen)
    return cfg, dbm, params, gen


def prompts_np(vocab: int, seed: int = 0):
    import numpy as np
    rs = np.random.RandomState(seed)
    prompts = rs.randint(0, vocab, size=(BATCH, PROMPT))
    plens = rs.randint(PROMPT // 4, PROMPT + 1, size=BATCH)
    plens[0], plens[-1] = PROMPT // 4, PROMPT
    return prompts, plens


def phase_serve(dev) -> dict:
    from repro_torch import kernels as K
    from repro_torch.launch.serve import get_engine
    from repro_torch.nn import cache as KVC
    t0 = time.perf_counter()
    cfg, dbm, params, gen = build_model(dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for _, p in _leaves(params))
    say(f"[serve] {cfg.name}: {cfg.n_layers} layers d={cfg.d_model} "
        f"heads={cfg.n_heads} hd={cfg.head_dim} ff={cfg.d_ff} "
        f"vocab={cfg.vocab_size}, {dbm.num_blocks} blocks {dbm.ranges}; "
        f"{n_params / 1e9:.3f} B params fp32 made in "
        f"{time.perf_counter() - t0:.1f} s")
    prompts, plens = prompts_np(cfg.vocab_size)
    eng = get_engine(dbm, precision="bf16", chunk_size=CHUNK)
    # warm-up at the same shapes, 2 tokens (cuBLAS heuristics, allocator)
    eng.generate(params, prompts, 2, prompt_lengths=plens, generator=gen)
    eng.last_kv = None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    out = eng.generate(params, prompts, MAX_NEW, prompt_lengths=plens,
                       generator=gen)
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    clocks = gpu_query("clocks.sm,power.draw,power.limit,temperature.gpu")
    tim = eng.last_timing
    gen_tok = _generated(out, plens)
    n_tok = BATCH * MAX_NEW
    pool_bytes = KVC.cache_bytes(eng.last_kv)
    L = cfg.n_layers
    expect = expected_counts(flash_decode=MAX_NEW * 2 * L,
                             gate_residual=MAX_NEW * 2 * L,
                             flash_prefill=-(-PROMPT // CHUNK) * L)
    decode_ms = tim["total_ms"] - tim["prefill_ms"]
    say(f"[serve] bf16, greedy, {BATCH} requests, prompts padded to {PROMPT} "
        f"(lengths {plens.tolist()}), chunk {CHUNK}, {MAX_NEW} new tokens")
    say(f"[serve] wall {wall:.3f} s | {n_tok / wall:.1f} tok/s | ttft "
        f"{tim['ttft_ms']:.1f} ms (prefill {tim['prefill_ms']:.1f} ms) | "
        f"decode {decode_ms / MAX_NEW:.2f} ms/step | peak memory "
        f"{peak / 2**30:.2f} GiB | cache {pool_bytes / 2**20:.1f} MiB | "
        f"nvidia-smi (sm MHz, W, limit, C): {clocks}")
    lb = serve_bounds(dbm, params, plens)
    say(f"[serve] bound from the shapes: prefill {lb['prefill_ms']:.2f} ms "
        f"({lb['prefill_by']}), decode {lb['decode_step_ms']:.2f} ms/step "
        f"({lb['decode_step_by']}); measured prefill "
        f"{tim['prefill_ms']:.1f} ms, decode {decode_ms / MAX_NEW:.2f} "
        f"ms/step")
    say(f"[serve] launches {counts} (expected {expect})")
    if counts != expect:
        raise SmokeError(f"launch counts {counts} != path arithmetic "
                         f"{expect}")
    if not ((gen_tok >= 0) & (gen_tok < cfg.vocab_size)).all():
        raise SmokeError("generated token outside the vocabulary")
    for name in ("k", "v"):
        if not torch.isfinite(getattr(eng.last_kv, name)[:, 1:].float()
                              ).all():
            raise SmokeError(f"non-finite {name} pages after serving")
    say(f"[serve] first request's generated tokens: "
        f"{gen_tok[0, :12].tolist()} ...")
    eng.last_kv = None
    return {"counts": counts, "wall_s": wall, "tok_s": n_tok / wall,
            "ttft_ms": tim["ttft_ms"], "prefill_ms": tim["prefill_ms"],
            "decode_ms_per_step": decode_ms / MAX_NEW,
            "peak_mem_bytes": peak, "cache_bytes": pool_bytes,
            "clocks": clocks, "bounds": lb, "model": (dbm, params, gen)}


def device_busy(fn, top: int = 6, host: bool = False):
    """Run fn() under torch.profiler: (wall ms under the profiler, summed
    device ms, the ``top`` kernels by device time as (ms, count, name)).
    One stream, so the sum is the device's busy time. Only the card's
    activity is traced unless ``host``: tracing the host's ops too slows
    the host, and so lengthens the wall that a busy share divides by. The
    raw events are summed as they come: ``key_averages`` would first build
    a Python event tree over all of them, minutes for a run of a million
    kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA] + (
        [ProfilerActivity.CPU] if host else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        ms, n = by_name.get(e.name(), (0.0, 0))
        by_name[e.name()] = (ms + e.duration_ns() / 1e6, n + 1)
    rows = sorted(((ms, n, name) for name, (ms, n) in by_name.items()),
                  reverse=True)
    return wall, sum(r[0] for r in rows), rows[:top]


def phase_profile(dev, model) -> dict:
    """Where a full-width bf16 step's time goes: device busy share of the
    prefill (8 chunks) and of 4 decode steps, and the top kernels. The
    decode is measured again with the host's ops traced too, as every
    busy share before PR 24 was, to relate the two denominators."""
    from repro_torch.launch.serve import get_engine
    from repro_torch.nn import cache as KVC
    dbm, params, gen = model
    prompts, plens = prompts_np(dbm.cfg.vocab_size)
    eng = get_engine(dbm, precision="bf16", chunk_size=CHUNK)
    pps = KVC.pages_for(PROMPT + MAX_NEW, PSZ)
    kv = dbm.model.init_paged_cache(BATCH, 1 + BATCH * pps, PSZ, eng.pol,
                                    device=dev)
    table = KVC.identity_page_table(BATCH, pps, device=dev)
    buf = torch.as_tensor(prompts, device=dev)
    pl = torch.as_tensor(plens, dtype=torch.int32, device=dev)
    state = {"lens": torch.zeros(BATCH, dtype=torch.int32, device=dev)}

    def prefill():
        _, state["lens"] = eng.run_prefill(params, kv, table, state["lens"],
                                           buf, pl)

    def decode():
        eng.decode(params, kv, table, state["lens"], pl + MAX_NEW, 4,
                   generator=gen)

    out = {}
    for name, fn, host in (("prefill, 8 chunks", prefill, False),
                           ("decode, 4 steps", decode, False),
                           ("decode, 4 steps, host traced", decode, True)):
        wall, busy, top = device_busy(fn, host=host)
        out[name] = {"wall_ms": wall, "device_ms": busy}
        if busy == 0:
            say(f"[profile] {name}: device time not measured (the profiler "
                "saw no kernels)")
            continue
        say(f"[profile] {name}: wall {wall:.1f} ms under the profiler, "
            f"device busy {busy:.1f} ms ({100 * busy / wall:.1f}%)")
        for ms, count, key in top:
            say(f"[profile]   {ms:8.2f} ms  x{count:<5d} {key[:90]}")
    return out


def serve_bounds(dbm, params, plens) -> dict:
    """Least device time of phase 4's run, from its shapes (larger of bytes
    over 3.35 TB/s and flops over the peak of their type). Prefill: each
    chunk reads the bf16 attention+MLP weights once and computes all
    B*C padded tokens (bf16 tensor-core flops). A decode step: 4 probes
    read every layer weight in fp32 (AdaLN heads included) plus the fp32
    head and σ-MLP; the commit reads the bf16 attention+MLP copy; both
    read every slot's committed K/V per layer (bf16); fp32 flops."""
    cfg, B, L = dbm.cfg, BATCH, dbm.cfg.n_layers
    layer_all = sum(t.numel() for _, t in _leaves(params["layers"]))
    commit = sum(t.numel() for p, t in _leaves(params["layers"])
                 if p[0] in ("attn", "mlp"))
    head = params["head"]["w"].numel()
    cond = sum(t.numel() for _, t in _leaves(params["cond"]))
    kv_row = 2 * cfg.n_kv_heads * cfg.head_dim * 2
    n_chunks = -(-PROMPT // CHUNK)
    pre = bound(n_chunks * commit * 2 + L * B * PROMPT * kv_row,
                2 * commit * B * n_chunks * CHUNK, PEAK_BF16)
    mean_len = float(sum(plens)) / B + (MAX_NEW - 1) / 2
    attn_flops = 2 * L * B * mean_len * cfg.n_heads * cfg.head_dim * 4
    dec = bound(layer_all * 4 + dbm.num_blocks * cond * 4 + head * 4
                + commit * 2 + 2 * L * B * mean_len * kv_row,
                2 * B * (layer_all + head + commit) + attn_flops, PEAK_FP32)
    return {"prefill_ms": pre[0], "prefill_by": pre[1],
            "decode_step_ms": dec[0], "decode_step_by": dec[1]}


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _generated(out, plens):
    import numpy as np
    return torch.from_numpy(np.stack([out[b, p:p + MAX_NEW].numpy()
                                      for b, p in enumerate(plens)]))


def fp32_prefill(dev, model, impl: str, profiled: bool = False):
    """Phase 4's prompts prefilled into a fresh pool by the fp32 policy's
    engine through ``impl``: (kv, table, lengths, timing); with
    ``profiled``, timing holds the prefill's device busy ms and the ms of
    the paged-attention kernels in it (``rtk::``, the prefill kernels of any
    version of the port) under torch.profiler, else None."""
    from repro_torch.launch.serve import get_engine
    from repro_torch.nn import cache as KVC
    dbm, params, _ = model
    prompts, plens = prompts_np(dbm.cfg.vocab_size)
    eng = get_engine(dbm, precision="fp32", chunk_size=CHUNK, impl=impl)
    pps = KVC.pages_for(PROMPT + MAX_NEW, PSZ)
    kv = dbm.model.init_paged_cache(BATCH, 1 + BATCH * pps, PSZ, eng.pol,
                                    device=dev)
    table = KVC.identity_page_table(BATCH, pps, device=dev)
    state = {"lens": torch.zeros(BATCH, dtype=torch.int32, device=dev)}

    def run():
        _, state["lens"] = eng.run_prefill(
            params, kv, table, state["lens"], torch.as_tensor(prompts,
                                                              device=dev),
            torch.as_tensor(plens, dtype=torch.int32, device=dev))

    timing = None
    if profiled:
        wall, busy, rows = device_busy(run, top=None)
        timing = {"wall_ms": wall, "device_ms": busy,
                  "attention_ms": sum(ms for ms, _, key in rows
                                      if "rtk::" in key),
                  "attention_launches": sum(n for _, n, key in rows
                                            if "rtk::" in key)}
    else:
        run()
    return kv, table, state["lens"], timing


def phase_crosscheck(dev, model) -> dict:
    """The fp32 policy's prefill through the kernels (the 3xTF32 prefill
    route, timed under the profiler after a warm-up) and through the plain
    versions (``impl="ref"``), committed pools (pages 1 and up) within
    1e-3; then one fp32 serve step from the kernels' pool through both,
    logits within 1e-3."""
    from repro_torch import kernels as K
    dbm, params, gen = model
    fp32_prefill(dev, model, "kernels")                 # warm-up
    K.reset_launch_counts()
    kv, table, lengths, tim = fp32_prefill(dev, model, "kernels",
                                           profiled=True)
    counts = K.launch_counts()
    expect = expected_counts(flash_prefill=-(-PROMPT // CHUNK)
                             * dbm.cfg.n_layers)
    check_counts("fp32 prefill", counts, expect)
    kv_pre, _, lens_pre, _ = fp32_prefill(dev, model, "ref")
    # pages 1 and up: a chunk's padding entries write the trash page 0
    pre_rel = max(((getattr(kv, n)[:, 1:] - getattr(kv_pre, n)[:, 1:]).abs()
                   .max() / getattr(kv_pre, n)[:, 1:].abs().max()).item()
                  for n in ("k", "v"))
    say(f"[crosscheck] fp32 prefill ({-(-PROMPT // CHUNK)} chunks, "
        f"{counts['flash_prefill']} "
        f"prefill_tf32 launches), kernels vs plain versions: committed pool "
        f"rel max|diff| {pre_rel:.2e} (limit 1e-3) | device busy "
        f"{tim['device_ms']:.2f} ms of {tim['wall_ms']:.1f} ms under the "
        f"profiler, the prefill attention kernel {tim['attention_ms']:.2f} "
        f"ms in {tim['attention_launches']} launches")
    if not (pre_rel <= 1e-3 and math.isfinite(pre_rel)) or not torch.equal(
            lengths, lens_pre):
        raise SmokeError(f"fp32 prefill cross-check: pools differ by "
                         f"{pre_rel:.2e}")
    del kv_pre
    z0 = dbm.db.sigma_max * torch.randn((BATCH, 1, dbm.cfg.d_model),
                                        generator=gen, device=dev)
    kv_ref = kv.clone()
    out = {}
    for impl, pool in (("kernels", kv), ("ref", kv_ref)):
        tok, pool, _, logits = dbm.serve_step_paged(
            params, pool, table, lengths, z0=z0, precision="fp32", impl=impl,
            return_logits=True)
        out[impl] = (tok, pool, logits)
    lk, lr = out["kernels"][2], out["ref"][2]
    rel = ((lk - lr).abs().max() / lr.abs().max()).item()
    pool_rel = max(((getattr(out["kernels"][1], n)
                     - getattr(out["ref"][1], n)).abs().max()
                    / getattr(out["ref"][1], n).abs().max()).item()
                   for n in ("k", "v"))
    same = (out["kernels"][0] == out["ref"][0]).float().mean().item()
    say(f"[crosscheck] fp32 serve step, kernels vs plain versions: logits "
        f"rel max|diff| {rel:.2e} (limit 1e-3) | committed pool rel "
        f"max|diff| {pool_rel:.2e} | greedy tokens equal {same:.3f}")
    if not (rel <= 1e-3 and math.isfinite(rel)):
        raise SmokeError(f"fp32 cross-check: logits differ by {rel:.2e}")
    return {"logits_rel": rel, "pool_rel": pool_rel,
            "prefill_pool_rel": pre_rel, "prefill": tim}


def prefill_ref_bf16_p(q, k_pages, v_pages, page_table, lengths, *,
                       window=None, k_scale=None, v_scale=None):
    """The bf16 cross-check's control: ``flash_prefill_ref`` with P.V taken
    on bf16 P alone, as a tensor-core prefill that dropped P's lo term
    would take it (the row sum l keeps fp32 p)."""
    from repro_torch.kernels import flash_prefill as FP
    B, C, KV, G, hd = q.shape
    kk, vv = FP._gather_pages(k_pages, v_pages, page_table, k_scale, v_scale)
    s = torch.einsum("bckgd,bksd->bkgcs", q.float(), kk) / hd ** 0.5
    idx = torch.arange(kk.shape[2], device=q.device)
    qabs = lengths.long()[:, None] + torch.arange(C, device=q.device)
    valid = idx[None, None, :] <= qabs[:, :, None]
    if window is not None:
        valid &= idx[None, None, :] > qabs[:, :, None] - window
    valid = valid[:, None, None]
    s = torch.where(valid, s, torch.full_like(s, FP.NEG_INF))
    p = torch.where(valid, torch.exp(s - s.amax(-1, keepdim=True)),
                    torch.zeros_like(s))
    l = torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    out = torch.einsum("bkgcs,bksd->bkgcd", p.bfloat16().float(), vv) / l
    return out.permute(0, 3, 1, 2, 4)


def bf16_serve_run(dev, model, impl: str, seed: int, prefill=None):
    """Prefill seed's prompts into a fresh bf16 pool through ``impl`` (with
    ``prefill`` in place of the paged prefill attention, if given), then
    one greedy serve step from seed's z: (tokens, logits fp32, the live
    K and V pages after the prefill of the second unit of each block: the
    first pages a prefill output reaches, since each block's first unit
    starts from the embedding)."""
    from repro_torch.launch.serve import get_engine
    from repro_torch.nn import cache as KVC
    dbm, params, _ = model
    prompts, plens = prompts_np(dbm.cfg.vocab_size, seed)
    pps = KVC.pages_for(PROMPT + MAX_NEW, PSZ)
    table = KVC.identity_page_table(BATCH, pps, device=dev)
    gen = torch.Generator(device=dev).manual_seed(100 + seed)
    z0 = dbm.db.sigma_max * torch.randn((BATCH, 1, dbm.cfg.d_model),
                                        generator=gen, device=dev)
    eng = get_engine(dbm, precision="bf16", chunk_size=CHUNK, impl=impl)
    kv = dbm.model.init_paged_cache(BATCH, 1 + BATCH * pps, PSZ, eng.pol,
                                    device=dev)
    plain = KVC.flash_prefill
    KVC.flash_prefill = prefill or plain
    try:
        kv, lengths = eng.run_prefill(
            params, kv, table,
            torch.zeros(BATCH, dtype=torch.int32, device=dev),
            torch.as_tensor(prompts, device=dev),
            torch.as_tensor(plens, dtype=torch.int32, device=dev))
    finally:
        KVC.flash_prefill = plain
    units = [start + 1 for start, size in dbm.ranges if size > 1]
    pages = [getattr(kv, n)[units, 1:].float() for n in ("k", "v")]
    tok, _, _, logits = dbm.serve_step_paged(
        params, kv, table, lengths, z0=z0, precision="bf16", impl=impl,
        return_logits=True)
    return tok, logits.float(), pages


def bf16_gap(run, ref) -> dict:
    """``run`` against ``ref``: logits max|diff| / max|ref|, the reached
    pages' mean|diff| / mean|ref| (the larger of K and V), greedy
    agreement."""
    return {
        "logits_rel": ((run[1] - ref[1]).abs().max()
                       / ref[1].abs().max()).item(),
        "pages_rel": max(((a - b).abs().mean() / b.abs().mean()).item()
                         for a, b in zip(run[2], ref[2])),
        "greedy_equal": (run[0] == ref[0]).float().mean().item()}


def phase_crosscheck_bf16(dev, model) -> dict:
    """The bf16 serving path from the prompts on, for each of
    BF16_CROSS_SEEDS (prompts and z), each run prefilling its own pool and
    taking one serve step from the same z:
    * the whole path, kernels vs plain versions (``impl="ref"``): logits
      max|diff| / max|ref| within BF16_LOGITS_LIMIT. bf16 rounds the
      activations between the layers, so this reads the model's bf16
      noise, in which a prefill fault moves the reading by less than 2x;
    * the tensor-core prefill alone: kernels vs kernels with the plain
      prefill, on the pages the prefill outputs first reach (the second
      unit of each block): mean|diff| / mean|ref| within BF16_PAGES_LIMIT.
    The control is the kernels with the plain prefill on bf16 P alone (a
    prefill that dropped P's lo term) against the plain prefill, seed 0.
    Each limit sits between the largest sound reading and the control's
    (both recorded in PERF.md), and the control must exceed it in this run
    too, or the check could not see that fault."""
    from repro_torch.kernels import flash_prefill as FP
    sound = []
    for seed in BF16_CROSS_SEEDS:
        ref = bf16_serve_run(dev, model, "ref", seed)
        got = bf16_serve_run(dev, model, "kernels", seed)
        base = bf16_serve_run(dev, model, "kernels", seed,
                              prefill=FP.flash_prefill_ref)
        whole, alone = bf16_gap(got, ref), bf16_gap(got, base)
        sound.append({"whole": whole, "prefill": alone})
        say(f"[crosscheck] bf16 prefill + serve step, seed {seed}: whole "
            f"path, kernels vs plain versions: logits max|diff| / max|ref| "
            f"{whole['logits_rel']:.3e}, greedy tokens equal "
            f"{whole['greedy_equal']:.3f} | tensor-core prefill vs plain "
            f"prefill: reached pages mean|diff| / mean|ref| "
            f"{alone['pages_rel']:.3e}, logits {alone['logits_rel']:.3e}")
        if seed == BF16_CROSS_SEEDS[0]:
            control = bf16_gap(bf16_serve_run(
                dev, model, "kernels", seed, prefill=prefill_ref_bf16_p),
                base)
            say(f"[crosscheck] bf16 control, seed {seed}: plain prefill "
                f"with bf16 P alone vs plain prefill: reached pages "
                f"{control['pages_rel']:.3e}, logits "
                f"{control['logits_rel']:.3e}, greedy tokens equal "
                f"{control['greedy_equal']:.3f}")
        del ref, got, base
    for what, part, key, limit in (
            ("whole path: logits", "whole", "logits_rel", BF16_LOGITS_LIMIT),
            ("prefill alone: reached pages", "prefill", "pages_rel",
             BF16_PAGES_LIMIT)):
        worst = max(g[part][key] for g in sound)
        say(f"[crosscheck] bf16 {what}, largest of {len(sound)} seeds "
            f"{worst:.3e} <= limit {limit:.2e} < control "
            f"{control[key]:.3e}")
        if not (worst <= limit and math.isfinite(worst)):
            raise SmokeError(f"bf16 cross-check: {what} {worst:.3e} past "
                             f"its limit {limit:.2e}")
        if not control[key] > limit:
            raise SmokeError(f"bf16 cross-check: the control's {what} "
                             f"{control[key]:.3e} is within the limit "
                             f"{limit:.2e}; the check cannot see that fault")
    return {"sound": sound, "control": control}


# ---------------------------------------------------------------------------
# 5b. continuous batching
# ---------------------------------------------------------------------------

def cb_queue(vocab: int):
    """The continuous phase's traffic: CB_REQUESTS ``MarkovLM`` prompts
    from seed 1, ragged over CB_MIN-CB_MAX tokens, the even ones opening
    with one shared CB_SHARED-token prefix (a system prompt). Returns
    (prompts, lm)."""
    import numpy as np
    from repro_torch.data import MarkovLM
    lm = MarkovLM(vocab_size=vocab, seed=7)
    rs = np.random.RandomState(1)
    shared = lm.sample(rs, 1, CB_SHARED)[0]
    prompts = []
    for i in range(CB_REQUESTS):
        if i % 2 == 0:
            n = rs.randint(CB_SHARED + 1, CB_MAX + 1)
            prompts.append(np.concatenate(
                [shared, lm.sample(rs, 1, n - CB_SHARED)[0]]))
        else:
            prompts.append(lm.sample(rs, 1, rs.randint(CB_MIN,
                                                       CB_MAX + 1))[0])
    return prompts, lm


def cb_batcher(dev, model, *, precision="bf16", impl="kernels", graphs=True,
               total_pages=None, seed=0, num_slots=CB_SLOTS):
    from repro_torch.launch.serve import ContinuousBatcher
    dbm, params, _ = model
    return ContinuousBatcher(
        dbm, params, num_slots=num_slots, page_size=PSZ, max_prompt=CB_MAX,
        max_len=CB_MAX + CB_NEW, seg_len=CB_SEG, chunk_size=CHUNK,
        precision=precision, impl=impl, prefix_cache=True,
        total_pages=total_pages, graphs=graphs,
        generator=torch.Generator(device=dev).manual_seed(seed))


def trie_holds(prefix) -> dict:
    """The page refs the prefix cache holds."""
    held = {}

    def walk(node):
        for child in node.children.values():
            held[child.page] = held.get(child.page, 0) + 1
            walk(child)
        for page, _ in node.tails:
            held[page] = held.get(page, 0) + 1

    for root in prefix.roots.values():
        walk(root)
    return held


def cb_drained(tag: str, cb, done, n: int) -> None:
    """Every request served in full, every page back: free pages and the
    prefix cache's own refs make the whole pool, and no slot holds one."""
    bad = [r.rid for r in done if len(r.out) != CB_NEW or r.error]
    if len(done) != n or bad:
        raise SmokeError(f"{tag}: {len(done)} of {n} requests finished, "
                         f"short or failed: {bad}")
    if cb.page_refs != trie_holds(cb.prefix) or (
            len(cb.free_pages) + len(cb.page_refs) != cb.total_pages - 1):
        raise SmokeError(f"{tag}: pages leaked: {len(cb.free_pages)} free, "
                         f"{len(cb.page_refs)} referenced of "
                         f"{cb.total_pages - 1}")


def cb_counts(dbm, cb) -> dict:
    """Launches of a continuous run from its counters: per segment step a
    paged decode per layer in the probes and in the commit, and the probes'
    two gate-residuals per layer; per chunk dispatch a prefill per layer."""
    L = dbm.cfg.n_layers
    return expected_counts(flash_decode=2 * L * cb.steps,
                           gate_residual=2 * L * cb.steps,
                           flash_prefill=L * cb.ingest_dispatches)


def cb_timed(cb) -> dict:
    """CUDA events around each decode segment and chunk dispatch of
    ``cb``, recorded on the stepping thread's stream. The wrappers reach
    ``cb`` through a weak reference: a bound method stored on the instance
    would make a cycle that keeps the batcher (its pool, graphs and their
    weight copy) allocated until a gc pass."""
    events = {"segment": [], "chunk": []}
    ref = weakref.ref(cb)

    def timed(kind, fn):
        def run(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(ref(), *args, **kw)
            end.record()
            events[kind].append((start, end))
            return out
        return run

    cls = type(cb)
    cb._decode_segment = timed("segment", cls._decode_segment)
    cb._chunk = timed("chunk", cls._chunk)
    return events


def cb_first_segments(dev, model, prompts, graphs: bool, n_seg: int,
                      profiled: bool = False):
    """Step a fresh batcher (graphs captured first) over the queue until
    ``n_seg`` segments ran, under the profiler if ``profiled``: (batcher,
    each request's tokens so far, the ms of its chunk dispatches,
    ``device_busy``'s result or None)."""
    cb = cb_batcher(dev, model, graphs=graphs)
    if graphs:
        cb.capture()
    events = cb_timed(cb)
    for p in prompts:
        cb.submit(p, CB_NEW)
    reqs = list(cb.queue)

    def steps():
        while cb.decode_dispatches < n_seg:
            cb.step()

    busy = device_busy(steps) if profiled else steps()
    torch.cuda.synchronize()
    return (cb, [list(r.out) for r in reqs],
            [s.elapsed_time(e) for s, e in events["chunk"]], busy)


def cb_logged(dev, model, prompts, precision, impl, n_seg=2):
    """Eager run of ``prompts`` until ``n_seg`` segments ran, recording the
    readout's logits: (batcher, logits of each step (num_slots, vocab),
    emitted tokens (segments, num_slots, seg_len))."""
    import numpy as np
    dbm = model[0]
    cb = cb_batcher(dev, model, precision=precision, impl=impl,
                    graphs=False)
    logits, emitted = [], []
    plain, collect, ref = dbm.model.logits, type(cb)._collect, weakref.ref(cb)

    def readout(p, h):
        logits.append(plain(p, h))
        return logits[-1]

    def collected(e):             # ``cb`` weakly: no cycle (see cb_timed)
        emitted.append(e.copy())
        collect(ref(), e)

    dbm.model.logits, cb._collect = readout, collected
    try:
        for p in prompts:
            cb.submit(p, CB_NEW)
        while cb.decode_dispatches < n_seg:
            cb.step()
    finally:
        del dbm.model.logits
    return cb, [x[:, 0].float() for x in logits], np.stack(emitted)


def phase_continuous(dev, model) -> dict:
    """Phase 5b: continuous batching of stablelm at full width (see the
    module docstring): the timed run, the graph against eager (its graphed
    run profiled), a pool under pressure, fp32 through the kernels against the
    plain versions, and bf16 / int8-pool agreement with fp32."""
    import numpy as np
    from repro_torch import kernels as K
    from repro_torch.launch.serve import _ragged_transition_accuracy
    dbm, params, _ = model
    t_phase = time.perf_counter()
    prompts, lm = cb_queue(dbm.cfg.vocab_size)
    cb = cb_batcher(dev, model)
    t0 = time.perf_counter()
    cb.capture()
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    events = cb_timed(cb)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    for p in prompts:
        cb.submit(p, CB_NEW)
    done = cb.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    clocks = gpu_query("clocks.sm,power.draw,power.limit,temperature.gpu")
    cb_drained("continuous", cb, done, CB_REQUESTS)
    check_counts("continuous", counts, cb_counts(dbm, cb))
    seg_ms = [s.elapsed_time(e) for s, e in events["segment"]]
    seg_step_ms = sum(seg_ms) / cb.steps
    chunk_ms = [s.elapsed_time(e) for s, e in events["chunk"]]
    # the share of the wall the card spent inside a dispatch (between its
    # events): an upper bound on the busy share, gaps inside a graph
    # included
    in_dispatch = (sum(seg_ms) + sum(chunk_ms)) / (wall * 1e3)
    ttft = sorted(r.ttft for r in done)
    n_tok = sum(len(r.out) for r in done)
    pool_mb = {k: round(v / 1e6, 1)
               for k, v in cb.kv_stats()["kv_bytes_by_dtype"].items()}
    rate = _ragged_transition_accuracy(
        lm, [np.concatenate([r.prompt, np.asarray(r.out)]) for r in done])
    say(f"[continuous] {CB_REQUESTS} requests on {CB_SLOTS} slots, bf16, "
        f"greedy, page {PSZ}, chunk {CHUNK}, seg_len {CB_SEG}, prefix cache "
        f"on, {CB_NEW} new tokens each; MarkovLM prompts {CB_MIN}-{CB_MAX} "
        f"tokens, half behind one {CB_SHARED}-token prefix; graph capture "
        f"{capture_s:.2f} s before the clock")
    say(f"[continuous] wall {wall:.3f} s | {n_tok / wall:.1f} tok/s | TTFT "
        f"median {statistics.median(ttft) * 1e3:.1f} ms, max "
        f"{ttft[-1] * 1e3:.1f} ms | decode {seg_step_ms:.3f} ms "
        f"per segment step ({len(seg_ms)} segments, median "
        f"{statistics.median(seg_ms) / CB_SEG:.3f}) | chunk dispatch "
        f"{statistics.median(chunk_ms):.2f} ms median, "
        f"{sum(chunk_ms) / len(chunk_ms):.2f} mean ({len(chunk_ms)}) | "
        f"inside a dispatch {100 * in_dispatch:.1f}% of the wall (CUDA "
        f"events) | nvidia-smi (sm MHz, W, limit, C): {clocks}")
    say(f"[continuous] dispatches {cb.ingest_dispatches} chunk + "
        f"{cb.decode_dispatches} segment ({cb.steps} segment steps) | "
        f"prefix hits {cb.prefix.hits}, shared tokens "
        f"{cb.prefix.tokens_shared} | CoW copies {cb.cow_copies} | pool "
        f"{cb.total_pages} pages, MB by dtype {pool_mb}"
        f" | legal-transition rate {rate:.4f} | launches {counts}")
    del cb, done
    torch.cuda.empty_cache()

    # the graph against eager: the first CB_CHECK_SEGMENTS segments of the
    # same schedule with the same draws; the graphed run is the profiled
    # window of the device-busy share
    runs = [cb_first_segments(dev, model, prompts, g, CB_CHECK_SEGMENTS,
                              profiled=g) for g in (True, False)]
    outs = [out for _, out, _, _ in runs]
    pools_equal = all(torch.equal(a[:, 1:], b[:, 1:]) for a, b in zip(
        *(pool_tensors(c.kv) for c, _, _, _ in runs)))
    say(f"[continuous] graph vs eager, first {CB_CHECK_SEGMENTS} segments: "
        f"emitted tokens {'identical' if outs[0] == outs[1] else 'DIFFER'} "
        f"({sum(map(len, outs[0]))} tokens), pools (pages 1 and up) "
        f"{'bit-equal' if pools_equal else 'DIFFER'} | chunk dispatch "
        f"median {statistics.median(runs[0][2]):.2f} ms graphed, "
        f"{statistics.median(runs[1][2]):.2f} ms eager "
        f"({len(runs[0][2])} each)")
    pwall, busy, top = runs[0][3]
    if busy == 0:
        say("[continuous] device busy: not measured (the profiler saw no "
            "kernels)")
    else:
        say(f"[continuous] profiled window (the graphed run's "
            f"{len(runs[0][2])} chunk and {CB_CHECK_SEGMENTS} segment "
            f"dispatches, admission included): wall {pwall:.1f} ms under "
            f"the profiler, device busy {busy:.1f} ms "
            f"({100 * busy / pwall:.1f}%)")
        for ms, count, key in top:
            say(f"[continuous]   {ms:8.2f} ms  x{count:<6d} {key[:90]}")
    if outs[0] != outs[1] or not pools_equal or not sum(map(len, outs[0])):
        raise SmokeError("continuous: the graph's segments differ from the "
                         "eager ones")
    del runs
    torch.cuda.empty_cache()

    # a pool at about 60% of the worst case, one request in four
    # interactive, submitted once the standard ones fill the slots
    worst = 1 + CB_SLOTS * (-(-(CB_MAX + CB_NEW) // PSZ)) + CB_SLOTS
    cb = cb_batcher(dev, model, total_pages=round(0.6 * worst))
    cb.capture()
    K.reset_launch_counts()
    late = [p for i, p in enumerate(prompts) if i % 4 == 3]
    for i, p in enumerate(prompts):
        if i % 4 != 3:
            cb.submit(p, CB_NEW)
    done = cb.step() + cb.step()
    for p in late:
        cb.submit(p, CB_NEW, priority="interactive")
    t0 = time.perf_counter()
    done += cb.run()
    torch.cuda.synchronize()
    pwall = time.perf_counter() - t0
    p_counts = K.launch_counts()
    cb_drained("pool under pressure", cb, done, CB_REQUESTS)
    check_counts("pool under pressure", p_counts, cb_counts(dbm, cb))
    inter = [r.ttft for r in done if r.priority == 2]
    say(f"[continuous] pool under pressure: {cb.total_pages} pages of "
        f"{worst} worst case, {len(late)} interactive submitted after 2 "
        f"steps: preemptions {cb.preemptions}, restores {cb.restores}, CoW "
        f"copies {cb.cow_copies}, every request complete, no page leaked | "
        f"wall {pwall:.2f} s after the arrivals, interactive TTFT median "
        f"{statistics.median(inter) * 1e3:.1f} ms")
    if cb.preemptions < 1 or cb.restores < 1:
        raise SmokeError("pool under pressure: no preemption and restore")
    add_counts(counts, p_counts)
    del cb, done
    torch.cuda.empty_cache()

    # fp32 through the kernels against the plain versions; bf16 and the
    # int8 pool against fp32, on the same schedule and draws
    few = prompts[:CB_SLOTS]
    K.reset_launch_counts()
    ck, lk, ek = cb_logged(dev, model, few, "fp32", "kernels")
    add_counts(counts, K.launch_counts())
    _, lr, er = cb_logged(dev, model, few, "fp32", "ref")
    first = ek[0] >= 0                          # (slots, seg_len) emitting
    diverged = [t for t in range(CB_SEG)
                if not np.array_equal(ek[0][:, t], er[0][:, t])]
    upto = diverged[0] + 1 if diverged else CB_SEG
    rel = max(((lk[t] - lr[t])[first[:, t]].abs().max()
               / lr[t][first[:, t]].abs().max()).item()
              for t in range(upto) if first[:, t].any())
    agree = float((ek == er)[ek >= 0].mean())
    say(f"[continuous] fp32, {len(few)} requests, 2 segments, kernels vs "
        f"plain versions: first segment's logits rel max|diff| {rel:.2e} "
        f"(limit 1e-3; steps 1-{upto}) | greedy tokens equal {agree:.4f} "
        f"over {int((ek >= 0).sum())}")
    if not (rel <= 1e-3 and math.isfinite(rel)):
        raise SmokeError(f"continuous fp32 cross-check: logits differ by "
                         f"{rel:.2e}")
    # each slot's first generated token follows its prompt alone, so it is
    # compared with fp32 on the same history; later tokens run free
    on = np.concatenate(list(ek >= 0), axis=1)          # (slots, steps)
    firsts = [(s, int(np.argmax(on[s]))) for s in range(len(on))
              if on[s].any()]
    agreement = {}
    for pol in ("bf16", "bf16_kvint8"):
        _, _, eq = cb_logged(dev, model, few, pol, "kernels")
        a, b = (np.concatenate(list(x), axis=1) for x in (eq, ek))
        agreement[pol] = {
            "first_token": float(np.mean([a[s, t] == b[s, t]
                                          for s, t in firsts])),
            "all": float((a == b)[on].mean())}
        say(f"[continuous] {pol} vs fp32, same schedule and draws: top-1 "
            f"agreement {agreement[pol]['first_token']:.4f} on each "
            f"request's first token ({len(firsts)} requests), "
            f"{agreement[pol]['all']:.4f} over 2 free-running segments "
            f"({int(on.sum())} tokens)")
    say(f"[continuous] phase 5b took {time.perf_counter() - t_phase:.1f} s")
    return {"counts": counts, "wall_s": wall, "tok_s": n_tok / wall,
            "ttft_median_s": statistics.median(ttft), "ttft_max_s": ttft[-1],
            "segment_step_ms": seg_step_ms, "in_dispatch": in_dispatch,
            "chunk_ms_median": statistics.median(chunk_ms),
            "logits_rel": rel, "agreement": agreement}


def pool_tensors(pkv):
    return [t for t in (pkv.k, pkv.v, pkv.k_scale, pkv.v_scale)
            if t is not None]


# ---------------------------------------------------------------------------
# 5c. the serving system: InferenceServer over the graphed batcher
# ---------------------------------------------------------------------------

def srv_trace(vocab: int, rate: float, bursty: bool, seed: int) -> list:
    """SRV_REQUESTS requests [(arrival s, prompt, max_new, class)]: Poisson
    arrivals at ``rate`` requests/s, or bursts of geometric size (mean
    SRV_BURST) arriving at rate / SRV_BURST; prompts clipped-lognormal in
    CB_MIN-CB_MAX tokens (median SRV_PROMPT), every fourth one behind the
    shared CB_SHARED-token prefix; new tokens clipped-lognormal in
    SRV_NEW (median 32); classes drawn from SRV_MIX."""
    import numpy as np
    from repro_torch.data import MarkovLM
    lm = MarkovLM(vocab_size=vocab, seed=7)
    rs = np.random.RandomState(seed)
    shared = lm.sample(rs, 1, CB_SHARED)[0]
    names, probs = zip(*SRV_MIX)
    out, t = [], 0.0
    while len(out) < SRV_REQUESTS:
        if bursty:
            t += rs.exponential(SRV_BURST / rate)
            k = int(rs.geometric(1.0 / SRV_BURST))
        else:
            t += rs.exponential(1.0 / rate)
            k = 1
        for _ in range(min(k, SRV_REQUESTS - len(out))):
            n = int(np.clip(round(SRV_PROMPT * np.exp(0.35 * rs.randn())),
                            CB_MIN, CB_MAX))
            new = int(np.clip(round(32 * np.exp(0.35 * rs.randn())),
                              *SRV_NEW))
            if len(out) % 4 == 0:
                n = max(n, CB_SHARED + 16)
                p = np.concatenate([shared,
                                    lm.sample(rs, 1, n - CB_SHARED)[0]])
            else:
                p = lm.sample(rs, 1, n)[0]
            out.append((t, p, new, str(rs.choice(names, p=probs))))
    return out


def srv_ledger(cb) -> tuple:
    """What a batcher's launches must be, from its counters: (layers,
    segment steps and segment warm-ups, chunk dispatches and chunk
    warm-ups)."""
    return (cb.dbm.cfg.n_layers, cb.steps + cb.graph_warmups["segment"],
            cb.ingest_dispatches + cb.graph_warmups["chunk"])


def srv_counts(ledger) -> dict:
    """Launches of the batchers in ``ledger`` (see ``cb_counts``; a
    capture's eager warm-up step counts once)."""
    dec = sum(2 * L * seg for L, seg, _ in ledger)
    return expected_counts(flash_decode=dec, gate_residual=dec,
                           flash_prefill=sum(L * ch for L, _, ch in ledger))


async def srv_poll(want, what: str, timeout: float = 60.0) -> None:
    """Wait until ``want()`` holds (host state only)."""
    import asyncio
    t0 = time.monotonic()
    while not want():
        if time.monotonic() - t0 > timeout:
            raise SmokeError(f"server: {what} did not happen in {timeout} s")
        await asyncio.sleep(0.005)


async def srv_replay(port: int, trace) -> tuple:
    """Replay ``trace`` against the server on ``port`` with the port's
    client, each request at its arrival time: (results, wall s)."""
    import asyncio
    from repro_torch.launch.server import stream_generate
    t0 = time.monotonic()

    async def one(at, prompt, new, cls):
        await asyncio.sleep(max(0.0, t0 + at - time.monotonic()))
        slo = ({"ttft_slo_ms": SRV_TTFT_SLO_MS, "tpot_slo_ms": SRV_TPOT_SLO_MS}
               if cls == "interactive" else {})
        r = await stream_generate(SRV_HOST, port, prompt, new, priority=cls,
                                  **slo)
        r.update(cls=cls, max_new=new)
        return r

    results = await asyncio.gather(*(one(*x) for x in trace))
    return results, time.monotonic() - t0


def srv_report(tag: str, results, wall: float, counters: dict,
               in_dispatch: float) -> dict:
    """Print a trace's percentiles per class (client clock: TTFT from the
    request's send to its first token event; TPOT as the time from the
    first token event to the last over the tokens after the first event),
    sheds, deadline cancels, preemptions, SLO attainment per class (an
    interactive request attains when it finishes with TTFT and TPOT within
    its SLOs; a standard or batch one when it finishes), tok/s and the
    wall's share inside a dispatch."""
    import numpy as np
    no_hint = [r for r in results if r["status"] == 429
               and r["retry_after"] is None]
    bad = [r["status"] for r in results if r["status"] not in (200, 429)]
    if no_hint or bad:
        raise SmokeError(f"{tag}: {len(no_hint)} sheds without Retry-After, "
                         f"statuses {bad}")
    srv_complete(tag, [r for r in results if r["status"] == 200])
    out = {"classes": {}}
    for cls, _ in SRV_MIX:
        rows = [r for r in results if r["cls"] == cls]
        ttft, tpot, ok = [], [], 0
        for r in rows:
            if r["status"] != 200:
                continue
            times, counts = r["token_times"], r["token_counts"]
            t_ms = (times[0] - r["submit_t"]) * 1e3 if times else None
            p_ms = ((times[-1] - times[0]) * 1e3
                    / (len(r["ids"]) - counts[0])
                    if counts and len(r["ids"]) > counts[0] else None)
            if t_ms is not None:
                ttft.append(t_ms)
            if p_ms is not None:
                tpot.append(p_ms)
            done = "error" not in (r["final"] or {"error": 1})
            if done and (cls != "interactive" or (
                    t_ms <= SRV_TTFT_SLO_MS
                    and (p_ms is None or p_ms <= SRV_TPOT_SLO_MS))):
                ok += 1

        def pct(v, q):
            return f"{np.percentile(v, q):.1f}" if v else "n/a"
        shed = sum(r["status"] == 429 for r in rows)
        blown = sum(bool((r["final"] or {}).get("deadline_blown"))
                    for r in rows)
        out["classes"][cls] = {
            "n": len(rows), "attained": ok / max(len(rows), 1),
            "shed": shed, "deadline": blown,
            "ttft_p50": float(np.percentile(ttft, 50)) if ttft else None,
            "ttft_p99": float(np.percentile(ttft, 99)) if ttft else None}
        say(f"[server] {tag} {cls:11s}: {len(rows):2d} requests, SLO "
            f"attained {ok}/{len(rows)} | TTFT p50 {pct(ttft, 50)} p99 "
            f"{pct(ttft, 99)} ms | TPOT p50 {pct(tpot, 50)} p99 "
            f"{pct(tpot, 99)} ms ({len(tpot)} with 2+ token events) | "
            f"shed {shed}, deadline-cancelled {blown}")
    n_tok = sum(len(r["ids"]) for r in results)
    out.update(wall_s=wall, tok_s=n_tok / wall, in_dispatch=in_dispatch,
               **counters)
    say(f"[server] {tag}: wall {wall:.2f} s | {n_tok} tokens, "
        f"{n_tok / wall:.1f} tok/s | 429s {counters['shed']} (each with "
        f"Retry-After) | deadline cancels {counters['deadline_cancels']} | "
        f"preemptions {counters['preemptions']} | inside a dispatch "
        f"{100 * in_dispatch:.1f}% of the wall (CUDA events)")
    return out


def srv_complete(tag: str, results) -> None:
    """Each admitted request ended in a ``done`` event with its streamed
    tokens equal to the final output and exactly ``max_new`` of them, or
    in the ``error`` event of a deadline cancel (its partial output): any
    other end is a server or engine error."""
    for r in results:
        fin = r["final"] or {"error": "the stream ended with no final event"}
        if fin.get("deadline_blown") and r["ids"] == fin["ids"]:
            continue
        if ("error" in fin or r["ids"] != fin["ids"]
                or len(r["ids"]) != r["max_new"]):
            raise SmokeError(f"{tag}: a request ended with {len(r['ids'])} "
                             f"of {r['max_new']} tokens streamed, final "
                             f"{fin}")


def srv_runner(what: str, runner, crashes: int) -> None:
    """The engine thread's supervisor caught exactly ``crashes`` exceptions
    (the injected ``engine_crash`` the last of them) and is still serving:
    a recovered crash of any other kind fails the phase."""
    injected = "InjectedFault: injected fault 'engine_crash'"
    if (runner.crashes != crashes or runner.gave_up or runner.died
            or (crashes and not (runner.last_error or "").startswith(
                injected))):
        raise SmokeError(f"server, {what}: the engine thread caught "
                         f"{runner.crashes} exceptions (want {crashes}), "
                         f"last {runner.last_error!r}, gave up "
                         f"{runner.gave_up}, died {runner.died}")


def srv_crashed(results, new: int) -> None:
    """After the injected crash: each request finished with exactly its
    tokens, the streamed tokens equal to the final output (so what it had
    streamed before the crash is a prefix of it), and one of them spilled
    by the recovery."""
    for r in results:
        fin = r["final"] or {}
        if (r["status"] != 200 or "error" in fin or r["ids"] != fin["ids"]
                or len(r["ids"]) != new):
            raise SmokeError(f"crash recovery: a request lost or repeated "
                             f"tokens: status {r['status']}, streamed "
                             f"{len(r['ids'])}, final {fin}")
    if not any(r["final"]["preempted"] for r in results):
        raise SmokeError("crash recovery: no request was in a slot at the "
                         "crash")


async def srv_parity(make_cb, reqs) -> tuple:
    """The parity requests, one at a time, through a server over
    ``make_cb()`` (SSE), then the first one again as ``"stream": false``
    through a fresh one: (SSE tokens, the JSON ids, the batchers' launch
    ledgers, the first server's start s, its graph capture included)."""
    from repro_torch.launch.server import (InferenceServer, request_json,
                                           stream_generate)
    ledger, sse = [], []
    server = InferenceServer(make_cb())
    t0 = time.perf_counter()
    await server.start()
    start_s = time.perf_counter() - t0
    try:
        for p, n in reqs:
            r = await stream_generate(SRV_HOST, server.port, p, n)
            if r["status"] != 200:
                raise SmokeError(f"server parity: status {r['status']}, "
                                 f"final {r['final']}")
            srv_complete("server parity", [dict(r, max_new=n)])
            sse.append(r["ids"])
    finally:
        await server.aclose()
    srv_runner("parity", server.runner, 0)
    ledger.append(srv_ledger(server.cb))
    server = InferenceServer(make_cb())
    await server.start()
    try:
        code, obj = await request_json(
            SRV_HOST, server.port, "POST", "/v1/generate",
            {"prompt": [int(t) for t in reqs[0][0]], "max_new": reqs[0][1],
             "stream": False})
    finally:
        await server.aclose()
    srv_runner("parity", server.runner, 0)
    ledger.append(srv_ledger(server.cb))
    if code != 200:
        raise SmokeError(f"server parity: stream false answered {code}")
    return sse, obj["ids"], ledger, start_s


async def srv_load(cb, trace_a, trace_b, extra) -> dict:
    """Phase 5c's run on the full-width server over ``cb``: traces A and B,
    the faults, the drain. Returns the clients' results and the batcher's
    counters at each point (no device object)."""
    import asyncio
    from repro_torch.launch.faults import FaultInjector
    from repro_torch.launch.server import (InferenceServer, TokenStream,
                                           request_json, stream_generate)
    server = InferenceServer(cb)
    t0 = time.perf_counter()
    await server.start()
    out = {"capture_s": time.perf_counter() - t0, "marks": {}}
    port = server.port

    def mark(name):
        out["marks"][name] = (time.perf_counter(),
                              {k: getattr(cb, k) for k in (
                                  "shed_count", "deadline_cancels",
                                  "preemptions", "restores",
                                  "cancelled_count", "decode_dispatches",
                                  "ingest_dispatches")})

    def idle():
        return not cb.queue and not cb.active.any()

    try:
        mark("a0")
        out["a"] = await srv_replay(port, trace_a)
        await srv_poll(idle, "trace A's drain")
        mark("a1")
        cb.max_queue, cb.shed_below_pages = 8, cb.total_pages // 8
        out["b"] = await srv_replay(port, trace_b)
        await srv_poll(idle, "trace B's drain")
        mark("b1")
        cb.max_queue, cb.shed_below_pages = None, 0

        # faults: a mid-stream cancel, a closed connection, a slow consumer
        # of the bridge (cap 8 tokens: each 16-token segment pauses it)
        (p0, n0), (p1, n1), (p2, n2) = extra[:3]
        c0 = cb.cancelled_count
        r_cancel, r_abort = await asyncio.gather(
            stream_generate(SRV_HOST, port, p0, CB_NEW, cancel_after=16),
            stream_generate(SRV_HOST, port, p1, CB_NEW, abort_after=16))
        await srv_poll(lambda: cb.cancelled_count >= c0 + 2 and idle(),
                       "the cancel and the disconnect")
        pauses0 = server.backpressure_pauses
        rid = cb.submit(p2, CB_NEW)
        stream = TokenStream(asyncio.get_running_loop(), rid, 8,
                             on_pause=server._on_pause,
                             on_resume=server._on_resume)
        server.runner.attach(rid, stream)
        slow, done = [], False
        while not done:
            toks, done = await stream.next_batch()
            slow.extend(toks)
            await asyncio.sleep(0.2)
        out["faults"] = {"cancel": r_cancel, "abort": r_abort,
                         "slow": slow, "slow_req": stream.req.error,
                         "pauses": server.backpressure_pauses - pauses0}

        # an engine_crash while four requests stream, the first exception
        # the engine thread meets
        srv_runner("before the injected crash", server.runner, 0)
        restarts0 = server.runner.restarts
        d0 = cb.decode_dispatches
        tasks = [asyncio.ensure_future(stream_generate(
            SRV_HOST, port, p, CB_NEW)) for p, _ in extra[3:7]]
        await srv_poll(lambda: cb.decode_dispatches > d0,
                       "the crash requests' first segment")
        cb.faults = FaultInjector({"engine_crash": {"at": [2]}})
        crashed = await asyncio.gather(*tasks)
        cb.faults = None
        out["crash"] = {"results": crashed,
                        "restarts": server.runner.restarts - restarts0}

        # drain with requests in flight, then 503
        tasks = [asyncio.ensure_future(stream_generate(
            SRV_HOST, port, p, CB_NEW)) for p, _ in extra[7:13]]
        await srv_poll(lambda: cb.active.sum() + len(cb.queue) >= 6,
                       "the drain requests' admission")
        await server.drain()
        out["drained"] = await asyncio.gather(*tasks)
        out["after_drain"] = await request_json(
            SRV_HOST, port, "POST", "/v1/generate",
            {"prompt": [1, 2, 3], "max_new": 2}, return_headers=True)
        mark("end")
    finally:
        await server.aclose()
    srv_runner("after the drain", server.runner, 1)
    out["pool"] = (len(cb.free_pages), len(cb.page_refs),
                   cb.page_refs == trie_holds(cb.prefix), cb.total_pages,
                   bool(cb.active.any()))
    out["ledger"] = [srv_ledger(cb)]
    return out


def srv_share(events, lo, hi, wall: float) -> float:
    """The share of ``wall`` s spent inside the segment and chunk
    dispatches numbered ``lo`` to ``hi`` ((segments, chunks) each; CUDA
    events, read once the engine thread is gone)."""
    ms = sum(s.elapsed_time(e) for i, kind in enumerate(("segment", "chunk"))
             for s, e in events[kind][lo[i]:hi[i]])
    return ms / (wall * 1e3)


def clear_cublas_workspaces() -> None:
    """Free the cuBLAS workspaces PyTorch keeps per (handle, stream): each
    batcher's own stream and each engine thread's handle get one, which
    would count as allocated memory left behind."""
    getattr(torch._C, "_cuda_clearCublasWorkspaces", lambda: None)()


def phase_server(dev, model, continuous: dict) -> dict:
    """Phase 5c: the serving system (see the module docstring)."""
    import asyncio
    from repro_torch import kernels as K
    t_phase = time.perf_counter()
    clear_cublas_workspaces()
    base = torch.cuda.memory_allocated()
    K.reset_launch_counts()
    dbm = model[0]
    rate = CB_REQUESTS / continuous["wall_s"]
    trace_a = srv_trace(dbm.cfg.vocab_size, SRV_RATE_A * rate, False, 21)
    trace_b = srv_trace(dbm.cfg.vocab_size, SRV_RATE_B * rate, True, 22)
    extra = [(p, n) for _, p, n, _ in srv_trace(dbm.cfg.vocab_size, 1.0,
                                                 False, 23)]

    # 1. parity: a one-slot fp32 server at stablelm's widths, 4 layers,
    # against the direct step loop under the same generator seed
    small = (*runner_model(dev, 4, 4), None)
    reqs = [(extra[0][0], 24), (extra[1][0], 40)]

    def make_cb():
        return cb_batcher(dev, small, precision="fp32", seed=5, num_slots=1)

    cb = make_cb()
    t0 = time.perf_counter()
    cb.capture()
    capture_s = time.perf_counter() - t0
    direct = []
    for p, n in reqs:
        cb.submit(p, n)
        direct.append(cb.run()[0].out)
    ledger = [srv_ledger(cb)]
    del cb
    sse, json_ids, more, start_s = asyncio.run(srv_parity(make_cb, reqs))
    ledger += more
    del small
    say(f"[server] parity (one slot, fp32, stablelm widths with 4 layers, "
        f"graphs captured on the engine thread): SSE tokens of 2 requests "
        f"{'equal' if sse == direct else 'DIFFER from'} the direct step "
        f"loop's, bit for bit ({sum(map(len, sse))} tokens); stream false "
        f"{'equals' if json_ids == sse[0] else 'DIFFERS from'} its SSE twin"
        f" | capture {capture_s:.2f} s on the main thread, server start "
        f"{start_s:.2f} s (its capture on the engine thread)")
    if sse != direct or json_ids != sse[0]:
        raise SmokeError(f"server parity: SSE {sse} vs direct {direct}, "
                         f"JSON {json_ids}")

    # 2-4. the full-width server: traces A and B, faults, drain
    cb = cb_batcher(dev, model)
    events = cb_timed(cb)
    say(f"[server] {dbm.cfg.name} full width, bf16, {CB_SLOTS} slots, "
        f"seg_len {CB_SEG}, prefix cache on, graphs; phase 5b finished "
        f"{rate:.3f} requests/s: trace A Poisson at {SRV_RATE_A:.0%} "
        f"({SRV_RATE_A * rate:.3f}/s), trace B bursts of mean {SRV_BURST} "
        f"at {SRV_RATE_B:.0%} ({SRV_RATE_B * rate:.3f}/s, max_queue 8, "
        f"shed below {cb.total_pages // 8} free pages); {SRV_REQUESTS} "
        f"requests each, prompts {CB_MIN}-{CB_MAX} (median {SRV_PROMPT}), a "
        f"quarter behind one {CB_SHARED}-token prefix, {SRV_NEW[0]}-"
        f"{SRV_NEW[1]} new tokens (median 32), classes {dict(SRV_MIX)}, "
        f"interactive SLOs TTFT {SRV_TTFT_SLO_MS} ms, TPOT "
        f"{SRV_TPOT_SLO_MS} ms")
    run = asyncio.run(srv_load(cb, trace_a, trace_b, extra))
    ledger += run.pop("ledger")
    del cb
    torch.cuda.synchronize()
    marks = run["marks"]
    n_ev = {}          # dispatch index at each mark, per kind
    for k, (_, c) in marks.items():
        n_ev[k] = (c["decode_dispatches"], c["ingest_dispatches"])
    traces = {}
    for tag, lo, hi in (("trace A", "a0", "a1"), ("trace B", "a1", "b1")):
        results, wall = run["a" if tag == "trace A" else "b"]
        c0, c1 = marks[lo][1], marks[hi][1]
        counters = {k: c1[k] - c0[k] for k in (
            "shed_count", "deadline_cancels", "preemptions")}
        counters["shed"] = counters.pop("shed_count")
        share = srv_share(events, n_ev[lo], n_ev[hi],
                          marks[hi][0] - marks[lo][0])
        traces[tag] = srv_report(tag, results, wall, counters, share)
        if counters["shed"] != sum(r["status"] == 429 for r in results):
            raise SmokeError(f"{tag}: the batcher shed {counters['shed']}, "
                             "the clients saw another count of 429s")
    say(f"[server] graph capture on the engine thread {run['capture_s']:.2f}"
        f" s (before the server listened)")

    f = run["faults"]
    cancel, abort = f["cancel"], f["abort"]
    say(f"[server] faults: cancel after {len(cancel['ids'])} tokens "
        f"(cancelled {cancel['final']['cancelled']}), connection closed "
        f"after {len(abort['ids'])} tokens, slow consumer {len(f['slow'])} "
        f"of {CB_NEW} tokens with {f['pauses']} backpressure pauses | "
        f"engine_crash: restarts {run['crash']['restarts']}, "
        f"{len(run['crash']['results'])} requests streaming, preempted "
        f"{[r['final']['preempted'] for r in run['crash']['results']]}")
    if not (cancel["final"]["cancelled"] and len(cancel["ids"]) < CB_NEW
            and abort["aborted"]):
        raise SmokeError(f"server: cancel {cancel['final']}, abort "
                         f"{abort['aborted']}")
    if len(f["slow"]) != CB_NEW or f["slow_req"] or f["pauses"] < 1:
        raise SmokeError(f"server: slow consumer got {len(f['slow'])} "
                         f"tokens, {f['pauses']} pauses")
    if run["crash"]["restarts"] != 1:
        raise SmokeError(f"server: {run['crash']['restarts']} restarts "
                         "after one injected crash")
    srv_crashed(run["crash"]["results"], CB_NEW)

    code, obj, hdrs = run["after_drain"]
    free, held, trie_ok, total, active = run["pool"]
    short = [len(r["ids"]) for r in run["drained"] if len(r["ids"]) != CB_NEW]
    say(f"[server] drain: {len(run['drained'])} requests in flight all "
        f"complete ({'none short' if not short else short}), then "
        f"{code} ({obj.get('error')}, retry-after "
        f"{hdrs.get('retry-after')}) | pool: {free} free + {held} held by "
        f"the prefix cache = {free + held} of {total - 1}")
    if short or code != 503 or "retry-after" not in hdrs:
        raise SmokeError(f"server drain: short {short}, then {code}")
    srv_complete("server drain", [dict(r, max_new=CB_NEW)
                                  for r in run["drained"]])
    if free + held != total - 1 or not trie_ok or active:
        raise SmokeError(f"server: pool not whole after the drain: {free} "
                         f"free, {held} held, trie {trie_ok}")
    counts = K.launch_counts()
    check_counts("server", counts, srv_counts(ledger))
    clear_cublas_workspaces()
    after = torch.cuda.memory_allocated()
    say(f"[server] launches {counts} (the dispatches' arithmetic; per "
        f"batcher (layers, segment steps, chunk dispatches), warm-ups "
        f"included: {ledger}) | "
        f"memory allocated {base / 2**30:.2f} GiB before phase 5c, "
        f"{after / 2**30:.2f} GiB after its servers were dropped (no gc "
        f"pass; limit +0.5) | phase 5c took "
        f"{time.perf_counter() - t_phase:.1f} s")
    if after > base + SRV_MEM_SLACK:
        raise SmokeError(f"server: {(after - base) / 2**30:.2f} GiB still "
                         "allocated after the servers were dropped")
    return {"counts": counts, "traces": traces, "base_bytes": base,
            "after_bytes": after}


# ---------------------------------------------------------------------------
# 6. full-width training steps, 7. fp32 cross-check
# ---------------------------------------------------------------------------

def unit_digests(params) -> torch.Tensor:
    """(n_units + 1,) int64: per unit an exact integer sum of the bits of
    its layer params (any changed element changes it, short of a
    cancellation), and last the same over the periphery."""
    from repro_torch.nn.init import tree_items
    wq = params["layers"]["attn"]["wq"]
    L = wq.shape[0]
    per_unit = torch.zeros(L, dtype=torch.int64, device=wq.device)
    periphery = torch.zeros((), dtype=torch.int64, device=wq.device)
    for path, x in tree_items(params):
        bits = x.detach().view(torch.int32)
        if path[0] == "layers":
            per_unit += bits.reshape(L, -1).sum(1, dtype=torch.int64)
        else:
            periphery += bits.sum(dtype=torch.int64)
    return torch.cat([per_unit, periphery[None]])


def timed_step(run):
    """(result, wall s, device ms between CUDA events, peak bytes, bytes
    allocated before) of run(); counts are reset just before it."""
    from repro_torch import kernels as K
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    start.record()
    out = run()
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (out, wall, start.elapsed_time(end),
            torch.cuda.max_memory_allocated(), base, K.launch_counts())


def profile_step(label, fn) -> dict:
    wall, busy, top = device_busy(fn, top=10)
    say(f"[profile] {label}: wall {wall:.1f} ms under the profiler, device "
        f"busy {busy:.1f} ms ({100 * busy / wall:.1f}%)")
    for ms, count, key in top:
        say(f"[profile]   {ms:8.2f} ms  x{count:<5d} {key[:90]}")
    return {"wall_ms": wall, "device_ms": busy}


def db_steps(dbm, params, gen, tcfg, data, tag: str) -> dict:
    """One bf16 DB step on each block, each with its block's own AdamW
    state, made before the step and freed after it (so the resident memory
    is what training that block alone holds: the masters and one block's
    moments), after a warm-up step (first-call costs: cuBLAS heuristics, the
    allocator growing); one more under the profiler; then one iteration of
    ``train_db``, which keeps every block's state resident as the training
    CLI does. Each run's launch counts must equal the path's arithmetic and
    only the trained block and the periphery may change."""
    from repro_torch.core import training as T
    cfg = dbm.cfg
    dev = params["embed"]["table"].device
    batch = lambda: torch.as_tensor(next(data), device=dev)  # noqa: E731

    def db_step(b, tokens):
        init, step = T.make_db_train_step(dbm, b, tcfg, precision="bf16")
        state = init(params)
        return lambda: step(params, state, tokens, gen)[2:]

    loss, _ = db_step(3, batch())()
    say(f"[{tag}] warm-up DB step on block 3: loss {float(loss):.4f}")
    out = {"db": [], "launches": {}}
    for b, (start, size) in enumerate(dbm.ranges):
        before = unit_digests(params)
        run = db_step(b, batch())
        (res, wall, dev_ms, peak, base, counts) = timed_step(run)
        loss, m = res
        # frees the block's AdamW state; the allocator keeps the blocks
        # cached (no cudaMalloc inside the next timed step)
        del run, res
        changed = (unit_digests(params) != before).tolist()
        expect = db_step_counts(dbm, size)
        say(f"[{tag}] DB step block {b} (units {start}-{start + size - 1}): "
            f"loss {float(loss):.4f} | grad norm {float(m['grad_norm']):.3f}"
            f" | wall {wall * 1e3:.1f} ms | device {dev_ms:.1f} ms (events) "
            f"| peak {peak / 2**30:.2f} GiB (resident before "
            f"{base / 2**30:.2f}: masters + this block's AdamW state) | "
            f"launches {counts}")
        if counts != expect:
            raise SmokeError(f"DB step block {b}: launch counts {counts} != "
                             f"path arithmetic {expect}")
        if not math.isfinite(float(loss)):
            raise SmokeError(f"DB step block {b}: loss {float(loss)}")
        want = [start <= u < start + size for u in range(cfg.n_layers)] \
            + [True]
        if changed != want:
            raise SmokeError(f"DB step block {b} changed units "
                             f"{changed} (expected {want})")
        add_counts(out["launches"], counts)
        out["db"].append({"block": b, "loss": float(loss), "wall_s": wall,
                          "device_ms": dev_ms, "peak_bytes": peak,
                          "resident_bytes": base})
    walls = [r["wall_s"] * 1e3 for r in out["db"]]
    say(f"[{tag}] DB step wall over the {len(walls)} blocks: median "
        f"{statistics.median(walls):.1f} ms, min-max {min(walls):.1f}-"
        f"{max(walls):.1f} ms")
    out["db_profile"] = profile_step(f"{tag}: DB step block 0",
                                     db_step(0, batch()))

    # the shipped trainer (``train_db``, what ``launch.train --mode db``
    # runs) makes every block's AdamW state up front and keeps them all:
    # one iteration of it, states made inside the timed region
    one = dataclasses.replace(tcfg, steps=1, log_every=0)
    (res, wall, dev_ms, peak, base, counts) = timed_step(
        lambda: T.train_db(dbm, one, data, gen, params=params,
                           precision="bf16")[1])
    (_, b, loss), = res
    del res
    torch.cuda.empty_cache()
    expect = db_step_counts(dbm, dbm.ranges[b][1])
    say(f"[{tag}] train_db, 1 iteration (block {b}, all "
        f"{dbm.num_blocks} AdamW states resident): loss {loss:.4f} | wall "
        f"{wall * 1e3:.1f} ms (states made inside) | peak "
        f"{peak / 2**30:.2f} GiB | launches {counts}")
    if counts != expect:
        raise SmokeError(f"train_db: launch counts {counts} != path "
                         f"arithmetic {expect}")
    if not math.isfinite(loss):
        raise SmokeError(f"train_db: loss {loss}")
    add_counts(out["launches"], counts)
    out["train_db"] = {"block": b, "loss": loss, "peak_bytes": peak}
    return out


def phase_train(dev, model) -> dict:
    """Phase 6. The serve phase's model (fp32 masters; its serving caches
    are dropped first), bf16 policy: ``db_steps``, then a warm-up e2e step,
    one timed and one under the profiler, every param's AdamW state
    resident."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import training as T
    from repro_torch.data import MarkovLM
    from repro_torch.launch.serve import ContinuousBatcher
    dbm, params, gen = model
    dbm.__dict__.pop("_compute_copies", None)     # serving's bf16 copy
    dbm.model.__dict__.pop("_unit_memo", None)
    torch.cuda.empty_cache()
    cfg = dbm.cfg
    tcfg = TrainConfig(steps=100, warmup_steps=10, lr=1e-4)
    data = MarkovLM(vocab_size=cfg.vocab_size, seed=7).iterator(
        TRAIN_BATCH, TRAIN_SEQ)
    batch = lambda: torch.as_tensor(next(data), device=dev)  # noqa: E731
    # what the serving phases left allocated: batchers kept only by
    # reference cycles (freed by no refcount, only by a gc pass) and
    # anything beyond the fp32 masters
    masters = sum(p.numel() * p.element_size() for _, p in _leaves(params))
    resident = torch.cuda.memory_allocated()
    stray = sum(isinstance(o, ContinuousBatcher) for o in gc.get_objects())
    say(f"[train] {cfg.name} full width, bf16 policy, MarkovLM batches "
        f"{TRAIN_BATCH}x{TRAIN_SEQ}; resident at the start "
        f"{resident / 2**30:.2f} GiB: fp32 masters "
        f"{masters / 2**30:.2f} GiB + {(resident - masters) / 2**30:.2f} "
        f"left by the serving phases ({stray} batchers still in memory; "
        f"phase 6 alone: 8.40 GiB, PR 25's p14.txt)")
    if resident - masters > 2**30 or stray:
        raise SmokeError(f"phase 6 starts with {(resident - masters) / 2**30:.2f}"
                         f" GiB beyond the masters and {stray} batchers "
                         "left by the serving phases")

    out = db_steps(dbm, params, gen, tcfg, data, "train")

    init, step = T.make_e2e_train_step(dbm, tcfg, precision="bf16")
    opt = init(params)
    loss = step(params, opt, batch())[2]
    say(f"[train] warm-up e2e step: loss {float(loss):.4f}")
    tokens = batch()
    (res, wall, dev_ms, peak, base, counts) = timed_step(
        lambda: step(params, opt, tokens)[2:])
    loss, m = res
    expect = expected_counts(**{n: cfg.n_layers for n in ATTN})
    say(f"[train] e2e step (all {cfg.n_layers} layers): loss "
        f"{float(loss):.4f} | grad norm {float(m['grad_norm']):.3f} | wall "
        f"{wall * 1e3:.1f} ms | device {dev_ms:.1f} ms (events) | peak "
        f"{peak / 2**30:.2f} GiB (resident before {base / 2**30:.2f}: "
        f"masters + AdamW state of every param) | launches {counts}")
    if counts != expect:
        raise SmokeError(f"e2e step: launch counts {counts} != path "
                         f"arithmetic {expect}")
    if not math.isfinite(float(loss)):
        raise SmokeError(f"e2e step: loss {float(loss)}")
    add_counts(out["launches"], counts)
    out["e2e"] = {"loss": float(loss), "wall_s": wall, "device_ms": dev_ms,
                  "peak_bytes": peak, "resident_bytes": base}
    tokens = batch()
    out["e2e_profile"] = profile_step("e2e step",
                                      lambda: step(params, opt, tokens))
    db_peak = max(r["peak_bytes"] for r in out["db"])
    all_peak = out["train_db"]["peak_bytes"]
    say(f"[train] peak memory: DB step with one block's AdamW state "
        f"{db_peak / 2**30:.2f} GiB ({db_peak / peak:.3f} of e2e), train_db "
        f"with all {dbm.num_blocks} states {all_peak / 2**30:.2f} GiB "
        f"({all_peak / peak:.3f} of e2e), e2e step "
        f"{peak / 2**30:.2f} GiB; nvidia-smi (sm MHz, "
        f"W, limit, C): "
        f"{gpu_query('clocks.sm,power.draw,power.limit,temperature.gpu')}")
    del opt
    torch.cuda.empty_cache()
    return out


def block_crosscheck(params, view, make_step, args, kw, expect, tag: str,
                     grads, stack: str = "layers") -> dict:
    """One fp32 step from the same params and draws (``step(params, state,
    *args, **kw)``), through the kernels and through their plain versions
    (``make_step(impl)`` for impl "kernels" and "ref"), on ``view`` =
    (start, size), the block of layers [start, start + size) and the
    periphery, or on every param when ``view`` is None; the trained params
    are restored between the two. Loss, grad norm and the first moments
    (0.1 x the clipped gradients) of the ``grads`` leaves of the first
    trained layer of ``stack`` must agree to 1e-3 relative, and the
    launches equal ``expect`` (none for the plain path)."""
    from repro_torch import kernels as K
    from repro_torch.core import training as T
    from repro_torch.nn.init import tree_map
    start, size = view or (0, None)
    saved = tree_map(lambda _, x: x.clone(), params if view is None
                     else T.extract_block_view(params, start, size))
    res = {}
    for impl in ("kernels", "ref"):
        init, step = make_step(impl)
        K.reset_launch_counts()
        _, opt, loss, m = step(params, init(params), *args, **kw)
        check_counts(f"{tag} cross-check impl={impl}", K.launch_counts(),
                     expect if impl == "kernels" else expected_counts())
        res[impl] = (float(loss), float(m["grad_norm"]),
                     {g: opt.mu[stack][g[0]][g[1]][0].clone()
                      for g in grads})
        del opt
        T.write_back_block_view(params, saved, start)
        torch.cuda.empty_cache()
    (lk, gk, mk), (lr, gr, mr) = res["kernels"], res["ref"]
    loss_rel, gn_rel = abs(lk - lr) / abs(lr), abs(gk - gr) / abs(gr)
    grad_rel = {"/".join(g): ((mk[g] - mr[g]).abs().max()
                              / mr[g].abs().max()).item() for g in grads}
    what = ("every param" if view is None
            else f"layers {start}-{start + size - 1}")
    say(f"[crosscheck] {tag}: fp32 step on {what}, kernels vs plain "
        f"versions: loss {lk:.7f} vs {lr:.7f} (rel {loss_rel:.2e}) | grad "
        f"norm {gk:.7f} vs {gr:.7f} (rel {gn_rel:.2e}) | {stack}[{start}] "
        "grad rel max|diff| "
        + ", ".join(f"{k} {v:.2e}" for k, v in grad_rel.items())
        + "; limit 1e-3")
    if not (loss_rel <= 1e-3 and gn_rel <= 1e-3
            and max(grad_rel.values()) <= 1e-3):
        raise SmokeError(f"fp32 {tag} cross-check: kernels and plain "
                         "versions disagree")
    return {"loss_rel": loss_rel, "grad_norm_rel": gn_rel,
            "grad_rel": grad_rel}


def db_crosscheck(dev, model, tag: str, grads) -> dict:
    """``block_crosscheck`` of one DB step on block 0 of a
    ``DiffusionBlocksModel`` (random tokens, σ and ε from the generator)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import training as T
    dbm, params, gen = model
    start, size = dbm.ranges[0]
    tokens = torch.randint(0, dbm.cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ),
                           generator=gen, device=dev)
    sigma = dbm.sample_block_sigma(gen, (TRAIN_BATCH, 1, 1), 0, device=dev)
    eps = torch.randn(TRAIN_BATCH, TRAIN_SEQ, dbm.cfg.d_model, generator=gen,
                      device=dev)
    tcfg = TrainConfig(steps=100, warmup_steps=10, lr=1e-4)
    return block_crosscheck(
        params, (start, size),
        lambda impl: T.make_db_train_step(dbm, 0, tcfg, impl=impl,
                                          precision="fp32"),
        (tokens,), {"sigma": sigma, "eps": eps}, db_step_counts(dbm, size),
        tag, grads)


def phase_two_pass(dev) -> dict:
    """Phase 8: olmo-1b at full width trained as DiffusionBlocks in the
    two-pass mode with the l2 loss (bf16 policy), through ``db_steps``. The
    model is made here from seed 0 (AdaLN heads randomised so the σ
    conditioning and its kernels do real work)."""
    from repro_torch.configs import DBConfig, get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.blocks import DiffusionBlocksModel
    from repro_torch.data import MarkovLM
    t0 = time.perf_counter()
    cfg = get_config(TWO_PASS_ARCH)
    dbm = DiffusionBlocksModel(cfg, DBConfig(
        num_blocks=4, overlap_gamma=0.1, causal_mode="two_pass", loss="l2"))
    gen = torch.Generator(device=dev).manual_seed(0)
    params = dbm.init(gen)
    for k in ("w", "b"):
        params["layers"]["adaln"][k].normal_(0.0, 0.02, generator=gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for _, p in _leaves(params))
    say(f"[two-pass] {cfg.name}: {cfg.n_layers} layers d={cfg.d_model} "
        f"heads={cfg.n_heads} hd={cfg.head_dim} ff={cfg.d_ff} "
        f"vocab={cfg.vocab_size} norm={cfg.norm}, {dbm.num_blocks} blocks "
        f"{dbm.ranges}, causal_mode=two_pass loss=l2; {n_params / 1e9:.3f} "
        f"B params fp32 made in {time.perf_counter() - t0:.1f} s; bf16 "
        f"policy, MarkovLM batches {TRAIN_BATCH}x{TRAIN_SEQ}; resident "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    tcfg = TrainConfig(steps=100, warmup_steps=10, lr=1e-4)
    data = MarkovLM(vocab_size=cfg.vocab_size, seed=7).iterator(
        TRAIN_BATCH, TRAIN_SEQ)
    out = db_steps(dbm, params, gen, tcfg, data, "two-pass")
    say(f"[two-pass] peak memory: DB step with one block's AdamW state "
        f"{max(r['peak_bytes'] for r in out['db']) / 2**30:.2f} GiB, "
        f"train_db with all {dbm.num_blocks} states "
        f"{out['train_db']['peak_bytes'] / 2**30:.2f} GiB; nvidia-smi (sm "
        f"MHz, W, limit, C): "
        f"{gpu_query('clocks.sm,power.draw,power.limit,temperature.gpu')}")
    torch.cuda.empty_cache()
    out["model"] = (dbm, params, gen)
    return out


# ---------------------------------------------------------------------------
# 10. DiT-S/2, 11. Huginn at full width
# ---------------------------------------------------------------------------

def adapter_steps(label, params, ranges, n_layers, make_db, make_e2e, batch,
                  counts) -> dict:
    """A warm-up DB step on block 0, one timed DB step on each block (its
    own AdamW state made before the step, freed after it), one more under
    the profiler; then a warm-up, a timed and a profiled e2e step (every
    param's state resident). ``make_db(b)`` / ``make_e2e()`` give (init,
    step) pairs, ``batch()`` a step's positional arguments, ``counts(size)``
    the launches of a step over ``size`` layers. Each timed step's launches
    must equal that arithmetic and its loss be finite; a DB step may change
    only its block's layers and the periphery."""
    out = {"db": [], "launches": {}}

    def db_run(b, args):
        init, step = make_db(b)
        state = init(params)
        return lambda: step(params, state, *args)[2:]

    loss, _ = db_run(0, batch())()
    say(f"[{label}] warm-up DB step on block 0: loss {float(loss):.4f}")
    for b, (start, size) in enumerate(ranges):
        before = unit_digests(params)
        run = db_run(b, batch())
        (res, wall, dev_ms, peak, base, got) = timed_step(run)
        loss, m = res
        del run, res
        changed = (unit_digests(params) != before).tolist()
        say(f"[{label}] DB step block {b} (layers {start}-{start + size - 1})"
            f": loss {float(loss):.4f} | grad norm "
            f"{float(m['grad_norm']):.3f} | wall {wall * 1e3:.1f} ms | "
            f"device {dev_ms:.1f} ms (events) | peak {peak / 2**30:.2f} GiB "
            f"(resident before {base / 2**30:.2f}) | launches {got}")
        check_counts(f"{label} DB step block {b}", got, counts(size))
        if not math.isfinite(float(loss)):
            raise SmokeError(f"{label} DB step block {b}: loss {float(loss)}")
        want = [start <= u < start + size for u in range(n_layers)] + [True]
        if changed != want:
            raise SmokeError(f"{label} DB step block {b} changed layers "
                             f"{changed} (expected {want})")
        add_counts(out["launches"], got)
        out["db"].append({"block": b, "loss": float(loss), "wall_s": wall,
                          "device_ms": dev_ms, "peak_bytes": peak})
    out["db_profile"] = profile_step(f"{label}: DB step block 0",
                                     db_run(0, batch()))

    init, step = make_e2e()
    opt = init(params)
    step(params, opt, *batch())
    args = batch()
    (res, wall, dev_ms, peak, base, got) = timed_step(
        lambda: step(params, opt, *args)[2:])
    loss, m = res
    say(f"[{label}] e2e step (all {n_layers} layers): loss {float(loss):.4f}"
        f" | grad norm {float(m['grad_norm']):.3f} | wall {wall * 1e3:.1f} "
        f"ms | device {dev_ms:.1f} ms (events) | peak {peak / 2**30:.2f} GiB "
        f"(resident before {base / 2**30:.2f}) | launches {got}")
    check_counts(f"{label} e2e step", got, counts(n_layers))
    if not math.isfinite(float(loss)):
        raise SmokeError(f"{label} e2e step: loss {float(loss)}")
    add_counts(out["launches"], got)
    out["e2e"] = {"loss": float(loss), "wall_s": wall, "device_ms": dev_ms,
                  "peak_bytes": peak}
    out["e2e_profile"] = profile_step(f"{label}: e2e step",
                                      lambda: step(params, opt, *args))
    del opt
    torch.cuda.empty_cache()
    return out


def logits_gap(label, got, ref) -> float:
    """max |got - ref| / max |ref|; raises past 1e-3."""
    rel = ((got - ref).abs().max() / ref.abs().max()).item()
    say(f"[crosscheck] {label}, kernels vs plain versions: logits rel "
        f"max|diff| {rel:.2e} (limit 1e-3)")
    if not (rel <= 1e-3 and math.isfinite(rel)):
        raise SmokeError(f"{label}: kernels and plain versions differ by "
                         f"{rel:.2e}")
    return rel


def dit_step_counts(size: int) -> dict:
    """Launches of one DiT training step over ``size`` layers: per layer one
    attention forward, dq and dk/dv (``full`` mask), two gate-residual
    forward and backward (the σ-gates, no ``cond_mask``); one EDM loss
    forward and backward."""
    return expected_counts(**{n: size for n in ATTN},
                           gate_residual=2 * size,
                           gate_residual_bwd=2 * size, edm_loss_fwd=1,
                           edm_loss_bwd=1)


def sample_counts(evals: int, steps: int) -> dict:
    """Launches of a DiT sampler run: per layer evaluation one attention
    forward and two gate-residual forwards; one Euler forward per step."""
    return expected_counts(flash_attention_fwd=evals,
                           gate_residual=2 * evals, euler_fwd=steps)


def phase_dit(dev) -> dict:
    """Phase 10: DiT-S/2 at full width, fp32, batch 256 of 256 tokens."""
    from repro_torch.configs import paper
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import dit as DIT
    from repro_torch.core import edm
    from repro_torch.core import partition as PT
    from repro_torch.data import MixtureImagesContinuous
    t0 = time.perf_counter()
    dit = DIT.DiTDiffusionBlocks(paper.DIT_S2, paper.DIT_DB,
                                 data_dim=DIT_DIM, n_tokens=DIT_TOKENS)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = dit.init(gen)
    # AdaLN heads and out_proj are zero at init: randomise them so the σ
    # conditioning, the gate kernels and F do real work
    for k in ("w", "b"):
        params["layers"]["adaln"][k].normal_(0.0, 0.02, generator=gen)
    params["out_proj"]["w"].normal_(0.0, 0.02, generator=gen)
    cfg = dit.cfg
    n_params = sum(p.numel() for _, p in _leaves(params))
    mix = MixtureImagesContinuous(n_tokens=DIT_TOKENS, dim=DIT_DIM,
                                  n_modes=4)
    data = mix.iterator(DIT_BATCH)

    def batch():
        return (torch.as_tensor(next(data)[0], device=dev), gen)
    tcfg = TrainConfig(steps=100, warmup_steps=10, lr=1e-4)
    say(f"[dit] {cfg.name}: {cfg.n_layers} layers d={cfg.d_model} "
        f"heads={cfg.n_heads} hd={cfg.head_dim} ff={cfg.d_ff} "
        f"norm={cfg.norm} mlp={cfg.mlp}, {dit.db.num_blocks} blocks "
        f"{dit.ranges}, loss={dit.db.loss}; {DIT_TOKENS} tokens of "
        f"{DIT_DIM} dims; {n_params / 1e6:.2f} M params fp32 made in "
        f"{time.perf_counter() - t0:.1f} s; fp32, MixtureImagesContinuous "
        f"batches of {DIT_BATCH}")

    out = adapter_steps("dit", params, dit.ranges, cfg.n_layers,
                        lambda b: DIT.make_db_step(dit, b, tcfg),
                        lambda: DIT.make_e2e_step(dit, tcfg), batch,
                        dit_step_counts)

    sched = PT.sampling_schedule(dit.db, DIT_STEPS)[:-1]
    per_block = [sum(PT.block_of_sigma(dit.db, float(s)) == b for s in sched)
                 for b in range(dit.db.num_blocks)]
    out["sample"] = {}
    for blockwise in (True, False):
        kind = "blockwise" if blockwise else "full stack"
        dit.sample(params, DIT_SAMPLES, 2, blockwise, generator=gen)
        (res, wall, dev_ms, peak, base, counts) = timed_step(
            lambda: dit.sample(params, DIT_SAMPLES, DIT_STEPS, blockwise,
                               generator=gen))
        z, evals = res
        want = (sum(n * s for n, (_, s) in zip(per_block, dit.ranges))
                if blockwise else DIT_STEPS * cfg.n_layers)
        if evals != want:
            raise SmokeError(f"DiT sampler ({kind}): {evals} layer "
                             f"evaluations, expected {want}")
        check_counts(f"DiT sampler ({kind})", counts,
                     sample_counts(evals, DIT_STEPS))
        if tuple(z.shape) != (DIT_SAMPLES, DIT_TOKENS, DIT_DIM) \
                or not torch.isfinite(z).all():
            raise SmokeError(f"DiT sampler ({kind}): samples not finite or "
                             f"of shape {tuple(z.shape)}")
        dist, cover = mix.fidelity(z.cpu().numpy())
        say(f"[dit] sample ({kind}), {DIT_SAMPLES} samples, {DIT_STEPS} "
            f"steps (per block {per_block}): {evals} layer evaluations | "
            f"wall {wall * 1e3:.1f} ms | device {dev_ms:.1f} ms (events) | "
            f"peak {peak / 2**30:.2f} GiB | fidelity (untrained weights, "
            f"sanity only): mean distance to nearest mode {dist:.3f}, mode "
            f"coverage {cover:.3f} | launches {counts}")
        add_counts(out["launches"], counts)
        out["sample"][kind] = {"evals": evals, "wall_s": wall,
                               "device_ms": dev_ms, "fidelity": (dist, cover)}
    bw, fs = out["sample"]["blockwise"], out["sample"]["full stack"]
    say(f"[dit] full stack / blockwise: wall {fs['wall_s'] / bw['wall_s']:.3f}"
        f"x, device {fs['device_ms'] / bw['device_ms']:.3f}x, layer "
        f"evaluations {fs['evals'] / bw['evals']:.3f}x ({fs['evals']} / "
        f"{bw['evals']})")

    # fp32 cross-check: one DB step on block 0 at the steps' batch, σ from
    # block 0's range as its steps draw it, kernels against impl="ref"
    y, _ = batch()
    sigma = edm.sample_sigma_in_qrange(gen, (DIT_BATCH, 1, 1), dit.db,
                                       *PT.block_qrange(dit.db, 0),
                                       device=dev)
    eps = torch.randn(y.shape, generator=gen, device=dev)
    out["crosscheck"] = block_crosscheck(
        params, dit.ranges[0], lambda impl: DIT.make_db_step(dit, 0, tcfg,
                                                             impl=impl),
        (y,), {"sigma": sigma, "eps": eps},
        dit_step_counts(dit.ranges[0][1]), "DiT-S/2",
        [("attn", "wq"), ("mlp", "wi"), ("adaln", "w")])
    del params
    torch.cuda.empty_cache()
    return out


def phase_huginn(dev) -> dict:
    """Phase 11: Huginn at full width, fp32, MarkovLM batches of 8 x 512."""
    from repro_torch.configs import paper
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import edm
    from repro_torch.core import partition as PT
    from repro_torch.core import recurrent as REC
    from repro_torch.data import MarkovLM
    t0 = time.perf_counter()
    m = REC.RecurrentDepthModel(paper.HUGINN, paper.HUGINN_DB,
                                prelude=paper.HUGINN_PRELUDE_LAYERS,
                                coda=paper.HUGINN_CODA_LAYERS,
                                recurrence=paper.HUGINN_RECURRENCE,
                                bptt_k=HUGINN_BPTT)
    cfg = m.cfg
    gen = torch.Generator(device=dev).manual_seed(0)
    params = m.init(gen)
    for k in ("w", "b"):
        params["core"]["adaln"][k].normal_(0.0, 0.02, generator=gen)
    n_params = sum(p.numel() for _, p in _leaves(params))
    data = MarkovLM(vocab_size=cfg.vocab_size, seed=7).iterator(
        TRAIN_BATCH, TRAIN_SEQ)
    batch = lambda: torch.as_tensor(next(data), device=dev)  # noqa: E731
    tcfg = TrainConfig(steps=100, warmup_steps=10, lr=1e-4)
    P_, C_, L_, K_ = (paper.HUGINN_PRELUDE_LAYERS, paper.HUGINN_CODA_LAYERS,
                      cfg.n_layers, m.K)
    say(f"[huginn] {cfg.name}: prelude {P_}, core {L_} x K={K_} (bptt_k "
        f"{m.bptt_k}), coda {C_}; d={cfg.d_model} heads={cfg.n_heads} "
        f"hd={cfg.head_dim} ff={cfg.d_ff} vocab={cfg.vocab_size} "
        f"norm={cfg.norm} mlp={cfg.mlp}; {n_params / 1e6:.2f} M params fp32 "
        f"made in {time.perf_counter() - t0:.1f} s; MarkovLM batches "
        f"{TRAIN_BATCH}x{TRAIN_SEQ}")
    fwd_k = P_ + K_ * L_ + C_
    bwd_k = P_ + m.bptt_k * L_ + C_
    expect = {"db_loss": expected_counts(**{n: P_ + L_ + C_ for n in ATTN}),
              "baseline_loss": expected_counts(
                  flash_attention_fwd=fwd_k, flash_attention_bwd_dq=bwd_k,
                  flash_attention_bwd_dkv=bwd_k)}
    out = {"launches": {}}
    for loss_name in ("db_loss", "baseline_loss"):
        init, step = REC.make_step(getattr(m, loss_name), tcfg)
        state = init(params)
        step(params, state, batch(), gen)
        tokens = batch()
        (res, wall, dev_ms, peak, base, counts) = timed_step(
            lambda: step(params, state, tokens, gen)[2:])
        loss, met = res
        say(f"[huginn] {loss_name} step: loss {float(loss):.4f} | grad norm "
            f"{float(met['grad_norm']):.3f} | wall {wall * 1e3:.1f} ms | "
            f"device {dev_ms:.1f} ms (events) | peak {peak / 2**30:.2f} GiB "
            f"(resident before {base / 2**30:.2f}) | launches {counts}")
        check_counts(f"Huginn {loss_name}", counts, expect[loss_name])
        if not math.isfinite(float(loss)):
            raise SmokeError(f"Huginn {loss_name}: loss {float(loss)}")
        add_counts(out["launches"], counts)
        out[loss_name] = {"loss": float(loss), "wall_s": wall,
                          "device_ms": dev_ms, "peak_bytes": peak}
        out[f"{loss_name}_profile"] = profile_step(
            f"Huginn {loss_name} step",
            lambda: step(params, state, tokens, gen))
        del state
        torch.cuda.empty_cache()
    base, db = out["baseline_loss"], out["db_loss"]
    say(f"[huginn] baseline / db step: wall "
        f"{base['wall_s'] / db['wall_s']:.2f}x, device "
        f"{base['device_ms'] / db['device_ms']:.2f}x")

    # fp32 cross-check of each step at 8 x 512, kernels against impl="ref"
    tokens = batch()
    shape = (TRAIN_BATCH, TRAIN_SEQ, cfg.d_model)
    q_lo, q_hi = (float(PT.q_of_sigma(s, m.db))
                  for s in (m.db.sigma_min, m.db.sigma_max))
    draws = {"db_loss": {
        "sigma": edm.sample_sigma_in_qrange(gen, (TRAIN_BATCH, 1, 1), m.db,
                                            q_lo, q_hi, device=dev),
        "eps": torch.randn(shape, generator=gen, device=dev)},
        "baseline_loss": {"s0": m.db.sigma_data * torch.randn(
            shape, generator=gen, device=dev)}}
    # the baseline runs the core unconditioned: its AdaLN gets no gradient
    grads = {"db_loss": [("attn", "wq"), ("mlp", "wg"), ("adaln", "w")],
             "baseline_loss": [("attn", "wq"), ("mlp", "wg")]}
    out["crosscheck"] = {name: block_crosscheck(
        params, None,
        lambda impl, name=name: REC.make_step(getattr(m, name), tcfg, impl),
        (tokens,), draws[name], expect[name], f"Huginn {name}", grads[name],
        stack="core") for name in ("db_loss", "baseline_loss")}

    tokens = batch()
    m.db_generate_logits(params, tokens, num_steps=2, generator=gen)
    z0 = m.db.sigma_max * torch.randn(TRAIN_BATCH, TRAIN_SEQ, cfg.d_model,
                                      generator=gen, device=dev)
    (logits, wall, dev_ms, peak, base, counts) = timed_step(
        lambda: m.db_generate_logits(params, tokens, z0=z0))
    check_counts("Huginn db_generate_logits", counts, expected_counts(
        flash_attention_fwd=fwd_k, euler_fwd=K_))
    if tuple(logits.shape) != (TRAIN_BATCH, TRAIN_SEQ, cfg.vocab_size) \
            or not torch.isfinite(logits).all():
        raise SmokeError("Huginn db_generate_logits: logits not finite or of "
                         f"shape {tuple(logits.shape)}")
    logp = torch.log_softmax(logits.float(), -1)
    ce = -torch.gather(logp, -1, tokens[..., None])[..., 0].mean().item()
    add_counts(out["launches"], counts)
    say(f"[huginn] db_generate_logits, {K_} Euler steps: wall "
        f"{wall * 1e3:.1f} ms | device {dev_ms:.1f} ms (events) | peak "
        f"{peak / 2**30:.2f} GiB | teacher-forced CE (untrained) {ce:.4f} | "
        f"launches {counts}")
    ref = m.db_generate_logits(params, tokens, z0=z0, impl="ref")
    rel = logits_gap(f"Huginn db_generate_logits, {K_} steps", logits, ref)
    out["generate"] = {"wall_s": wall, "device_ms": dev_ms, "ce": ce,
                       "logits_rel": rel}
    del params, logits, ref
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# 12. ViT, 13. masked diffusion at full width
# ---------------------------------------------------------------------------

def vit_step_counts(size: int) -> dict:
    """Launches of one ViT training step over ``size`` layers: per layer
    one attention forward, dq and dk/dv (``full``, hd 32); the σ embedding
    modulates the label token only (``cond_mask``), so no AdaLN kernel."""
    return expected_counts(**{n: size for n in ATTN})


def phase_vit(dev) -> dict:
    """Phase 12: the ViT classifier (paper §5.1) at full width, fp32,
    ``GaussianMixtureImages`` batches of 128 32x32x3 images (100 classes,
    patch 4: 66 tokens)."""
    from repro_torch.configs import paper
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import edm
    from repro_torch.core import partition as PT
    from repro_torch.core import vit as VIT
    from repro_torch.data import GaussianMixtureImages
    t0 = time.perf_counter()
    vit = VIT.ViTDiffusionBlocks(paper.VIT_CIFAR, paper.VIT_DB)
    cfg = vit.cfg
    gen = torch.Generator(device=dev).manual_seed(0)
    params = vit.init(gen)
    # AdaLN heads are zero at init: randomise them so the σ conditioning of
    # the label token does real work
    for k in ("w", "b"):
        params["layers"]["adaln"][k].normal_(0.0, 0.02, generator=gen)
    n_params = sum(p.numel() for _, p in _leaves(params))
    data = GaussianMixtureImages(num_classes=vit.num_classes,
                                 image_size=vit.image_size).iterator(
        VIT_BATCH)

    def batch():
        x, y = next(data)
        return (torch.as_tensor(x, device=dev),
                torch.as_tensor(y, device=dev), gen)
    tcfg = TrainConfig(steps=100, warmup_steps=10, lr=1e-4)
    S = vit.n_patches + 2
    say(f"[vit] {cfg.name}: {cfg.n_layers} layers d={cfg.d_model} "
        f"heads={cfg.n_heads} hd={cfg.head_dim} ff={cfg.d_ff} "
        f"classes={vit.num_classes} norm={cfg.norm} mlp={cfg.mlp}, "
        f"{vit.db.num_blocks} blocks {vit.ranges}; {vit.image_size}x"
        f"{vit.image_size}x{vit.channels} images, patch {vit.patch}: {S} "
        f"tokens; {n_params / 1e6:.2f} M params fp32 made in "
        f"{time.perf_counter() - t0:.1f} s; fp32, GaussianMixtureImages "
        f"batches of {VIT_BATCH}")
    out = adapter_steps("vit", params, vit.ranges, cfg.n_layers,
                        lambda b: VIT.make_db_step(vit, b, tcfg),
                        lambda: VIT.make_e2e_step(vit, tcfg), batch,
                        vit_step_counts)

    x, y, _ = batch()
    vit.predict(params, x, 2, generator=gen)
    z0 = vit.db.sigma_max * torch.randn(VIT_BATCH, 1, cfg.d_model,
                                        generator=gen, device=dev)
    sched = PT.sampling_schedule(vit.db, VIT_STEPS)[:-1]
    evals = sum(vit.ranges[PT.block_of_sigma(vit.db, float(s))][1]
                for s in sched)
    ((pred, logits), wall, dev_ms, peak, base, got) = timed_step(
        lambda: vit.predict(params, x, VIT_STEPS, z0=z0))
    check_counts("ViT predict", got, expected_counts(
        flash_attention_fwd=evals, euler_fwd=VIT_STEPS))
    if tuple(logits.shape) != (VIT_BATCH, vit.num_classes) \
            or not torch.isfinite(logits).all():
        raise SmokeError("ViT predict: logits not finite or of shape "
                         f"{tuple(logits.shape)}")
    add_counts(out["launches"], got)
    acc = VIT.accuracy(pred, y.cpu())
    say(f"[vit] predict, {VIT_BATCH} images, {VIT_STEPS} Euler steps "
        f"({evals} layer evaluations): wall {wall * 1e3:.1f} ms | device "
        f"{dev_ms:.1f} ms (events) | peak {peak / 2**30:.2f} GiB | accuracy "
        f"after {vit.db.num_blocks + 2} DB and 3 e2e steps (sanity only) "
        f"{acc:.4f} | launches {got}")
    out["predict_profile"] = profile_step(
        "vit: predict", lambda: vit.predict(params, x, VIT_STEPS, z0=z0))
    ref = vit.predict(params, x, VIT_STEPS, z0=z0, impl="ref")[1]
    rel = logits_gap(f"ViT predict, {VIT_STEPS} steps", logits, ref)
    ((pred_e, logits_e), wall_e, dev_e, _, _, got) = timed_step(
        lambda: vit.predict_e2e(params, x))
    check_counts("ViT predict_e2e", got, expected_counts(
        flash_attention_fwd=cfg.n_layers))
    if not torch.isfinite(logits_e).all():
        raise SmokeError("ViT predict_e2e: logits not finite")
    add_counts(out["launches"], got)
    acc_e = VIT.accuracy(pred_e, y.cpu())
    say(f"[vit] predict_e2e, {VIT_BATCH} images ({cfg.n_layers} layers): "
        f"wall {wall_e * 1e3:.1f} ms | device {dev_e:.1f} ms (events) | "
        f"accuracy (sanity only) {acc_e:.4f} | launches {got}")
    out["predict"] = {"wall_s": wall, "device_ms": dev_ms, "evals": evals,
                      "accuracy": acc, "logits_rel": rel,
                      "e2e_accuracy": acc_e}

    # fp32 cross-check: one DB step on block 0, σ from block 0's range
    sigma = edm.sample_sigma_in_qrange(gen, (VIT_BATCH, 1, 1), vit.db,
                                       *PT.block_qrange(vit.db, 0),
                                       device=dev)
    eps = torch.randn(VIT_BATCH, 1, cfg.d_model, generator=gen, device=dev)
    out["crosscheck"] = block_crosscheck(
        params, vit.ranges[0], lambda impl: VIT.make_db_step(vit, 0, tcfg,
                                                             impl=impl),
        (x, y), {"sigma": sigma, "eps": eps},
        vit_step_counts(vit.ranges[0][1]), "ViT",
        [("attn", "wq"), ("mlp", "wi"), ("adaln", "w")])
    say(f"[vit] phase 12 took {time.perf_counter() - t0:.1f} s")
    del params
    torch.cuda.empty_cache()
    return out


def mdm_step_counts(size: int) -> dict:
    """Launches of one MDM training step over ``size`` layers: per layer one
    attention forward, dq and dk/dv (``full``, hd 64) and two gate-residual
    forwards and backwards (the t embedding on every position, no
    ``cond_mask``; the LayerNorm is parametric, so no ln-modulate)."""
    return expected_counts(**{n: size for n in ATTN},
                           gate_residual=2 * size,
                           gate_residual_bwd=2 * size)


def phase_mdm(dev) -> dict:
    """Phase 13: the masked-diffusion LM (paper §5.3) at full width, fp32,
    ``MarkovLM`` (31 symbols + [MASK]) batches of 64 x 256."""
    from repro_torch.configs import paper
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import masked as MASK
    from repro_torch.data import MarkovLM
    t0 = time.perf_counter()
    mdm = MASK.MaskedDiffusionBlocks(paper.MDM, paper.MDM_DB)
    cfg = mdm.cfg
    gen = torch.Generator(device=dev).manual_seed(0)
    params = mdm.init(gen)
    for k in ("w", "b"):
        params["layers"]["adaln"][k].normal_(0.0, 0.02, generator=gen)
    n_params = sum(p.numel() for _, p in _leaves(params))
    lm = MarkovLM(vocab_size=mdm.mask_id, seed=4)
    data = lm.iterator(MDM_BATCH, MDM_SEQ)

    def batch():
        return (torch.as_tensor(next(data), device=dev), gen)
    tcfg = TrainConfig(steps=100, warmup_steps=10, lr=1e-4)
    say(f"[mdm] {cfg.name}: {cfg.n_layers} layers d={cfg.d_model} "
        f"heads={cfg.n_heads} hd={cfg.head_dim} ff={cfg.d_ff} "
        f"vocab={cfg.vocab_size} ([MASK] {mdm.mask_id}) norm={cfg.norm} "
        f"mlp={cfg.mlp}, {mdm.db.num_blocks} blocks {mdm.ranges}; "
        f"{n_params / 1e6:.2f} M params fp32 made in "
        f"{time.perf_counter() - t0:.1f} s; MarkovLM batches "
        f"{MDM_BATCH}x{MDM_SEQ}")
    out = adapter_steps("mdm", params, mdm.ranges, cfg.n_layers,
                        lambda b: MASK.make_db_step(mdm, b, tcfg),
                        lambda: MASK.make_e2e_step(mdm, tcfg), batch,
                        mdm_step_counts)

    tokens, _ = batch()
    evals = sum(size for _, size in mdm.ranges)
    (bpc, wall, dev_ms, _, _, got) = timed_step(
        lambda: mdm.nelbo_bpc(params, tokens, gen, n_samples=2))
    check_counts("MDM nelbo_bpc", got, expected_counts(
        flash_attention_fwd=2 * evals, gate_residual=4 * evals))
    bpc = float(bpc)
    if not math.isfinite(bpc):
        raise SmokeError(f"MDM nelbo_bpc: {bpc}")
    add_counts(out["launches"], got)
    floor = -lm.log_likelihood(tokens.cpu().numpy())
    say(f"[mdm] nelbo_bpc, 2 samples x {mdm.db.num_blocks} blocks over "
        f"{MDM_BATCH}x{MDM_SEQ}: {bpc:.4f} bits/char after "
        f"{mdm.db.num_blocks + 2} DB and 3 e2e steps (sanity only; the "
        f"chain's entropy floor {floor:.4f}) | wall {wall * 1e3:.1f} ms | "
        f"device {dev_ms:.1f} ms (events) | launches {got}")

    n = mdm.db.num_sampling_steps
    times = MASK.sampler_times(n)
    gen_evals = sum(mdm.ranges[mdm.block_of_t(max(float(t), 1e-3))][1]
                    for t in times[:-1]) + mdm.ranges[-1][1]
    mdm.generate(params, MDM_GEN, MDM_SEQ, 2, generator=gen)
    (x, wall, dev_ms, peak, _, got) = timed_step(
        lambda: mdm.generate(params, MDM_GEN, MDM_SEQ, generator=gen))
    check_counts("MDM generate", got, expected_counts(
        flash_attention_fwd=gen_evals, gate_residual=2 * gen_evals))
    if tuple(x.shape) != (MDM_GEN, MDM_SEQ):
        raise SmokeError(f"MDM generate: tokens of shape {tuple(x.shape)}")
    add_counts(out["launches"], got)
    xs = x.cpu().numpy()
    left = int((xs == mdm.mask_id).sum())
    legal = (f"{lm.transition_accuracy(xs):.4f}" if left == 0
             else f"n/a ({left} [MASK] tokens sampled)")
    say(f"[mdm] generate {MDM_GEN}x{MDM_SEQ}, {n} steps + the final fill "
        f"({gen_evals} layer evaluations): wall {wall * 1e3:.1f} ms | device "
        f"{dev_ms:.1f} ms (events) | peak {peak / 2**30:.2f} GiB | legal "
        f"transitions (sanity only) {legal} | launches {got}")
    out["eval"] = {"bpc": bpc, "entropy_floor": floor,
                   "generate_wall_s": wall, "generate_device_ms": dev_ms}
    out["generate_profile"] = profile_step(
        "mdm: generate", lambda: mdm.generate(params, MDM_GEN, MDM_SEQ,
                                              generator=gen))

    # fp32 cross-check: one DB step on block 0, t from block 0's range
    lo, hi = mdm.t_range(0)
    t = lo + (hi - lo) * torch.rand(MDM_BATCH, 1, generator=gen, device=dev)
    u = torch.rand(MDM_BATCH, MDM_SEQ, generator=gen, device=dev)
    out["crosscheck"] = block_crosscheck(
        params, mdm.ranges[0], lambda impl: MASK.make_db_step(mdm, 0, tcfg,
                                                              impl=impl),
        (tokens,), {"t": t, "u": u}, mdm_step_counts(mdm.ranges[0][1]),
        "MDM", [("attn", "wq"), ("mlp", "wi"), ("adaln", "w")])
    say(f"[mdm] phase 13 took {time.perf_counter() - t0:.1f} s")
    del params
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------

SOURCES = {
    "flash_decode": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                     "src/repro/kernels/flash_decode.py:51"),
    "flash_prefill": ("src/repro_torch/kernels/csrc/flash_prefill.cu",
                      "src/repro/kernels/flash_prefill.py:52"),
    "gate_residual": ("src/repro_torch/kernels/csrc/gate_residual.cu",
                      "src/repro/kernels/fused_adaln.py:137"),
    "gate_residual_bwd": ("src/repro_torch/kernels/csrc/gate_residual.cu",
                          "src/repro/kernels/fused_adaln.py:143"),
    "ln_modulate_fwd": ("src/repro_torch/kernels/csrc/ln_modulate.cu",
                        "src/repro/kernels/fused_adaln.py:43"),
    "ln_modulate_bwd": ("src/repro_torch/kernels/csrc/ln_modulate.cu",
                        "src/repro/kernels/fused_adaln.py:53"),
    "edm_loss_fwd": ("src/repro_torch/kernels/csrc/edm_loss.cu",
                     "src/repro/kernels/edm_loss.py:41"),
    "edm_loss_bwd": ("src/repro_torch/kernels/csrc/edm_loss.cu",
                     "src/repro/kernels/edm_loss.py:58"),
    "euler_fwd": ("src/repro_torch/kernels/csrc/euler.cu",
                  "src/repro/kernels/fused_adaln.py:214"),
    "euler_bwd": ("src/repro_torch/kernels/csrc/euler.cu",
                  "src/repro/kernels/fused_adaln.py:221"),
    "flash_attention_fwd": (
        "src/repro_torch/kernels/csrc/flash_attention_fwd.cu",
        "src/repro/kernels/flash_attention.py:101"),
    "flash_attention_bwd_dq": (
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "src/repro/kernels/flash_attention.py:195"),
    "flash_attention_bwd_dkv": (
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "src/repro/kernels/flash_attention.py:228"),
}
# ---------------------------------------------------------------------------
# 14. the fault-tolerant training system: the block-parallel engine at full
#     width (14a), the TrainRunner with checkpoints and faults (14b)
# ---------------------------------------------------------------------------

def _clone(tree):
    from repro_torch.nn.init import tree_map
    return tree_map(lambda _, x: x.clone(), tree)


def _equal(a, b) -> bool:
    from repro_torch.nn.init import tree_items
    return all(torch.equal(x, y) for (_, x), (_, y) in
               zip(tree_items(a), tree_items(b)))


def _bits(tree) -> int:
    """An exact integer sum of a tree's bits (any changed element changes
    it, short of a cancellation)."""
    from repro_torch.nn.init import tree_items
    return int(sum(x.detach().view(torch.int32).sum(dtype=torch.int64)
                   for _, x in tree_items(tree)
                   if x.dtype == torch.float32))


def bp_batch_counts(dbm, active: int) -> dict:
    """Launches of one engine batch: each active block update is one DB
    step of its block (the engine's blocks are equal-sized)."""
    one = db_step_counts(dbm, dbm.ranges[0][1])
    return {n: c * active for n, c in one.items()}


def phase_block_parallel(dev, train) -> dict:
    """Phase 14a: ``BlockParallelTrainer`` (round-robin) at stablelm-1.6b
    full width and depth, 4 blocks of 6 layers, bf16 policy with fp32
    masters, ``MarkovStream`` 8 x 512 through ``HostDataLoader``,
    replicate+psum-mean: a warm-up batch, a timed batch (CUDA events, peak
    memory), a profiled batch (device-busy share) and a batch with a NaN
    injected into block 2's loss; launch counts of each block update equal
    to one DB step's."""
    from repro_torch import kernels as K
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import HostDataLoader, MarkovLM
    from repro_torch.parallel import BlockParallelTrainer
    t0 = time.perf_counter()
    cfg, dbm, params, gen = build_model(dev)
    tcfg = TrainConfig(steps=100, warmup_steps=10, lr=1e-4)
    tr = BlockParallelTrainer(dbm, tcfg, precision="bf16")
    B, u = tr.B, tr.u
    state = tr.init_state(params)
    data = HostDataLoader(MarkovLM(vocab_size=cfg.vocab_size, seed=7).stream(
        TRAIN_BATCH, TRAIN_SEQ), device=dev)
    torch.cuda.synchronize()
    say(f"[block-parallel] {cfg.name} full width, {B} blocks of {u} layers, "
        f"bf16 policy, {tr.policy}, MarkovStream {TRAIN_BATCH}x{TRAIN_SEQ} "
        f"through HostDataLoader; masters + every block's and the "
        f"periphery's AdamW state resident: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB (made in "
        f"{time.perf_counter() - t0:.1f} s)")
    expect = bp_batch_counts(dbm, B)
    out = {"launches": {}}
    try:
        state, losses, _ = tr.step(state, next(data), gen)
        say(f"[block-parallel] warm-up batch: losses "
            f"{[round(float(x), 4) for x in losses]}")
        tokens = next(data)
        (res, wall, dev_ms, peak, base, counts) = timed_step(
            lambda: tr.step(state, tokens, gen))
        state, losses, gnorms = res
        check_counts("block-parallel batch", counts, expect)
        if not torch.isfinite(losses).all():
            raise SmokeError(f"block-parallel batch: losses {losses}")
        add_counts(out["launches"], counts)
        db_wall = statistics.median(r["wall_s"] for r in train["db"]) * 1e3
        say(f"[block-parallel] batch ({B} block updates): losses "
            f"{[round(float(x), 4) for x in losses]} | grad norms "
            f"{[round(float(x), 3) for x in gnorms]} | wall "
            f"{wall * 1e3:.1f} ms ({wall * 1e3 / B:.1f} ms per block update;"
            f" phase 6's DB step {db_wall:.1f} ms) | device {dev_ms:.1f} ms "
            f"(events) | peak {peak / 2**30:.2f} GiB (resident before "
            f"{base / 2**30:.2f}) | launches {counts}")
        tokens = next(data)
        wall_p, busy, top = device_busy(lambda: tr.step(state, tokens, gen),
                                        top=8)
        say(f"[profile] block-parallel batch: wall {wall_p:.1f} ms under the "
            f"profiler, device busy {busy:.1f} ms "
            f"({100 * busy / wall_p:.1f}%)")
        for ms, count, key in top:
            say(f"[profile]   {ms:8.2f} ms  x{count:<5d} {key[:90]}")

        # grad_nan on block 2: its stack, moments and step counter stay
        # bit-unchanged, the others and the periphery move
        victim = 2
        stack_v, opt_v = tr.block_trees(state, victim)
        kept = (_clone(stack_v), _clone(opt_v.mu), _clone(opt_v.nu),
                int(opt_v.step))
        others = [_bits(tr.block_trees(state, b)[0]) for b in range(B)]
        steps0 = state.stack_opt.step.tolist()
        periph0, pstep0 = _bits(state.periph), int(state.periph_opt.step)
        mult = [1.0] * B
        mult[victim] = float("nan")
        tokens = next(data)
        K.reset_launch_counts()
        state, losses, _ = tr.step(state, tokens, gen, loss_mult=mult)
        torch.cuda.synchronize()
        counts = K.launch_counts()
        check_counts("block-parallel grad_nan batch", counts, expect)
        add_counts(out["launches"], counts)
        stack_v, opt_v = tr.block_trees(state, victim)
        moved = [_bits(tr.block_trees(state, b)[0]) != others[b]
                 for b in range(B)]
        ok = (tr.last_ok.tolist() == [b != victim for b in range(B)]
              and _equal(stack_v, kept[0]) and _equal(opt_v.mu, kept[1])
              and _equal(opt_v.nu, kept[2]) and int(opt_v.step) == kept[3]
              and moved == [b != victim for b in range(B)]
              and state.stack_opt.step.tolist()
              == [s + (b != victim) for b, s in enumerate(steps0)]
              and _bits(state.periph) != periph0
              and int(state.periph_opt.step) == pstep0 + 1)
        say(f"[block-parallel] grad_nan on block {victim}: losses "
            f"{[round(float(x), 4) for x in losses]} | last_ok "
            f"{tr.last_ok.tolist()} | block {victim} stack, moments and step "
            f"counter bit-unchanged: {_equal(stack_v, kept[0])}, "
            f"{_equal(opt_v.mu, kept[1]) and _equal(opt_v.nu, kept[2])}, "
            f"{int(opt_v.step)} == {kept[3]} | blocks moved {moved} | step "
            f"counters {state.stack_opt.step.tolist()} | periphery moved: "
            f"{_bits(state.periph) != periph0} (step {pstep0} -> "
            f"{int(state.periph_opt.step)})")
        if not ok:
            raise SmokeError("block-parallel grad_nan: the guard did not "
                             "skip exactly the victim block")
        del kept
    finally:
        data.close()
    say(f"[block-parallel] peak memory: engine batch {peak / 2**30:.2f} GiB "
        f"vs phase 6's train_db {train['train_db']['peak_bytes'] / 2**30:.2f}"
        f" GiB and e2e step {train['e2e']['peak_bytes'] / 2**30:.2f} GiB; "
        f"nvidia-smi (sm MHz, W, limit, C): "
        f"{gpu_query('clocks.sm,power.draw,power.limit,temperature.gpu')}")
    out.update(wall_s=wall, device_ms=dev_ms, peak_bytes=peak,
               busy_share=busy / wall_p)
    del state, tr, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def runner_model(dev, n_layers: int, blocks: int):
    """stablelm-1.6b's widths and vocabulary with ``n_layers`` layers in
    ``blocks`` blocks, random weights from seed 0 (AdaLN heads
    randomised)."""
    from repro_torch.configs import DBConfig, get_config
    from repro_torch.core.blocks import DiffusionBlocksModel
    cfg = dataclasses.replace(get_config(ARCH), n_layers=n_layers)
    dbm = DiffusionBlocksModel(cfg, DBConfig(num_blocks=blocks,
                                             overlap_gamma=0.1))
    gen = torch.Generator(device=dev).manual_seed(0)
    params = dbm.init(gen)
    for k in ("w", "b"):
        params["layers"]["adaln"][k].normal_(0.0, 0.02, generator=gen)
    return dbm, params


def phase_block_parallel_crosscheck(dev) -> dict:
    """Phase 14a's fp32 batch at reduced depth (stablelm widths, 4 layers,
    4 blocks of 1) through the kernels against ``impl="ref"``, from the same
    params and draws: per-block losses within 1e-3 relative, every updated
    param within 1e-3, the first block's attention first moments within
    1e-3 of their largest."""
    from repro_torch import kernels as K
    from repro_torch.configs.base import TrainConfig
    from repro_torch.nn.init import tree_items
    from repro_torch.parallel import BlockParallelTrainer
    dbm, master = runner_model(dev, 4, 4)
    gen = torch.Generator(device=dev).manual_seed(5)
    Bsz = TRAIN_BATCH // 2
    tokens = torch.randint(0, dbm.cfg.vocab_size, (Bsz, TRAIN_SEQ),
                           generator=gen, device=dev)
    draws = [(dbm.sample_block_sigma(gen, (Bsz, 1, 1), b, device=dev),
              torch.randn(Bsz, TRAIN_SEQ, dbm.cfg.d_model, generator=gen,
                          device=dev)) for b in range(dbm.num_blocks)]
    tcfg = TrainConfig(steps=100, warmup_steps=10, lr=1e-4)
    res = {}
    for impl in ("kernels", "ref"):
        params = _clone(master)
        tr = BlockParallelTrainer(dbm, tcfg, impl=impl, precision="fp32")
        K.reset_launch_counts()
        state, losses, _ = tr.step(tr.init_state(params), tokens,
                                   draws=draws)
        torch.cuda.synchronize()
        check_counts(f"block-parallel cross-check impl={impl}",
                     K.launch_counts(), bp_batch_counts(dbm, dbm.num_blocks)
                     if impl == "kernels" else expected_counts())
        res[impl] = (losses, params,
                     {k: v[0].clone() for k, v in
                      state.stack_opt.mu["layers"]["attn"].items()})
        del state, tr
    (lk, pk, mk), (lr_, pr, mr) = res["kernels"], res["ref"]
    loss_rel = ((lk - lr_).abs() / lr_.abs()).max().item()
    param_diff = max((a - b).abs().max().item() for (_, a), (_, b) in
                     zip(tree_items(pk), tree_items(pr)))
    mom_rel = max(((mk[k] - mr[k]).abs().max() / mr[k].abs().max()).item()
                  for k in mr)
    say(f"[crosscheck] block-parallel fp32 batch (stablelm widths, 4 blocks "
        f"of 1 layer), kernels vs plain versions: losses "
        f"{[round(float(x), 6) for x in lk]} vs "
        f"{[round(float(x), 6) for x in lr_]} (rel max {loss_rel:.2e}) | "
        f"params max|diff| {param_diff:.2e} | block 0 attention first "
        f"moments rel {mom_rel:.2e}; limit 1e-3")
    del res, pk, pr, master
    torch.cuda.empty_cache()
    if not (loss_rel <= 1e-3 and param_diff <= 1e-3 and mom_rel <= 1e-3):
        raise SmokeError("block-parallel fp32 cross-check: kernels and plain "
                         "versions disagree")
    return {"loss_rel": loss_rel, "param_diff": param_diff,
            "moment_rel": mom_rel}


# phase 14b's fault spec (block-parallel, 6 batches of 4 block updates,
# checkpoints every 2 batches, 2 kept): a NaN loss on block 0 in batch 0,
# block 0's pod dead in batch 1 (rewound to generation 1, back in batch 2)
# and the third save (batch 4) torn; the kill after batch 5 then resumes
# past that generation from batch 2's
RUNNER_FAULTS = {"grad_nan": {"at": [1]}, "pod_die": {"at": [2]},
                 "ckpt_corrupt": {"at": [3]}}
RUNNER_COUNTERS = {"pod_deaths": 1, "readoptions": 1, "rewinds": 0,
                   "restarts": 0, "data_stalls": 0, "nan_injected": 1,
                   "degraded_batches": 1, "ckpt_saves": 4}
RUNNER_BATCHES, RUNNER_HALT = 6, 5


def _ckpt_lines(tag, mgr) -> list:
    rows = []
    for t in mgr.timings:
        rows.append(t)
        say(f"[runner] {tag} {t['op']} generation {t['generation']}: "
            f"{t['bytes'] / 1e9:.2f} GB in {t['seconds']:.1f} s "
            f"({t['bytes'] / 1e9 / t['seconds']:.2f} GB/s; sha256 "
            f"{t['sha256_s']:.1f} s)")
    return rows


def phase_runner(dev) -> dict:
    """Phase 14b: ``TrainRunner`` at stablelm's widths and vocabulary with 4
    layers, bf16 policy, ``MarkovStream`` through ``HostDataLoader``,
    checkpoints in a temporary directory on the machine's disk (deleted at
    the end). block-parallel (4 blocks of 1): the uninterrupted run under
    ``RUNNER_FAULTS`` (its counters must be ``RUNNER_COUNTERS``), the same
    run killed after batch 5, and its resume, which must fall back past the
    torn generation and end bit-equal to the uninterrupted run (params,
    every moment and step counter, history, heartbeats, guard state). db
    (2 blocks of 2 layers): one ``pod_die`` restart from generation 1, then
    a kill after step 3."""
    import shutil
    import tempfile
    from repro_torch import kernels as K
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import HostDataLoader, MarkovLM, MarkovStream
    from repro_torch.launch.faults import make_injector
    from repro_torch.launch.trainrunner import TrainRunner
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    say(f"[runner] checkpoints under {root} (free "
        f"{shutil.disk_usage(root).free / 1e9:.1f} GB)")
    out = {"launches": {}, "ckpt": []}
    try:
        dbm, master = runner_model(dev, 4, 4)
        lm = MarkovLM(vocab_size=dbm.cfg.vocab_size, seed=7)

        def make_data(cur):
            src = (lm.stream(TRAIN_BATCH, TRAIN_SEQ) if cur is None
                   else MarkovStream.from_cursor(cur))
            return HostDataLoader(src, device=dev)

        def run(tag, d, faults, mode="block-parallel", model=None, steps=None,
                **kw):
            dbm_, master_ = model or (dbm, master)
            params = _clone(master_)
            tcfg = TrainConfig(
                steps=steps or RUNNER_BATCHES * dbm_.num_blocks,
                warmup_steps=2, lr=1e-4, log_every=0)
            r = TrainRunner(dbm_, tcfg, mode=mode, precision="bf16",
                            ckpt_dir=os.path.join(root, d),
                            ckpt_every=kw.pop("ckpt_every", 2), keep=2,
                            faults=make_injector(faults),
                            pod_restart_after=1, max_restarts=1, log=say)
            gen = torch.Generator(device=dev).manual_seed(1)
            K.reset_launch_counts()
            t0 = time.perf_counter()
            _, hist = r.train(make_data, gen, params=params, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            add_counts(out["launches"], K.launch_counts())
            out["ckpt"] += _ckpt_lines(tag, r.manager)
            say(f"[runner] {tag}: {len(hist)} block updates in {wall:.1f} s "
                f"| counters {r.counters} | heartbeats {r.heartbeats}")
            if not all(math.isfinite(x) or i == 0 for i, (_, _, x)
                       in enumerate(hist)):
                raise SmokeError(f"runner {tag}: a non-finite loss past the "
                                 f"injected one: {hist}")
            return r, params, hist

        a, pa, ha = run("uninterrupted", "a", RUNNER_FAULTS)
        if a.counters != RUNNER_COUNTERS:
            raise SmokeError(f"runner counters {a.counters} != the fault "
                             f"spec's {RUNNER_COUNTERS}")
        shutil.rmtree(os.path.join(root, "a"))
        run("killed", "b", RUNNER_FAULTS, halt_after=RUNNER_HALT)
        c, pc, hc = run("resumed", "b", None, resume=True)
        B = dbm.num_blocks
        checks = {
            "params": _equal(pa, pc),
            "stack moments": _equal(a.state.stack_opt.mu, c.state.stack_opt.mu)
            and _equal(a.state.stack_opt.nu, c.state.stack_opt.nu),
            "step counters": torch.equal(a.state.stack_opt.step,
                                         c.state.stack_opt.step),
            "periphery moments": _equal(a.state.periph_opt.mu,
                                        c.state.periph_opt.mu)
            and _equal(a.state.periph_opt.nu, c.state.periph_opt.nu)
            and int(a.state.periph_opt.step) == int(c.state.periph_opt.step),
            "history": hc == ha[2 * B:],
            "heartbeats": a.heartbeats == c.heartbeats,
            "guard": a.trainer.guard_state() == c.trainer.guard_state(),
            "fell back past the torn generation":
                c.manager.timings[0]["generation"] == 2}
        say(f"[runner] kill after batch {RUNNER_HALT} + resume vs "
            f"uninterrupted, bit-equal: {checks}")
        if not all(checks.values()):
            raise SmokeError(f"runner resume is not bit-identical: {checks}")
        out["resume"] = checks
        del a, c, pa, pc, master
        shutil.rmtree(os.path.join(root, "b"))
        gc.collect()
        torch.cuda.empty_cache()

        # db: generation 1, a restart from it at step 1, then a kill after
        # step 3 of 4 (no final save: one save and one load of 13.7 GB)
        model = runner_model(dev, 4, 2)
        r, _, hist = run("db", "db", {"pod_die": {"at": [2]}}, mode="db",
                         model=model, steps=4, ckpt_every=100, halt_after=3)
        if r.counters["restarts"] != 1 or len(hist) != 4:
            raise SmokeError(f"runner db: restarts {r.counters['restarts']},"
                             f" {len(hist)} steps (expected 1 and 4)")
        del r, model
    finally:
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    return out


# kernels no main path launches: the samplers run under no_grad, so the
# Euler backward is held against its plain version in phase 3 only
OFF_PATH = {"euler_bwd"}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run on the "
              "card", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    dev = torch.device("cuda", 0)
    t_all = time.perf_counter()
    phase_device()
    phase_build()
    rows = phase_kernels(dev)
    rows.update(phase_rowwise(dev))
    rows.update(phase_attention(dev))
    rows.update(phase_euler(dev))
    serve = phase_serve(dev)
    model = serve.pop("model")
    phase_profile(dev, model)
    phase_crosscheck(dev, model)
    phase_crosscheck_bf16(dev, model)
    continuous = phase_continuous(dev, model)
    server = phase_server(dev, model, continuous)
    train = phase_train(dev, model)
    db_crosscheck(dev, model, "concat ce", [("attn", "wq")])
    del model                      # stablelm's masters and caches
    gc.collect()
    torch.cuda.empty_cache()
    two_pass = phase_two_pass(dev)
    model = two_pass.pop("model")
    db_crosscheck(dev, model, "two-pass l2",
                  [("attn", "wq"), ("mlp", "wg"), ("adaln", "w")])
    del model
    gc.collect()
    torch.cuda.empty_cache()
    dit = phase_dit(dev)
    huginn = phase_huginn(dev)
    vit = phase_vit(dev)
    mdm = phase_mdm(dev)
    block_parallel = phase_block_parallel(dev, train)
    phase_block_parallel_crosscheck(dev)
    runner = phase_runner(dev)
    launches = {}
    for counts in (serve["counts"], continuous["counts"], server["counts"],
                   train["launches"],
                   two_pass["launches"], dit["launches"],
                   huginn["launches"], vit["launches"], mdm["launches"],
                   block_parallel["launches"], runner["launches"]):
        add_counts(launches, counts)
    missing = sorted(n for n in SOURCES
                     if n not in OFF_PATH and launches.get(n, 0) == 0)
    if missing or sorted(rows) != sorted(SOURCES):
        raise SmokeError(f"kernels not launched on the main path: {missing}"
                         f"; checked in phase 3: {sorted(rows)}")
    kernels = []
    for name, cases in rows.items():
        main_case = cases[0]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name][0],
            "replaces": SOURCES[name][1], "launches": launches.get(name, 0),
            **{k: main_case.get(k) for k in (
                "max_abs_err", "ms", "eager_ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms", "library_spread_ms")},
            "case": main_case["case"], "cases": cases[1:]})
    say(f"[done] all phases passed in {time.perf_counter() - t_all:.1f} s")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
