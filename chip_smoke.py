#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases, each fatal on failure:
  1. device: needs CUDA; prints the card's name and power limit; TF32 off
     (fp32 products stay fp32, or fp32 parity would mean nothing);
  2. build: compiles the three kernels from ``src/repro_torch/kernels/csrc``
     (one nvcc each, in parallel) and prints ``-Xptxas -v``'s summary;
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the serving path's shapes (max |err| <= 2e-4 + 2e-4 |ref|: fp32 outputs
     from identical inputs, summed in another order), timed with CUDA events
     beside its bound and the plain version;
  4. serve: stablelm-1.6b at full width (24 layers, d=2048), DEFAULT_DB
     (4 blocks), random weights from seed 0 with the AdaLN heads randomised,
     bf16 policy, greedy, 8 requests with prompts padded to 512 (ragged
     128-512), chunk 64, 32 new tokens; the launch counters of that run must
     equal the path's arithmetic;
  5. cross-check: one fp32 serve step from the same prefilled pool and z,
     through the kernels and through their plain versions; logits must
     agree to 1e-3 relative.

Prints one JSON line ``{"kernels": [...]}`` and, last, ``{"ok": true,
"device": {...}}``. Exits non-zero without a CUDA device or without the
repository's ``src`` beside it.
"""
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "build" / "chip_smoke"      # full -Xptxas -v logs
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
PEAK_BF16 = 989e12             # dense tensor-core bf16
PEAK_FP32 = 67e12              # fp32 outside the tensor cores
TOL = 2e-4
ARCH = "stablelm-1.6b"
BATCH, PROMPT, CHUNK, MAX_NEW, PSZ = 8, 512, 64, 32, 16


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


def device_ms(fn, n_inputs: int, calls: int = 16, reps: int = 10) -> float:
    """Device ms per call of fn(i): ``calls`` calls captured in one CUDA
    graph, replayed ``reps`` times between CUDA events, so no host time is
    counted. Inputs cycle over n_inputs copies that together exceed the
    50 MB L2, so each call finds its pages cold, as on the serving path."""
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
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * calls)


def compare(name: str, got, want) -> float:
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    worst = 0.0
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        if not torch.isfinite(g).all():
            raise SmokeError(f"{name}: kernel output is not finite")
        err = (g - w).abs()
        worst = max(worst, err.max().item())
        if (err > TOL + TOL * w.abs()).any():
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
    tensor_core_type = q.dtype == torch.bfloat16
    return nbytes, flops, PEAK_BF16 if tensor_core_type else PEAK_FP32


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
               lengths, dev, gen, C=1):
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.kernels import flash_prefill as FP
    npg = -(-(PROMPT + MAX_NEW) // PSZ)
    P = 1 + BATCH * npg
    prefill = kind == "flash_prefill"
    kern, ref = ((FP.flash_prefill, FP.flash_prefill_ref) if prefill
                 else (FD.flash_decode, FD.flash_decode_ref))
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    table = (1 + torch.randperm(BATCH * npg, generator=gen, device=dev)
             ).to(torch.int32).reshape(BATCH, npg)
    qshape = (BATCH, C, KV, G, hd) if prefill else (BATCH, KV, G, hd)
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
    say(f"[kernels] {label}: max|err| {err:.2e} | kernel {ms:.4f} ms device "
        f"({e_ms:.4f} ms per eager call) | bound {bound_ms:.4f} ms ({by}; "
        f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP) | plain "
        f"{plain_ms:.3f} ms | library none")
    return row


def gate_case(label, shape, x_dtype, gate_dtype, dev, gen):
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
    ms, e_ms = device_ms(call_k, 1, calls=64), eager_ms(call_k, 1, iters=200)
    plain_ms = device_ms(lambda i: AD.gate_residual_ref(res, br, gate), 1,
                         calls=64)
    g1 = 1.0 + gate[:, None, :].to(x_dtype)
    library_ms = device_ms(lambda i: torch.addcmul(res, br, g1), 1, calls=64)
    nbytes = 3 * res.numel() * res.element_size() + B * d * \
        gate.element_size()
    flops = 2 * res.numel()
    bound_ms, by = bound(nbytes, flops, PEAK_FP32)
    say(f"[kernels] {label}: max|err| {err:.2e} | kernel {ms:.4f} ms device "
        f"({e_ms:.4f} ms per eager call) | bound {bound_ms:.5f} ms ({by}; "
        f"{nbytes / 1e6:.3f} MB) | plain {plain_ms:.4f} ms | library "
        f"(addcmul, 1+gate made outside) {library_ms:.4f} ms")
    return {"case": label, "max_abs_err": err, "ms": ms, "eager_ms": e_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
            "library_ms": library_ms, "bytes": nbytes, "flops": flops}


def phase_kernels(dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(1)
    ragged = [0, 128, 200, 333, 416, 480, 511, 544]
    starts = [0, 64, 128, 192, 256, 320, 384, 448]
    rows = {"flash_decode": [], "flash_prefill": [], "gate_residual": []}
    bf16, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    # (a) decode at stablelm widths: the probe's fp32 q, the commit's bf16 q
    rows["flash_decode"].append(paged_case(
        "(a) decode B=8 KV=32 G=1 hd=64 bf16 pages, fp32 q (probe)",
        "flash_decode", KV=32, G=1, hd=64, page_dtype=bf16, q_dtype=f32,
        window=None, lengths=ragged, dev=dev, gen=gen))
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
    # (c) prefill at stablelm widths (commit_prompt_chunk: bf16 q)
    rows["flash_prefill"].insert(0, paged_case(
        "(c) prefill C=64 B=8 KV=32 G=1 hd=64 bf16 pages, bf16 q",
        "flash_prefill", KV=32, G=1, hd=64, page_dtype=bf16, q_dtype=bf16,
        window=None, lengths=starts, dev=dev, gen=gen, C=CHUNK))
    # (d) gate-residual: the probe's (8,1,2048) fp32, a (8,64,2048) bf16
    rows["gate_residual"].append(gate_case(
        "(d) gate_residual (8,1,2048) fp32, fp32 gate slice", (8, 1, 2048),
        f32, f32, dev, gen))
    rows["gate_residual"].append(gate_case(
        "(d) gate_residual (8,64,2048) bf16, bf16 gate slice", (8, 64, 2048),
        bf16, bf16, dev, gen))
    return rows


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


def prompts_np(vocab: int):
    import numpy as np
    rs = np.random.RandomState(0)
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
    expect = {"flash_decode": MAX_NEW * 2 * L,
              "gate_residual": MAX_NEW * 2 * L,
              "flash_prefill": -(-PROMPT // CHUNK) * L}
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


def device_busy(fn):
    """Run fn() under torch.profiler: (wall ms under the profiler, summed
    device-kernel ms, the top kernels by device time). One stream, so the
    kernel sum is the device's busy time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        rows.append((us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    return wall, sum(r[0] for r in rows), rows[:6]


def phase_profile(dev, model) -> dict:
    """Where a full-width bf16 step's time goes: device busy share of the
    prefill (8 chunks) and of 4 decode steps, and the top kernels."""
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
    for name, fn in (("prefill, 8 chunks", prefill),
                     ("decode, 4 steps", decode)):
        wall, busy, top = device_busy(fn)
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


def phase_crosscheck(dev, model) -> dict:
    from repro_torch.launch.serve import get_engine
    from repro_torch.nn import cache as KVC
    dbm, params, gen = model
    prompts, plens = prompts_np(dbm.cfg.vocab_size)
    eng = get_engine(dbm, precision="fp32", chunk_size=CHUNK)
    pps = KVC.pages_for(PROMPT + MAX_NEW, PSZ)
    kv = dbm.model.init_paged_cache(BATCH, 1 + BATCH * pps, PSZ, eng.pol,
                                    device=dev)
    table = KVC.identity_page_table(BATCH, pps, device=dev)
    kv, lengths = eng.run_prefill(
        params, kv, table, torch.zeros(BATCH, dtype=torch.int32, device=dev),
        torch.as_tensor(prompts, device=dev),
        torch.as_tensor(plens, dtype=torch.int32, device=dev))
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
    return {"logits_rel": rel, "pool_rel": pool_rel}


# ---------------------------------------------------------------------------

SOURCES = {
    "flash_decode": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                     "src/repro/kernels/flash_decode.py:51"),
    "flash_prefill": ("src/repro_torch/kernels/csrc/flash_prefill.cu",
                      "src/repro/kernels/flash_prefill.py:52"),
    "gate_residual": ("src/repro_torch/kernels/csrc/gate_residual.cu",
                      "src/repro/kernels/fused_adaln.py:137"),
}


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
    serve = phase_serve(dev)
    model = serve.pop("model")
    phase_profile(dev, model)
    phase_crosscheck(dev, model)
    kernels = []
    for name, cases in rows.items():
        main_case = cases[0]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name][0],
            "replaces": SOURCES[name][1], "launches": serve["counts"][name],
            **{k: main_case[k] for k in ("max_abs_err", "ms", "eager_ms",
                                         "plain_ms", "bound_ms", "bound_by",
                                         "library_ms")},
            "case": main_case["case"], "cases": cases[1:]})
    say(f"[done] all phases passed in {time.perf_counter() - t_all:.1f} s")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
