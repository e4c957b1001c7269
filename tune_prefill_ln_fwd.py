"""Time the 3xTF32 chunked-prefill route (``prefill_tf32_kernel`` in
``src/repro_torch/kernels/csrc/flash_prefill.cu``; before it, the CUDA-core
``paged_attention_kernel``) and the ln-modulate forward
(``ln_mod_fwd_kernel`` in ``ln_modulate.cu``) of one or more source trees
on one card, at ``chip_smoke.py``'s cases.

    python3 tune_prefill_ln_fwd.py [SRC ...]
    python3 tune_prefill_ln_fwd.py --variants

Each SRC is a directory holding ``repro_torch`` (default: this checkout's
``src``). The trees are timed in the order given, each in a process of its
own (its kernels build into its own ``build/``), so ``parent change change
parent`` compares two trees in turns on one card. Cases: prefill (c) of
phase 3 (C=64, B=8, KV=32, G=1, hd 64, chunks at 0..448) with fp32 q over
fp32 pages (the fp32 policy), over int8 pages (fp32_kvint8), and bf16 q
over bf16 pages (the tensor-core route, unchanged: a control); the
ln-modulate forward at the two-pass path's (8, 512, 2048) in bf16 and fp32
and at a ragged S = 130. Each case is checked against its plain version
(``chip_smoke.compare``) and timed by CUDA-graph replay over input sets
that exceed the L2 (``chip_smoke.device_trials``: the median of 5
readings, and their least and most). Last, stablelm-1.6b at full width:
the fp32 policy's prefill of phase 4's prompts (8 chunks of 64 over 24
layers, ``chip_smoke.fp32_prefill``) under torch.profiler, after a
warm-up, 3 times: device busy ms and the ms of its prefill attention
kernels (median).

``--variants`` times this checkout's ``src`` beside copies of it under
``build/tune_prefill_ln_fwd/`` with one design choice replaced as text
(``VARIANTS``), kernel cases only: for ``prefill_tf32_kernel`` one K/V
stage at hd 64, Q's fragments split at every key tile instead of held in
registers, and both with a third block an SM; for the ln-modulate forward
a third block an SM (the plan's cap, which the backwards share), 4 rows a
step always and 8 rows a step always (the committed rule takes 8 where
they fill a wave). Needs a CUDA card and ``nvcc``; exits 2 without a card.
"""
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
BF16, F32, I8 = torch.bfloat16, torch.float32, torch.int8
# (label, q dtype, page dtype): prefill (c)
PREFILL_CASES = [("prefill (c) fp32 q, fp32 pages", F32, F32),
                 ("prefill (c) fp32 q, int8 pages", F32, I8),
                 ("prefill (c) bf16 q, bf16 pages (tc, control)", BF16,
                  BF16)]
# (label, B, S, d, dtype): the ln-modulate forward
LN_CASES = [("ln fwd main (8,512,2048) bf16", 8, 512, 2048, BF16),
            ("ln fwd (8,512,2048) fp32", 8, 512, 2048, F32),
            ("ln fwd ragged (8,130,2048) bf16", 8, 130, 2048, BF16)]
TRIALS = 5
PREFILL_RUNS = 3
CSRC = Path("repro_torch") / "kernels" / "csrc"
_ST = ("  static constexpr int ST = PX ? 1 : (HD == 64 ? 2 : 1);",
       "  static constexpr int ST = 1;")
_QREG = ("  constexpr bool QREG = HD == 64;", "  constexpr bool QREG = false;")
# name -> [(file under CSRC, committed text, variant text)]
VARIANTS = {
    "tf32_one_stage": [("flash_prefill.cu", *_ST)],
    "tf32_q_split_each_tile": [("flash_prefill.cu", *_QREG)],
    "tf32_3_blocks": [("flash_prefill.cu", *_ST), ("flash_prefill.cu", *_QREG),
                      ("flash_prefill.cu",
                       "__launch_bounds__(kPThreads, 2)\n    prefill_tf32",
                       "__launch_bounds__(kPThreads, 3)\n    prefill_tf32")],
    "ln_3_blocks": [("rowwise.cuh", "constexpr int kBlocksPerSM = 2;",
                     "constexpr int kBlocksPerSM = 3;")],
    "ln_4_rows": [("ln_modulate.cu",
                   "return launch_fwd<T, TM, V, PV, U8>(a, p, bc, sizes);",
                   "return launch_fwd<T, TM, V, PV, U4>(a, p, bc, sizes);")],
    "ln_8_rows": [("ln_modulate.cu",
                   "  return launch_fwd<T, TM, V, PV, U4>(a, p, bc, sizes);",
                   "  return launch_fwd<T, TM, V, PV, U8>(a, p, bc, sizes);")],
}


def timed(CS, label, kern, ref, n_sets) -> dict:
    """Check call 0 against its plain version, then time every set."""
    got = kern(0)
    torch.cuda.synchronize()
    err = CS.compare(label, got, ref(0), bf16_rounding=True)
    readings = CS.device_trials(kern, n_sets, trials=TRIALS)
    return {"case": label, "max_abs_err": err,
            "ms": statistics.median(readings), "ms_min": min(readings),
            "ms_max": max(readings)}


def prefill_cases(CS, FP, dev) -> list:
    out = []
    B, KV, G, hd, C = 8, 32, 1, 64, CS.CHUNK
    lens = torch.tensor([0, 64, 128, 192, 256, 320, 384, 448],
                        dtype=torch.int32, device=dev)
    npg = -(-(CS.PROMPT + CS.MAX_NEW) // CS.PSZ)
    P = 1 + B * npg
    for label, q_dtype, page_dtype in PREFILL_CASES:
        gen = torch.Generator(device=dev).manual_seed(1)
        table = (1 + torch.randperm(B * npg, generator=gen, device=dev)
                 ).to(torch.int32).reshape(B, npg)
        one = CS.make_pool(gen, page_dtype, P, KV, hd, dev)
        nbytes = sum(t.numel() * t.element_size() for t in one
                     if t is not None)
        sets = [one] + [CS.make_pool(gen, page_dtype, P, KV, hd, dev)
                        for _ in range(CS.rotations(nbytes) - 1)]
        q = torch.randn(B, C, KV, G, hd, generator=gen, device=dev).to(
            q_dtype)
        call = lambda fn: lambda i: fn(  # noqa: E731
            q, sets[i][0], sets[i][1], table, lens, k_scale=sets[i][2],
            v_scale=sets[i][3])
        row = timed(CS, label, call(FP.flash_prefill),
                    call(FP.flash_prefill_ref), len(sets))
        row["route"] = FP.prefill_route(q_dtype, page_dtype)
        out.append(row)
        del sets
        torch.cuda.empty_cache()
    return out


def ln_cases(CS, AD, dev) -> list:
    out = []
    gen = torch.Generator(device=dev).manual_seed(3)
    for label, B, S, d, dt in LN_CASES:
        sets = CS.adaln_sets(gen, dev, B, S, d, dt)
        out.append(timed(
            CS, label, lambda i: AD.ln_modulate_fwd(*sets[i][:3]),
            lambda i: AD.ln_modulate_ref(*sets[i][:3]), len(sets)))
        del sets
        torch.cuda.empty_cache()
    return out


def serve_prefill(CS, dev) -> dict:
    model = CS.build_model(dev)[1:]
    CS.fp32_prefill(dev, model, "kernels")         # warm-up
    runs = [CS.fp32_prefill(dev, model, "kernels", profiled=True)[3]
            for _ in range(PREFILL_RUNS)]
    return {k: statistics.median(r[k] for r in runs)
            for k in ("device_ms", "attention_ms", "wall_ms")} | {
        "device_ms_all": [r["device_ms"] for r in runs],
        "attention_ms_all": [r["attention_ms"] for r in runs],
        "attention_launches": runs[0]["attention_launches"]}


def make_variant(name: str) -> Path:
    """A copy of this checkout's src with VARIANTS[name]'s replacements."""
    dst = ROOT / "build" / "tune_prefill_ln_fwd" / name / "src"
    shutil.rmtree(dst.parent, ignore_errors=True)
    shutil.copytree(ROOT / "src", dst,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for fname, old, new in VARIANTS[name]:
        f = dst / CSRC / fname
        text = f.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"variant {name}: {old!r} is not once in {f}")
        f.write_text(text.replace(old, new))
    return dst


def one_tree(src: str, kernels_only: bool) -> dict:
    sys.path.insert(0, src)
    sys.path.insert(1, str(ROOT))
    import chip_smoke as CS
    from repro_torch.kernels import flash_prefill as FP
    from repro_torch.kernels import fused_adaln as AD
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cases = prefill_cases(CS, FP, dev) + ln_cases(CS, AD, dev)
    return {"src": src, "cases": cases, "fp32_prefill":
            None if kernels_only else serve_prefill(CS, dev)}


def main() -> int:
    if len(sys.argv) >= 3 and sys.argv[1] == "--one":
        print(json.dumps(one_tree(sys.argv[2], "--kernels-only" in
                                  sys.argv)), flush=True)
        return 0
    if not torch.cuda.is_available():
        print("tune_prefill_ln_fwd: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[tune] {torch.cuda.get_device_name(0)} | {smi}", flush=True)
    trees = sys.argv[1:] or [str(ROOT / "src")]
    extra = []
    if sys.argv[1:] == ["--variants"]:
        trees = [str(ROOT / "src")] + [str(make_variant(n))
                                       for n in VARIANTS]
        extra = ["--kernels-only"]
    runs = []
    for src in trees:
        proc = subprocess.run([sys.executable, __file__, "--one",
                               str(Path(src).resolve())] + extra,
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return 1
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append(run)
        for c in run["cases"]:
            print(f"[tune] {src} | {c['case']}: {c['ms']:.5f} ms (readings "
                  f"{c['ms_min']:.5f}-{c['ms_max']:.5f}) | max|err| "
                  f"{c['max_abs_err']:.2e}", flush=True)
        pf = run["fp32_prefill"]
        if pf is None:
            continue
        print(f"[tune] {src} | fp32 prefill, stablelm-1.6b full width, 8 "
              f"chunks: device busy {pf['device_ms']:.3f} ms "
              f"({pf['device_ms_all']}), prefill attention kernels "
              f"{pf['attention_ms']:.3f} ms ({pf['attention_ms_all']}) in "
              f"{pf['attention_launches']} launches", flush=True)
    print(json.dumps({"runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
