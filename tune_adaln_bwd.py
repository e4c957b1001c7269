"""Time the AdaLN backward kernels (``ln_mod_bwd_kernel`` in
``src/repro_torch/kernels/csrc/ln_modulate.cu``, ``gate_residual_bwd_kernel``
in ``gate_residual.cu``) of one or more source trees on one card, at
``chip_smoke.py`` phase 3's cases: the two-pass path's (8, 512, 2048) in
bf16 and fp32, its ragged S = 130, and, for the gate, DiT-S/2's
(256, 256, 384) fp32.

    python3 tune_adaln_bwd.py [SRC ...]
    python3 tune_adaln_bwd.py --variants

Each SRC is a directory holding ``repro_torch`` (default: this checkout's
``src``). The trees are timed in the order given, each in a process of its
own (its kernels build into its own ``build/``), so ``parent change change
parent`` compares two trees in turns on one card. For each tree and case:
max |err| against the plain version (``chip_smoke.compare``); the
wrapper's device ms by CUDA-graph replay over input sets that exceed the
L2 (``chip_smoke.device_trials``: the median of 5 readings, and their
least and most); and, from ``torch.profiler`` over 20 eager calls, the
device ms a call of the backward kernel alone and of every other kernel
the wrapper launches (a partial-sum reduction, a cast).

``--variants`` times this checkout's ``src`` beside copies of it under
``build/tune_adaln_bwd/`` with one design choice replaced as text
(``VARIANTS``): clusters of 4 or 1 tile, a 3-step ring for the ln rows, the
gate without whole-example spans, and, for timing only (its sums are
wrong, so it is not checked), the cross-cluster ticket stage removed.
Needs a CUDA card and ``nvcc``; exits 2 without a card.
"""
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
BF16, F32 = torch.bfloat16, torch.float32
# (kernel, B, S, d, dtype, label)
CASES = [("ln", 8, 512, 2048, BF16, "main (8,512,2048) bf16"),
         ("ln", 8, 512, 2048, F32, "(8,512,2048) fp32"),
         ("ln", 8, 130, 2048, BF16, "ragged (8,130,2048) bf16"),
         ("gate", 8, 512, 2048, BF16, "main (8,512,2048) bf16"),
         ("gate", 8, 512, 2048, F32, "(8,512,2048) fp32"),
         ("gate", 8, 130, 2048, BF16, "ragged (8,130,2048) bf16"),
         ("gate", 256, 256, 384, F32, "DiT-S/2 (256,256,384) fp32")]
KERNEL_NAMES = {"ln": "ln_mod_bwd_kernel", "gate": "gate_residual_bwd_kernel"}
PROFILED_CALLS = 20
CSRC = Path("repro_torch") / "kernels" / "csrc"
# name -> (checked against the plain version, [(file, committed text,
# variant text)])
VARIANTS = {
    "clusters_of_4": (True, [("rowwise.cuh", "kMaxCluster = 2;",
                              "kMaxCluster = 4;")]),
    "clusters_of_1": (True, [("rowwise.cuh", "kMaxCluster = 2;",
                              "kMaxCluster = 1;")]),
    "ln_ring_of_3": (True, [("ln_modulate.cu", "kStages = 2;",
                             "kStages = 3;")]),
    "gate_tiles_only": (True, [("gate_residual.cu",
                                "if (10LL * bc * ((dv + c - 1) / c) >= "
                                "9 * wave) whole = c;", "(void)c;")]),
    "no_ticket": (False, [("rowwise.cuh", "      if (cs.n_clusters == 1)\n",
                           "      if (true)\n"),
                          ("rowwise.cuh", "  if (cs.n_clusters > 1) {\n",
                           "  if (false) {\n")]),
}


def profile(call, n, name):
    """(kernel ms, other ms) a call, from the profiler's device times."""
    act = torch.profiler.ProfilerActivity.CUDA
    call(0)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[act]) as prof:
        for i in range(PROFILED_CALLS):
            call(i % n)
        torch.cuda.synchronize()
    kern = other = 0.0
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        if name in ev.key:
            kern += us
        else:
            other += us
    return kern / 1e3 / PROFILED_CALLS, other / 1e3 / PROFILED_CALLS


def make_variant(name: str) -> Path:
    """A copy of this checkout's src with VARIANTS[name]'s replacements."""
    dst = ROOT / "build" / "tune_adaln_bwd" / name / "src"
    shutil.rmtree(dst.parent, ignore_errors=True)
    shutil.copytree(ROOT / "src", dst,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for fname, old, new in VARIANTS[name][1]:
        f = dst / CSRC / fname
        text = f.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"variant {name}: {old!r} is not once in {f}")
        f.write_text(text.replace(old, new))
    return dst


def one_tree(src: str, check: bool = True) -> dict:
    sys.path.insert(0, src)
    import chip_smoke as CS
    from repro_torch.kernels import fused_adaln as AD
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(3)
    out = []
    for kind, B, S, d, dt, label in CASES:
        sets = CS.adaln_sets(gen, dev, B, S, d, dt)
        if kind == "ln":
            kern = lambda x, sc, sh, g: AD.ln_modulate_bwd(x, sc, g)
            ref = lambda x, sc, sh, g: AD.ln_modulate_bwd_ref(x, sc, g)
        else:
            kern = lambda x, sc, sh, g: AD.gate_residual_bwd(x, sc, g)
            ref = lambda x, sc, sh, g: AD.gate_residual_bwd_ref(x, sc, g)
        got = kern(*sets[0])
        torch.cuda.synchronize()
        err = CS.compare(f"{kind} {label}", got, ref(*sets[0]),
                         bf16_rounding=True) if check else float("nan")
        call = lambda i: kern(*sets[i])
        readings = CS.device_trials(call, len(sets), trials=5)
        k_ms, o_ms = profile(call, len(sets), KERNEL_NAMES[kind])
        out.append({"kernel": kind, "case": label, "max_abs_err": err,
                    "ms": statistics.median(readings),
                    "ms_min": min(readings), "ms_max": max(readings),
                    "kernel_ms": k_ms, "other_ms": o_ms})
        del sets
        torch.cuda.empty_cache()
    return {"src": src, "cases": out}


def main() -> int:
    if len(sys.argv) >= 3 and sys.argv[1] == "--one":
        print(json.dumps(one_tree(sys.argv[2], "--unchecked" not in
                                  sys.argv)), flush=True)
        return 0
    if not torch.cuda.is_available():
        print("tune_adaln_bwd: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[tune] {torch.cuda.get_device_name(0)} | {smi}", flush=True)
    trees = [(src, True) for src in sys.argv[1:] or [str(ROOT / "src")]]
    if sys.argv[1:] == ["--variants"]:
        trees = [(str(ROOT / "src"), True)] + [
            (str(make_variant(n)), VARIANTS[n][0]) for n in VARIANTS]
    runs = []
    for src, check in trees:
        proc = subprocess.run([sys.executable, __file__, "--one",
                               str(Path(src).resolve())]
                              + ([] if check else ["--unchecked"]),
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return 1
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append(run)
        for c in run["cases"]:
            print(f"[tune] {src} | {c['kernel']} {c['case']}: "
                  f"{c['ms']:.5f} ms (readings {c['ms_min']:.5f}-"
                  f"{c['ms_max']:.5f}) | profiler: kernel "
                  f"{c['kernel_ms']:.5f} ms, other launches "
                  f"{c['other_ms']:.5f} ms | max|err| "
                  f"{c['max_abs_err']:.2e}", flush=True)
    print(json.dumps({"runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
