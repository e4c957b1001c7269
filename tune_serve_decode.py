"""Time the static engine's decode (``DecodeEngine.generate``) of one or
more source trees on one card, at ``chip_smoke.py`` phase 4's
configuration: stablelm-1.6b at full width, bf16 policy, greedy, 8
requests with prompts padded to 512 (``chip_smoke.prompts_np``), chunk
64, 32 new tokens.

    python3 tune_serve_decode.py [SRC ...]

Each SRC is a directory holding ``repro_torch`` (default: this checkout's
``src``). The trees are timed in the order given, each in a process of its
own (its kernels build into its own ``build/``), so ``parent change change
parent`` compares two trees in turns on one card. Per tree: one warm-up
generate of 2 tokens, then RUNS generates; each reports its wall, its
prefill ms and its decode ms per step (``last_timing``, CUDA events), and
the tree's line gives their medians and ranges. Needs a CUDA card and
``nvcc``; exits 2 without a card.
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
RUNS = 5


def one_tree(src: str) -> dict:
    sys.path.insert(0, src)
    sys.path.insert(1, str(ROOT))
    import chip_smoke as CS
    from repro_torch.launch.serve import get_engine
    dev = torch.device("cuda", 0)
    cfg, dbm, params, gen = CS.build_model(dev)
    prompts, plens = CS.prompts_np(cfg.vocab_size)
    eng = get_engine(dbm, precision="bf16", chunk_size=CS.CHUNK)
    eng.generate(params, prompts, 2, prompt_lengths=plens, generator=gen)
    runs = []
    for _ in range(RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.generate(params, prompts, CS.MAX_NEW, prompt_lengths=plens,
                     generator=gen)
        wall = time.perf_counter() - t0
        tim = eng.last_timing
        runs.append({"wall_s": wall, "prefill_ms": tim["prefill_ms"],
                     "decode_ms_per_step": (tim["total_ms"]
                                            - tim["prefill_ms"])
                     / CS.MAX_NEW})
        eng.last_kv = None
    return {"src": src, "runs": runs}


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps(one_tree(sys.argv[2])), flush=True)
        return 0
    if not torch.cuda.is_available():
        print("tune_serve_decode: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[tune] {torch.cuda.get_device_name(0)} | {smi}", flush=True)
    for src in sys.argv[1:] or [str(ROOT / "src")]:
        proc = subprocess.run([sys.executable, __file__, "--one",
                               str(Path(src).resolve())],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return 1
        runs = json.loads(proc.stdout.strip().splitlines()[-1])["runs"]
        parts = []
        for key in ("decode_ms_per_step", "prefill_ms", "wall_s"):
            xs = [r[key] for r in runs]
            parts.append(f"{key} {statistics.median(xs):.3f} "
                         f"({min(xs):.3f}-{max(xs):.3f})")
        print(f"[tune] {src} | {RUNS} runs: " + " | ".join(parts),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
