"""Compare build variants of the bf16 tensor-core attention backward
(``dq_tc_kernel`` and ``dkv_tc_kernel`` in
``src/repro_torch/kernels/csrc/flash_attention_bwd.cu``) on one card.

Each variant is the committed source with its tuning constants replaced as
text: the width of a pass over the streamed tile (32 or 64 rows), the
minimum blocks an SM that ``__launch_bounds__`` asks for at hd 64, and
whether the pass loop is unrolled. All variants are built at once (one
``nvcc`` each) into ``build/tune_attention_bwd/``; for each, the script
prints registers and spills of both kernels at hd 64 and 128 (``-Xptxas
-v``), then checks dq and dk/dv against their plain versions under
``chip_smoke.compare``'s bound and times them by CUDA-graph replay at three
of ``chip_smoke.py``'s phase-3 cases. The committed choice is "chosen".

    python3 tune_attention_bwd.py

Needs a CUDA card and ``nvcc``; exits 2 without a card.
"""
import ctypes
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

import chip_smoke as CS

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "tune_attention_bwd"
# name -> (rows a pass, min blocks an SM at hd 64 or None, unrolled)
VARIANTS = {"chosen": (32, 3, False), "p32_minb2": (32, 2, False),
            "p32_minb3_unrolled": (32, 3, True), "p32_nominb": (32, None,
                                                               False),
            "p64_minb2": (64, 2, False), "p64_nominb": (64, None, False)}
CASES = [  # (label, kind, B, H, KV, S, Sk, hd, window, mask_seq)
    ("(e) db_concat B=8 H=32 S=2x512 hd=64", "db_concat", 8, 32, 32, 1024,
     1024, 64, None, 512),
    ("(g) window=256 GQA H=32 KV=8 S=1024 hd=128", "window", 4, 32, 8,
     1024, 1024, 128, 256, None),
    ("(h) causal B=8 H=16 S=512 hd=128", "causal", 8, 16, 16, 512, 512, 128,
     None, None)]


def subst(text: str, old: str, new: str, count: int) -> str:
    if text.count(old) != count:
        raise RuntimeError(f"expected {count} x {old!r} in the source")
    return text.replace(old, new)


def variant_source(src: str, width: int, minb, unrolled: bool) -> str:
    for c in ("QP", "KP"):
        src = subst(src, f"constexpr int {c} = 32;",
                    f"constexpr int {c} = {width};", 1)
    bounds = ("__launch_bounds__(kTcThreads)" if minb is None else
              f"__launch_bounds__(kTcThreads, HD == 64 ? {minb} : 2)")
    src = subst(src, "__launch_bounds__(kTcThreads, HD == 64 ? 3 : 2)",
                bounds, 2)
    if unrolled:
        for v in ("qb", "kb"):
            src = subst(src, f"#pragma unroll 1\n    for (int {v} = 0;",
                        f"#pragma unroll\n    for (int {v} = 0;", 1)
    return src


def build_all() -> dict:
    from repro_torch.kernels import _build
    src = (_build.CSRC / "flash_attention_bwd.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, spec in VARIANTS.items():
        cu = OUT / f"{name}.cu"
        cu.write_text(variant_source(src, *spec))
        so = OUT / f"lib{name}.so"
        # -fno-gnu-unique: the launch helper's function-local statics would
        # otherwise be one process-wide object for every variant loaded,
        # and a later variant would skip its shared-memory attribute
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-Xcompiler",
               "-fno-gnu-unique", f"-I{_build.CSRC}", "-o", str(so), str(cu)]
        procs[name] = (so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        for entry in re.split(r"(?=ptxas info\s*: Compiling entry)", log):
            m = re.search(r"(dq|dkv)_tc_kernelILi(\d+)", entry)
            regs = re.search(r"Used (\d+) registers", entry)
            spill = re.search(r"(\d+) bytes spill stores", entry)
            if m and regs:
                CS.say(f"[build] {name}: {m.group(1)}_tc_kernel<"
                       f"{m.group(2)}> {regs.group(1)} registers, "
                       f"{spill.group(1) if spill else '?'} B spill stores")
        built[name] = so
    return built


def run_cases(dev) -> list:
    from repro_torch.kernels import flash_attention as FA
    gen = torch.Generator(device=dev).manual_seed(2)
    out = []
    for label, kind, B, H, KV, S, Sk, hd, window, mseq in CASES:
        cfg = FA.FlashConfig(kind, window=window, mask_seq=mseq)
        mk = lambda n, L: torch.randn(  # noqa: E731
            B, L, n, hd, generator=gen, device=dev).bfloat16().transpose(1, 2)
        q, k, v, do = mk(H, S), mk(KV, Sk), mk(KV, Sk), mk(H, S)
        o, lse = FA.flash_attention_fwd(q, k, v, cfg)
        delta = FA.attention_delta(o, do)
        want = (FA._bwd_dq_ref(q, k, v, do, lse, delta, cfg),
                FA._bwd_dkv_ref(q, k, v, do, lse, delta, cfg))
        out.append((label, cfg, (q, k, v, do, lse, delta), want))
    return out


def time_variant(FA, what: str, cfg, args, want) -> None:
    """Check (when ``want`` is given) and time dq and dk/dv with the
    library that is loaded now."""
    dq = lambda i: FA.flash_attention_bwd_dq(*args, cfg)  # noqa: E731
    dkv = lambda i: FA.flash_attention_bwd_dkv(*args, cfg)  # noqa: E731
    if want is not None:
        CS.compare(f"dq {what}", dq(0), want[0], bf16_rounding=True)
        CS.compare(f"dk/dv {what}", dkv(0), want[1], bf16_rounding=True)
    CS.say(f"[time] {what}: dq {CS.device_ms(dq, 1, calls=3, reps=3):.4f} "
           f"ms, dk/dv {CS.device_ms(dkv, 1, calls=3, reps=3):.4f} ms")


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as FA
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    CS.say(f"[card] {smi[0] if smi else 'unknown'}")
    t0 = time.perf_counter()
    built = build_all()
    CS.say(f"[build] {len(built)} variants in "
           f"{time.perf_counter() - t0:.1f} s")
    cases = run_cases(dev)
    libs = {name: ctypes.CDLL(str(so)) for name, so in built.items()}
    # two rounds, the second in reverse order, so drift shows as spread
    for rnd, names in enumerate((list(libs), list(libs)[::-1])):
        for name in names:
            _build._LIBS["flash_attention_bwd"] = libs[name]
            FA._FN.pop("rt_flash_attention_bwd_dq", None)
            FA._FN.pop("rt_flash_attention_bwd_dkv", None)
            for label, cfg, args, want in cases:
                time_variant(FA, f"round {rnd + 1} {name} {label}", cfg,
                             args, want if rnd == 0 else None)
    CS.say("[done] every variant agrees with the plain versions")
    return 0


if __name__ == "__main__":
    sys.exit(main())
