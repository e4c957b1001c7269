"""Compare build variants and launch splits of the paged decode kernel
(``paged_decode_kernel`` in ``src/repro_torch/kernels/csrc/flash_decode.cu``)
on one card.

Each build variant is the committed source with the stages of each warp's
K/V ring replaced as text (2, the committed choice, "chosen"; 3). Both are
built at once (one ``nvcc`` each) into ``build/tune_paged_decode/``; the
script prints registers and spills of the instantiations the cases run,
then for each variant, in two rounds (the second in reverse order), checks
and times ``flash_decode`` at ``chip_smoke.py``'s decode cases with
``chip_smoke.paged_case`` (against the plain version under its bound; CUDA-
graph replay, pages cold): (a) probe and commit, (b), and two more at (a)'s
shapes: every slot at 544 keys (uniform), and every slot empty (the fixed
cost of a launch: no tile to load). Then, on the chosen build, the split
of a slot's keys across blocks: (a) probe, and decode at the widths of
the models with fewer (slot, kv head) pairs than the card has SMs (olmo-1b:
KV=16, G=1, hd 128; llama-3.2-vision-11b, phi3.5-moe, grok-1: KV=8, G=4,
hd 128; bf16 pages and q), at phase 4's ragged lengths, at lengths eight
times as long, and one slot of 4096 keys; each with the blocks a pair
forced to 1, 2, 4, 8 and 16 (``decode_splits``; the heuristic's choice
is printed beside).

    python3 tune_paged_decode.py

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
OUT = ROOT / "build" / "tune_paged_decode"
VARIANTS = {"chosen": 2, "three_stages": 3}   # name -> stages of the ring
STAGES_LINE = "constexpr int kStages = 2;"
RAGGED = [0, 128, 200, 333, 416, 480, 511, 544]
SPLITS = (1, 2, 4, 8, 16)
# (label, KV, G, lengths, pages for keys): the split's shapes
SPLIT_CASES = (
    ("(a) probe, KV=32 G=1 hd=64 fp32 q", 32, 1, RAGGED, 544),
    ("olmo-1b KV=16 G=1 hd=128", 16, 1, RAGGED, 544),
    ("KV=8 G=4 hd=128", 8, 4, RAGGED, 544),
    ("olmo-1b KV=16 G=1 hd=128, lengths x8", 16, 1,
     [8 * n for n in RAGGED], 8 * 544),
    ("KV=8 G=4 hd=128, lengths x8", 8, 4, [8 * n for n in RAGGED], 8 * 544),
    ("KV=8 G=4 hd=128, one slot of 4096 keys", 8, 4, [4096], 4096),
)


def variant_source(src: str, stages: int) -> str:
    if src.count(STAGES_LINE) != 1:
        raise RuntimeError(f"expected one {STAGES_LINE!r} in the source")
    return src.replace(STAGES_LINE, f"constexpr int kStages = {stages};")


def build_all() -> dict:
    from repro_torch.kernels import _build
    src = (_build.CSRC / "flash_decode.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, stages in VARIANTS.items():
        cu = OUT / f"{name}.cu"
        cu.write_text(variant_source(src, stages))
        so = OUT / f"lib{name}.so"
        # -fno-gnu-unique: each library keeps its own launch_smem statics
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
            # bf16 hd 64 R 1 (case a), int8 hd 120 R 4 (case b)
            if re.search(r"paged_decode_kernelI(13__nv_bfloat16Li64ELi1E|"
                         r"aLi120ELi4E)", entry):
                CS.say(f"[build] {name}: {CS.ptxas_summary(entry)}")
        built[name] = so
    return built


def cases(dev, tag: str) -> None:
    bf16, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    gen = torch.Generator(device=dev).manual_seed(1)
    common = dict(dev=dev, gen=gen)
    for label, q_dtype, lengths in (
            ("(a) probe, fp32 q", f32, RAGGED),
            ("(a) commit, bf16 q", bf16, RAGGED),
            ("(a) every slot at 544 keys", f32, [544] * 8),
            ("(a) every slot empty", f32, [0] * 8)):
        CS.paged_case(f"{tag} {label}", "flash_decode", KV=32, G=1, hd=64,
                      page_dtype=bf16, q_dtype=q_dtype, window=None,
                      lengths=lengths, **common)
    CS.paged_case(f"{tag} (b) KV=8 G=4 hd=120 window=64 int8",
                  "flash_decode", KV=8, G=4, hd=120, page_dtype=i8,
                  q_dtype=bf16, window=64, lengths=RAGGED, **common)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_decode as FD
    CS.phase_device()
    t0 = time.perf_counter()
    built = build_all()
    CS.say(f"[build] {len(built)} variants in "
           f"{time.perf_counter() - t0:.1f} s")
    libs = {name: ctypes.CDLL(str(so)) for name, so in built.items()}

    def use(name):
        _build._LIBS["flash_decode"] = libs[name]
        FD._FN.pop("fn", None)

    for rnd, names in enumerate((list(libs), list(libs)[::-1])):
        for name in names:
            use(name)
            cases(dev, f"round {rnd + 1} {name}")
    use("chosen")
    heuristic = FD.decode_splits
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    try:
        for label, KV, G, lengths, cap in SPLIT_CASES:
            hd = 64 if KV == 32 else 128
            tiles = FD.max_tiles(-(-cap // CS.PSZ) * CS.PSZ, None)
            pick = heuristic(len(lengths) * KV, tiles, sms)
            for n in SPLITS:
                FD.decode_splits = lambda *args, n=n: n
                CS.paged_case(
                    f"split {n} (heuristic {pick}): {label}", "flash_decode",
                    KV=KV, G=G, hd=hd, page_dtype=torch.bfloat16,
                    q_dtype=torch.float32 if KV == 32 else torch.bfloat16,
                    window=None, lengths=lengths, cap=cap, dev=dev,
                    gen=torch.Generator(device=dev).manual_seed(1))
    finally:
        FD.decode_splits = heuristic
    CS.say("[done] every variant agrees with the plain version")
    return 0


if __name__ == "__main__":
    sys.exit(main())
