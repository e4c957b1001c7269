"""Compare build variants of the tensor-core attention backward (bf16
``dq_tc_kernel`` and ``dkv_tc_kernel``, fp32 ``dq_tf32_kernel`` and
``dkv_tf32_kernel`` in
``src/repro_torch/kernels/csrc/flash_attention_bwd.cu``) on one card.

Each variant is the committed source with its tuning constants replaced as
text: for bf16 the width of a pass over the streamed tile (32 or 64 rows),
the minimum blocks an SM that ``__launch_bounds__`` asks for at hd 64, and
whether the pass loop is unrolled; for fp32 the width of a pass at each
head dim (``kTf32Pass``) and the minimum blocks an SM
(``kTf32MinBlocks``). All variants are built at once (one ``nvcc``
each) into ``build/tune_attention_bwd/``; for each, the script prints
registers and spills of the four kernels at each head dim (``-Xptxas
-v``), then checks dq and dk/dv against their plain versions under
``chip_smoke.compare``'s bound and times them by CUDA-graph replay at nine
of ``chip_smoke.py``'s phase-3 cases (three bf16, six fp32, two of them
zamba2-7b's at hd 112), in two rounds (the second in reverse order).
The committed choice is "chosen".
Last, the committed fp32 kernels' accuracy: dq, dk and dv at a causal
S = 1000, G = 4 case (keys that 4000 query rows see) against the plain
versions and against the plain versions' formulas in fp64, each max error
as a fraction of ``chip_smoke.compare``'s fp32 bound, and per 64-row tile.

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
# name -> (bf16 rows a pass, bf16 min blocks an SM at hd 64 or None, bf16
# pass loop unrolled, fp32 rows a pass and fp32 min blocks an SM, each a
# C++ expression of HD)
TF32_PASS = "HD == 112 ? 16 : 32"    # the committed fp32 pass width
TF32_MINB = "HD == 32 ? 3 : HD == 64 ? 2 : 1"   # the committed minimum
VARIANTS = {"chosen": (32, 3, False, TF32_PASS, TF32_MINB),
            "p32_minb2": (32, 2, False, TF32_PASS, TF32_MINB),
            "p32_minb3_unrolled": (32, 3, True, TF32_PASS, TF32_MINB),
            "p32_nominb": (32, None, False, TF32_PASS, TF32_MINB),
            "p64_minb2": (64, 2, False, TF32_PASS, TF32_MINB),
            "p64_nominb": (64, None, False, TF32_PASS, TF32_MINB),
            "tf32_p64_hd64": (32, 3, False, "HD == 64 ? 64 : 32", TF32_MINB),
            "tf32_p16_hd128": (32, 3, False, "HD == 64 ? 32 : 16",
                               TF32_MINB),
            "tf32_p32_hd112": (32, 3, False, "32", TF32_MINB),
            "tf32_minb2_hd32": (32, 3, False, TF32_PASS,
                                "HD == 128 ? 1 : 2")}
BF16, F32 = torch.bfloat16, torch.float32
CASES = [  # (label, kind, B, H, KV, S, Sk, hd, window, mask_seq, dtype)
    ("(e) db_concat B=8 H=32 S=2x512 hd=64", "db_concat", 8, 32, 32, 1024,
     1024, 64, None, 512, BF16),
    ("(g) window=256 GQA H=32 KV=8 S=1024 hd=128", "window", 4, 32, 8,
     1024, 1024, 128, 256, None, BF16),
    ("(h) causal B=8 H=16 S=512 hd=128", "causal", 8, 16, 16, 512, 512, 128,
     None, None, BF16),
    ("(m) full B=256 H=6 S=256 hd=64 fp32", "full", 256, 6, 6, 256, 256, 64,
     None, None, F32),
    ("(g) window=256 GQA H=32 KV=8 S=1024 hd=128 fp32", "window", 4, 32, 8,
     1024, 1024, 128, 256, None, F32),
    ("(n) db_concat B=8 H=8 S=2x512 hd=64 fp32", "db_concat", 8, 8, 8, 1024,
     1024, 64, None, 512, F32),
    ("(p) full B=128 H=4 S=66 hd=32 fp32", "full", 128, 4, 4, 66, 66, 32,
     None, None, F32),
    ("(z) window=4096 B=4 H=32 S=512 hd=112 fp32", "window", 4, 32, 32,
     512, 512, 112, 4096, None, F32),
    ("(z) two_pass B=4 H=32 Sq=512 Sk=2x512 hd=112 fp32", "two_pass", 4,
     32, 32, 512, 1024, 112, None, 512, F32)]


def subst(text: str, old: str, new: str, count: int) -> str:
    if text.count(old) != count:
        raise RuntimeError(f"expected {count} x {old!r} in the source")
    return text.replace(old, new)


def variant_source(src: str, width: int, minb, unrolled: bool,
                   tf32_pass: str, tf32_minb: str) -> str:
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
    src = subst(src, f"constexpr int kTf32MinBlocks = {TF32_MINB};",
                f"constexpr int kTf32MinBlocks = {tf32_minb};", 1)
    return subst(src, f"constexpr int kTf32Pass = {TF32_PASS};",
                 f"constexpr int kTf32Pass = {tf32_pass};", 1)


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
            m = re.search(r"(dq|dkv)_(tc|tf32)_kernelILi(\d+)E(Lb1)?",
                          entry)
            regs = re.search(r"Used (\d+) registers", entry)
            spill = re.search(r"(\d+) bytes spill stores", entry)
            if m and regs:
                v16 = ", true" if m.group(4) else ""
                CS.say(f"[build] {name}: {m.group(1)}_{m.group(2)}_kernel<"
                       f"{m.group(3)}{v16}> {regs.group(1)} registers, "
                       f"{spill.group(1) if spill else '?'} B spill stores")
        built[name] = so
    return built


def run_cases(dev) -> list:
    from repro_torch.kernels import flash_attention as FA
    gen = torch.Generator(device=dev).manual_seed(2)
    out = []
    for label, kind, B, H, KV, S, Sk, hd, window, mseq, dt in CASES:
        cfg = FA.FlashConfig(kind, window=window, mask_seq=mseq)
        mk = lambda n, L: torch.randn(  # noqa: E731
            B, L, n, hd, generator=gen, device=dev).to(dt).transpose(1, 2)
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


def bwd_fp64(q, k, v, do, lse, delta, cfg):
    """(dq, dk, dv) of the plain versions' formulas evaluated in fp64."""
    from repro_torch.kernels import flash_attention as FA
    q, k, v, do, lse, delta = (x.double() for x in (q, k, v, do, lse, delta))
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    ke, ve = FA._expand_kv(k, H // KV), FA._expand_kv(v, H // KV)
    s = q @ ke.transpose(-1, -2) / hd ** 0.5
    p = torch.where(FA.keep_mask(cfg, Sq, Sk, q.device),
                    torch.exp(s - lse[..., None]), torch.zeros_like(s))
    ds = p * (do @ ve.transpose(-1, -2) - delta[..., None]) / hd ** 0.5
    dk = (ds.transpose(-1, -2) @ q).reshape(B, KV, H // KV, Sk, hd).sum(2)
    dv = (p.transpose(-1, -2) @ do).reshape(B, KV, H // KV, Sk, hd).sum(2)
    return ds @ ke, dk, dv


def accuracy(dev) -> None:
    """The fp32 kernels (the library loaded now) at a causal S = 1000, G = 4
    case on inputs of scale 2, against the plain versions and both against
    fp64: max |err| / (2e-4 + 2e-4 |ref|), and that of each 64-row tile."""
    from repro_torch.kernels import flash_attention as FA
    gen = torch.Generator(device=dev).manual_seed(3)
    cfg = FA.FlashConfig("causal")
    mk = lambda n: 2 * torch.randn(  # noqa: E731
        2, 1000, n, 64, generator=gen, device=dev).transpose(1, 2)
    q, k, v, do = mk(8), mk(2), mk(2), mk(8)
    out, lse = FA.flash_attention_fwd(q, k, v, cfg)
    args = (q, k, v, do, lse, FA.attention_delta(out, do), cfg)
    got = (FA.flash_attention_bwd_dq(*args),) + \
        FA.flash_attention_bwd_dkv(*args)
    plain = (FA._bwd_dq_ref(*args),) + FA._bwd_dkv_ref(*args)
    exact = bwd_fp64(*args)
    share = lambda x, w: ((x.double() - w.double()).abs() / (  # noqa: E731
        CS.TOL + CS.TOL * w.double().abs()))
    for name, g, p, x in zip(("dq", "dk", "dv"), got, plain, exact):
        tiles = share(g, p).amax(dim=(0, 1, 3))
        CS.say(f"[accuracy] causal S=1000 G=4 hd=64 fp32 x2 {name}: kernel "
               f"vs plain {share(g, p).max().item():.3f} of the bound, "
               f"kernel vs fp64 {share(g, x).max().item():.3f}, plain vs "
               f"fp64 {share(p, x).max().item():.3f}; kernel vs plain by "
               "64-row tile " + " ".join(
                   f"{tiles[i:i + 64].max().item():.2f}"
                   for i in range(0, 1000, 64)))


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
    _build._LIBS["flash_attention_bwd"] = libs["chosen"]
    FA._FN.pop("rt_flash_attention_bwd_dq", None)
    FA._FN.pop("rt_flash_attention_bwd_dkv", None)
    accuracy(dev)
    CS.say("[done] every variant agrees with the plain versions")
    return 0


if __name__ == "__main__":
    sys.exit(main())
