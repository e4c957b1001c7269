"""Compare build variants of the fp32 tensor-core attention forward
(``fwd_tf32_kernel`` in
``src/repro_torch/kernels/csrc/flash_attention_fwd.cu``) on one card.

Each variant is the committed source with its tuning choices replaced as
text: the stages of the K/V ring and the blocks an SM that
``__launch_bounds__`` asks for, at each head dim, and whether Q's split
fragments are held in registers across the key loop instead of re-read
from shared memory each tile. All variants are built at once (one ``nvcc``
each) into ``build/tune_attention_fwd/``; for each, the script prints
registers and spills of the kernel at hd 64 and 128 (16-byte copies,
``-Xptxas -v``), then checks the forward against its plain version under
``chip_smoke.compare``'s bound and times it by CUDA-graph replay at four of
``chip_smoke.py``'s phase-3 fp32 cases, in two rounds (the second in
reverse order). The committed choice is "chosen".

    python3 tune_attention_fwd.py

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
OUT = ROOT / "build" / "tune_attention_fwd"
# name -> (K/V stages, min blocks an SM, Q's split fragments in registers),
# the first two as C++ expressions of HD
VARIANTS = {"chosen": ("HD == 128 ? 1 : 2", "2", False),
            "two_stages_hd128": ("2", "HD == 64 ? 2 : 1", False),
            "one_stage_hd64": ("1", "2", False),
            "one_stage_hd64_3_blocks": ("1", "HD == 64 ? 3 : 2", False),
            "q_in_registers": ("HD == 128 ? 1 : 2", "2", True)}
CASES = [  # (label, kind, B, H, KV, S, hd, window, mask_seq)
    ("(m) full B=256 H=6 S=256 hd=64", "full", 256, 6, 6, 256, 64, None,
     None),
    ("(e) db_concat B=8 H=32 S=2x512 hd=64", "db_concat", 8, 32, 32, 1024,
     64, None, 512),
    ("(g) window=256 GQA H=32 KV=8 S=1024 hd=128", "window", 4, 32, 8,
     1024, 128, 256, None),
    ("(n) causal B=8 H=8 S=512 hd=64", "causal", 8, 8, 8, 512, 64, None,
     None)]
# Q's split fragments loaded once, after Q's copies land (its own commit
# group), and read from registers at each k8 step
Q_REGS = [
    ("""    load_tile_async<HD, QP, V16>(Qs, a.q, b, h, q0, a.Sq);
    load_tile_async<HD, QP, V16>(Ks, a.k, b, hk, k0, a.Sk);""",
     """    load_tile_async<HD, QP, V16>(Qs, a.q, b, h, q0, a.Sq);
    rtmma::cp_async_commit();
    load_tile_async<HD, QP, V16>(Ks, a.k, b, hk, k0, a.Sk);"""),
    ("""  const float* qrow = Qs + (warp * 16 + g) * QP + 2 * t;
""", """  const float* qrow = Qs + (warp * 16 + g) * QP + 2 * t;
  uint32_t qb[KS][4], qs[KS][4];
  rtmma::cp_async_wait<1>();
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) q_frag_tf32<QP>(qrow + 8 * kk, qb[kk],
                                                   qs[kk]);
"""),
    ("""      q_frag_tf32<QP>(qrow + 8 * kk, ab, as);
""", """#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ab[e] = qb[kk][e];
        as[e] = qs[kk][e];
      }
""")]


def subst(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"expected one {old!r} in the source")
    return text.replace(old, new)


def variant_source(src: str, stages: str, min_blocks: str,
                   q_regs: bool) -> str:
    src = subst(src, "constexpr int kTf32Stages = HD == 128 ? 1 : 2;",
                f"constexpr int kTf32Stages = {stages};")
    src = subst(src, "__launch_bounds__(kTcThreads, 2)\n    fwd_tf32_kernel",
                f"__launch_bounds__(kTcThreads, {min_blocks})\n"
                "    fwd_tf32_kernel")
    if q_regs:  # at hd 128 too: it spills there, as the build shows
        for old, new in Q_REGS:
            src = subst(src, old, new)
    return src


def build_all() -> dict:
    from repro_torch.kernels import _build
    src = (_build.CSRC / "flash_attention_fwd.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, spec in VARIANTS.items():
        cu = OUT / f"{name}.cu"
        cu.write_text(variant_source(src, *spec))
        so = OUT / f"lib{name}.so"
        # -fno-gnu-unique: see tune_attention_bwd.py (per-variant statics)
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
            m = re.search(r"fwd_tf32_kernelILi(\d+)ELb1E", entry)
            regs = re.search(r"Used (\d+) registers", entry)
            spill = re.search(r"(\d+) bytes spill stores", entry)
            if m and regs:
                CS.say(f"[build] {name}: fwd_tf32_kernel<{m.group(1)}> "
                       f"{regs.group(1)} registers, "
                       f"{spill.group(1) if spill else '?'} B spill stores")
        built[name] = so
    return built


def make_cases(dev) -> list:
    from repro_torch.kernels import flash_attention as FA
    gen = torch.Generator(device=dev).manual_seed(2)
    out = []
    for label, kind, B, H, KV, S, hd, window, mseq in CASES:
        cfg = FA.FlashConfig(kind, window=window, mask_seq=mseq)
        mk = lambda n: torch.randn(  # noqa: E731
            B, S, n, hd, generator=gen, device=dev).transpose(1, 2)
        q, k, v = mk(H), mk(KV), mk(KV)
        out.append((label, cfg, (q, k, v),
                    FA.flash_attention_fwd_ref(q, k, v, cfg)))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as FA
    CS.phase_device()
    t0 = time.perf_counter()
    built = build_all()
    CS.say(f"[build] {len(built)} variants in "
           f"{time.perf_counter() - t0:.1f} s")
    cases = make_cases(dev)
    libs = {name: ctypes.CDLL(str(so)) for name, so in built.items()}
    for rnd, names in enumerate((list(libs), list(libs)[::-1])):
        for name in names:
            _build._LIBS["flash_attention_fwd"] = libs[name]
            FA._FN.pop("rt_flash_attention_fwd", None)
            for label, cfg, (q, k, v), want in cases:
                fwd = lambda i: FA.flash_attention_fwd(  # noqa: E731
                    q, k, v, cfg)
                if rnd == 0:
                    CS.compare(f"{name} {label}", fwd(0), want)
                CS.say(f"[time] round {rnd + 1} {name} {label}: "
                       f"{CS.device_ms(fwd, 1, calls=3, reps=5):.4f} ms")
    CS.say("[done] every variant agrees with the plain version")
    return 0


if __name__ == "__main__":
    sys.exit(main())
