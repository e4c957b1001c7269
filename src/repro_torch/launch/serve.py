"""Block-wise serving over the paged KV cache: chunked prefill, then the
denoise → sample → commit loop (port of ``repro.launch.serve``: the static
scheduler's ``DecodeEngine``, ``get_engine``, ``generate`` and ``main``).

JAX fuses each phase into one jitted ``lax.scan``; here each is a Python
loop over eager PyTorch calls, with the attention and gate kernels of
``repro_torch.kernels`` on the card. ``dispatches`` and ``prefill_steps``
count what the JAX engine counts: one per prefill call and per decode loop,
and the serial attention steps spent in prefill (ceil(S / chunk)).

Run (defaults: the reduced stablelm-1.6b on the card, bf16 policy):

    python -m repro_torch.launch.serve
    python -m repro_torch.launch.serve --full --prompt-len 512 --ragged
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import precision as precision_mod
from repro_torch.configs import DBConfig, get_config, reduced
from repro_torch.core.blocks import DiffusionBlocksModel
from repro_torch.nn import cache as KVC

DEFAULT_CHUNK = 64


class _Marks:
    """Named points on the device timeline (CUDA events) or the host clock
    (CPU, where every op is synchronous)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.at = {}

    def mark(self, name: str) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.at[name] = ev
        else:
            self.at[name] = time.perf_counter()

    def ms(self, a: str, b: str) -> float:
        """Milliseconds from mark a to mark b; call after a synchronize."""
        if self.cuda:
            return self.at[a].elapsed_time(self.at[b])
        return (self.at[b] - self.at[a]) * 1e3


class DecodeEngine:
    """Static-batch engine for one (model, static config)."""

    def __init__(self, dbm: DiffusionBlocksModel, *, steps_per_block: int = 1,
                 temperature: float = 0.0, top_k: int = 0, precision="bf16",
                 impl: str = "kernels", chunk_size: int = DEFAULT_CHUNK):
        if impl not in KVC.IMPLS:
            raise ValueError(f"impl must be one of {KVC.IMPLS}, got {impl!r}")
        self.dbm = dbm
        self.pol = precision_mod.get_policy(precision)
        self.impl = impl
        self.chunk_size = int(chunk_size)
        self.steps_per_block = int(steps_per_block)
        self.temperature, self.top_k = float(temperature), int(top_k)
        self.dispatches = 0       # prefill calls + decode loops
        self.prefill_steps = 0    # serial attention steps spent in prefill
        self.last_timing = {}     # ms of the last generate: prefill, ttft, total
        self.last_kv = None       # the paged pool the last generate filled

    # ------------------------------------------------------------------
    def chunk_step(self, params, kv, table, lengths, prompt_buf, plens):
        """Commit each slot's next chunk, starting at its own offset."""
        Ck = self.chunk_size
        idx = lengths[:, None].long() + torch.arange(Ck, device=lengths.device)
        tok = torch.gather(prompt_buf, 1,
                           torch.clamp(idx, 0, prompt_buf.shape[1] - 1))
        n_valid = torch.clamp(plens - lengths, 0, Ck)
        return self.dbm.commit_prompt_chunk(
            params, kv, table, lengths, tok, n_valid=n_valid,
            precision=self.pol, impl=self.impl)

    def run_prefill(self, params, kv, table, lengths, prompts, plens):
        """Chunked prefill of a whole (padded) prompt buffer: ceil(S0 / C)
        chunk steps. Returns (kv, lengths)."""
        n_chunks = -(-prompts.shape[1] // self.chunk_size)
        for _ in range(n_chunks):
            kv, lengths = self.chunk_step(params, kv, table, lengths, prompts,
                                          plens)
        self.prefill_steps += n_chunks
        self.dispatches += 1
        return kv, lengths

    def decode(self, params, kv, table, lengths, stop_at, n: int, *,
               z0=None, generator=None, marks: Optional[_Marks] = None):
        """n serve steps; slot b commits while lengths[b] < stop_at[b].
        ``z0`` (n, B, 1, d) holds each step's initial z. Returns (kv,
        lengths, tokens (B, n))."""
        toks = []
        for t in range(n):
            act = lengths < stop_at
            tok, kv, lengths = self.dbm.serve_step_paged(
                params, kv, table, lengths,
                z0=None if z0 is None else z0[t], generator=generator,
                active=act, steps_per_block=self.steps_per_block,
                temperature=self.temperature, top_k=self.top_k,
                precision=self.pol, impl=self.impl)
            toks.append(tok)
            if t == 0 and marks is not None:
                marks.mark("first_token")
        self.dispatches += 1
        return kv, lengths, torch.stack(toks, dim=1)

    def generate(self, params, prompts, max_new: int, *,
                 prompt_lengths=None, page_size: int = KVC.DEFAULT_PAGE_SIZE,
                 z0=None, generator: Optional[torch.Generator] = None):
        """prompts: (B, S0) token ids, right-padded when ``prompt_lengths``
        is ragged -> (B, S0 + max_new) int64 on the CPU; row b holds its
        prompt, then its ``max_new`` tokens from ``prompt_lengths[b]`` on.
        Runs on the device of ``params``. ``z0`` (max_new, B, 1, d) injects
        each step's initial z; else they come from ``generator``."""
        device = params["embed"]["table"].device
        pr = np.asarray(prompts)
        B, S0 = pr.shape
        pl = (np.full((B,), S0, np.int64) if prompt_lengths is None
              else np.asarray(prompt_lengths, np.int64))
        pps = KVC.pages_for(int(pl.max()) + max_new, page_size)
        kv = self.dbm.model.init_paged_cache(B, 1 + B * pps, page_size,
                                             self.pol, device=device)
        table = KVC.identity_page_table(B, pps, device=device)
        prompt_buf = torch.as_tensor(pr, dtype=torch.int64, device=device)
        plens = torch.as_tensor(pl, dtype=torch.int32, device=device)
        lengths = torch.zeros((B,), dtype=torch.int32, device=device)
        marks = _Marks(device)
        marks.mark("start")
        kv, lengths = self.run_prefill(params, kv, table, lengths, prompt_buf,
                                       plens)
        marks.mark("prefilled")
        kv, lengths, gen = self.decode(params, kv, table, lengths,
                                       plens + max_new, max_new, z0=z0,
                                       generator=generator, marks=marks)
        marks.mark("end")
        gen = gen.cpu().numpy()          # waits for the device
        self.last_timing = {"prefill_ms": marks.ms("start", "prefilled"),
                            "ttft_ms": marks.ms("start", "first_token"),
                            "total_ms": marks.ms("start", "end")}
        self.last_kv = kv
        out = np.zeros((B, S0 + max_new), dtype=np.int64)
        for b in range(B):
            out[b, :pl[b]] = pr[b, :pl[b]]
            out[b, pl[b]:pl[b] + max_new] = gen[b]
        return torch.from_numpy(out)


_ENGINE_DEFAULTS = dict(steps_per_block=1, temperature=0.0, top_k=0,
                        precision="bf16", impl="kernels",
                        chunk_size=DEFAULT_CHUNK, kv_dtype=None)


def get_engine(dbm: DiffusionBlocksModel, **config) -> DecodeEngine:
    """Memoized engine per (dbm, static config); ``kv_dtype`` is folded into
    the precision policy as in JAX."""
    cfg = {**_ENGINE_DEFAULTS, **config}
    cfg["precision"] = precision_mod.with_kv_dtype(
        cfg["precision"], cfg.pop("kv_dtype", None)).name
    key = tuple(sorted(cfg.items()))
    engines = dbm.__dict__.setdefault("_serve_engines", {})
    if key not in engines:
        engines[key] = DecodeEngine(dbm, **cfg)
    return engines[key]


def generate(dbm, params, prompts, max_new: int, steps_per_block: int = 1,
             *, prompt_lengths=None, temperature: float = 0.0,
             top_k: int = 0, precision="bf16", kv_dtype=None,
             impl: str = "kernels", page_size: int = KVC.DEFAULT_PAGE_SIZE,
             chunk_size: int = DEFAULT_CHUNK, z0=None, generator=None):
    """prompts: (B, S0) -> (B, S0 + max_new): chunked prefill, then the
    denoise → sample → commit loop over the paged cache (see
    ``DecodeEngine.generate``)."""
    eng = get_engine(dbm, steps_per_block=steps_per_block,
                     temperature=temperature, top_k=top_k,
                     precision=precision, kv_dtype=kv_dtype, impl=impl,
                     chunk_size=chunk_size)
    return eng.generate(params, prompts, max_new,
                        prompt_lengths=prompt_lengths, page_size=page_size,
                        z0=z0, generator=generator)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--full", action="store_true",
                    help="serve the published widths (default: reduced)")
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--scheduler", choices=("static",), default="static")
    ap.add_argument("--steps-per-block", type=int, default=1)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--precision", default="bf16")
    ap.add_argument("--kv-dtype", default=None,
                    choices=("int8", "bf16", "fp32", "auto"))
    ap.add_argument("--impl", default="kernels", choices=KVC.IMPLS,
                    help="kernels: the Hopper kernels; ref: their plain "
                         "PyTorch versions")
    ap.add_argument("--chunk-size", type=int, default=DEFAULT_CHUNK)
    ap.add_argument("--page-size", type=int, default=KVC.DEFAULT_PAGE_SIZE)
    ap.add_argument("--ragged", action="store_true",
                    help="vary prompt lengths across the batch")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and noise")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the port serves on the card "
                         "(pass --device cpu to run its plain versions)")
    cfg = get_config(args.arch)
    cfg = cfg if args.full else reduced(cfg)
    db = DBConfig(num_blocks=min(args.blocks, cfg.n_layers),
                  overlap_gamma=0.1)
    dbm = DiffusionBlocksModel(cfg, db)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = dbm.init(gen)

    # prompts: uniform token ids (the JAX CLI samples a Markov LM instead)
    rs = np.random.RandomState(1)
    prompts = rs.randint(0, cfg.vocab_size, size=(args.batch,
                                                  args.prompt_len))
    plens = None
    if args.ragged:
        plens = rs.randint(max(2, args.prompt_len // 2), args.prompt_len + 1,
                           size=args.batch)
    eng = get_engine(dbm, steps_per_block=args.steps_per_block,
                     temperature=args.temperature, top_k=args.top_k,
                     precision=args.precision, kv_dtype=args.kv_dtype,
                     impl=args.impl,
                     chunk_size=min(args.chunk_size, max(args.prompt_len, 1)))
    t0 = time.perf_counter()
    eng.generate(params, prompts, args.max_new, prompt_lengths=plens,
                 page_size=args.page_size, generator=gen)
    dt = time.perf_counter() - t0
    n_tok = args.batch * args.max_new
    print(f"[static] {cfg.name} on {device}: generated {args.batch}x"
          f"{args.max_new} tokens in {dt:.2f}s ({n_tok / dt:.1f} tok/s incl. "
          f"kernel builds) | ttft {eng.last_timing['ttft_ms']:.1f} ms | "
          f"dispatches={eng.dispatches} | prefill: {eng.prefill_steps} chunk "
          f"steps | cache={KVC.cache_bytes(eng.last_kv) / 1e6:.1f}MB paged")


if __name__ == "__main__":
    main()
