"""Block-wise serving over the paged KV cache (port of
``repro.launch.serve``): the ``DecodeEngine`` (chunked or per-token prefill,
and one segment of denoise → sample → commit steps that both the static
decode and the continuous batcher run),
``get_engine``, ``generate``, the continuous batcher ``ContinuousBatcher``
with its ``Request``, ``PRIORITY_CLASSES`` and ``AdmissionError``, and
``main``. ``repro_torch.launch.server`` puts an HTTP/SSE frontend over the
batcher.

JAX fuses each phase into one jitted ``lax.scan``; here the static engine's
phases are Python loops over eager PyTorch calls, with the attention and
gate kernels of ``repro_torch.kernels`` on the card. ``dispatches`` and
``prefill_steps`` count what the JAX engine counts: one per prefill call,
per decode loop and per batcher dispatch, and the serial attention steps
spent in prefill.

The continuous batcher interleaves one prefill-chunk dispatch with one
``seg_len``-step decode segment per scheduling step, over a shared page
pool with prefix sharing, copy-on-write and preemption to host memory, as
JAX's does. JAX runs each as one compiled dispatch; on the card the
batcher captures the chunk step and the segment once each as a CUDA graph
over static input buffers and replays them, and the segment's random
draws are made outside the graph (``ContinuousBatcher.draw_segment``). On
the CPU both run eagerly through the same functions.

Run (defaults: the reduced stablelm-1.6b on the card, bf16 policy):

    python -m repro_torch.launch.serve
    python -m repro_torch.launch.serve --full --prompt-len 512 --ragged
    python -m repro_torch.launch.serve --scheduler continuous --ragged \
        --prefix-cache
    python -m repro_torch.launch.serve --device cpu --scheduler continuous
    python -m repro_torch.launch.serve --ckpt-dir CKPT   # saved blocks
    python -m repro_torch.launch.serve --device cpu \
        --arch llama-3.2-vision-11b --blocks 1 --conditioned \
        --scheduler continuous           # the VLM, image-conditioned
    python -m repro_torch.launch.serve --device cpu --arch whisper-small \
        --blocks 1 --conditioned --scheduler continuous  # audio-conditioned
    python -m repro_torch.launch.serve --arch zamba2-7b --full \
        --scheduler continuous           # the hybrid (no --prefix-cache)
    python -m repro_torch.launch.serve --arch xlstm-125m --full \
        --scheduler continuous           # the xLSTM (no --prefix-cache)
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import threading
import time
import weakref
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch import precision as precision_mod
from repro_torch.checkpoint import load_blocks
from repro_torch.configs import DBConfig, get_config, reduced
from repro_torch.core.blocks import DiffusionBlocksModel, gumbel
from repro_torch.data import MarkovLM
from repro_torch.launch.faults import WorkerDied
from repro_torch.models.common import LayerCtx
from repro_torch.models.model_api import build_model
from repro_torch.nn import cache as KVC

DEFAULT_CHUNK = 64


def _ragged_transition_accuracy(lm, seqs) -> float:
    """Mean legal-transition rate over variable-length sequences, scored per
    row so padding never makes or breaks a transition."""
    return float(np.mean([lm.transition_accuracy(np.asarray(s)[None])
                          for s in seqs]))


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
    """The serving programs of one (model, static config).

      _prefill_chunk1  one chunk step: each slot commits up to
                       ``chunk_size`` prompt tokens at its own offset
      prefill_scan     the per-token reference: one commit per prompt
                       position, where t < plens[b]
      _serve           a segment of serve steps (denoise → sample →
                       commit): each active slot commits its next prompt
                       token (per-token mode) or a generated one
      decode           n serve steps past the prompt: ``_serve`` with every
                       slot active

    The batcher calls ``_prefill_chunk1`` and ``_serve``; a test may replace
    either on an instance with a fake of the same signature. ``draw`` makes
    the random draws of a run of serve steps before the steps run.
    """

    def __init__(self, dbm: DiffusionBlocksModel, *, steps_per_block: int = 1,
                 temperature: float = 0.0, top_k: int = 0, precision="bf16",
                 impl: str = "kernels", prefill: str = "chunked",
                 chunk_size: int = DEFAULT_CHUNK):
        if impl not in KVC.IMPLS:
            raise ValueError(f"impl must be one of {KVC.IMPLS}, got {impl!r}")
        if prefill not in ("chunked", "per-token"):
            raise ValueError(f"prefill must be 'chunked' or 'per-token', "
                             f"got {prefill!r}")
        # the model memoizes its engines (``get_engine``): a weak reference
        # back keeps that from being a cycle, so dropping the model frees
        # its engines and their last pools at once, without a gc pass
        self.dbm = weakref.proxy(dbm)
        self.pol = precision_mod.get_policy(precision)
        self.impl = impl
        self.prefill_mode = prefill
        self.chunk_size = int(chunk_size)
        self.steps_per_block = int(steps_per_block)
        self.temperature, self.top_k = float(temperature), int(top_k)
        self.dispatches = 0       # prefill calls, decode loops, segments
        self.prefill_steps = 0    # serial attention steps spent in prefill
        self.last_timing = {}     # ms of the last generate: prefill, ttft, total
        self.last_kv = None       # the paged pool the last generate filled

    # ------------------------------------------------------------------
    def _prefill_chunk1(self, params, kv, table, lengths, prompt_buf, plens,
                        cond_lengths=None):
        """Commit each slot's next chunk, starting at its own offset; a
        conditioned family's slots read their conditioning blocks under
        ``cond_lengths``. Returns (kv, lengths)."""
        Ck = self.chunk_size
        idx = lengths[:, None].long() + torch.arange(Ck, device=lengths.device)
        tok = torch.gather(prompt_buf, 1,
                           torch.clamp(idx, 0, prompt_buf.shape[1] - 1))
        n_valid = torch.clamp(plens - lengths, 0, Ck)
        return self.dbm.commit_prompt_chunk(
            params, kv, table, lengths, tok, n_valid=n_valid,
            precision=self.pol, impl=self.impl, cond_lengths=cond_lengths)

    def prefill_scan(self, params, kv, table, lengths, prompts, plens,
                     cond_lengths=None):
        """Per-token prefill: one commit per prompt position t, for the
        slots with t < plens[b]. Returns (kv, lengths)."""
        for t in range(prompts.shape[1]):
            kv, lengths = self.dbm.commit_prompt_token(
                params, kv, table, lengths, prompts[:, t:t + 1],
                active=t < plens, precision=self.pol, impl=self.impl,
                cond_lengths=cond_lengths)
        return kv, lengths

    def run_prefill(self, params, kv, table, lengths, prompts, plens,
                    cond_lengths=None):
        """The configured prefill of a whole (padded) prompt buffer:
        ceil(S0 / C) chunk steps, or S0 per-token steps. Returns (kv,
        lengths)."""
        S0 = prompts.shape[1]
        if self.prefill_mode == "chunked":
            n_chunks = -(-S0 // self.chunk_size)
            for _ in range(n_chunks):
                kv, lengths = self._prefill_chunk1(params, kv, table, lengths,
                                                   prompts, plens,
                                                   cond_lengths)
            self.prefill_steps += n_chunks
        else:
            kv, lengths = self.prefill_scan(params, kv, table, lengths,
                                            prompts, plens, cond_lengths)
            self.prefill_steps += S0
        self.dispatches += 1
        return kv, lengths

    def draw(self, n: int, B: int, generator, device, z=None, noise=None):
        """The random draws of n serve steps over B slots, made before the
        steps run: each step's initial z, σ_max · N(0, 1) of shape (n, B,
        1, d), then for temperature > 0 the Gumbel noise (n, B, vocab) of
        the categorical draw, from ``generator`` where not given. Returns
        (z, noise or None)."""
        cfg = self.dbm.cfg
        if z is None:
            z = self.dbm.db.sigma_max * torch.randn(
                (n, B, 1, cfg.d_model), generator=generator, device=device)
        if self.temperature == 0.0:
            return z, None
        if noise is None:
            noise = gumbel(generator, (n, B, cfg.vocab_size), device)
        return z, noise

    def _serve(self, params, kv, table, lengths, prompt_buf, plens, stop_at,
               active, z, noise=None, cond_lengths=None):
        """A segment of n = ``z.shape[0]`` serve steps. A slot takes a step
        while ``active`` and lengths < stop_at; it commits its next prompt
        token while lengths < plens, else the token it samples. ``z`` (n, B,
        1, d) holds each step's initial z; ``noise`` (n, B, vocab) the
        sampling noise, needed when temperature > 0; ``cond_lengths`` (B,)
        the valid tokens of each slot's conditioning block (conditioned
        families).
        Makes no random draw and no host sync, so a CUDA graph can capture
        it. Returns (kv, lengths, emitted (B, n): the generated tokens, -1
        where a slot emitted nothing)."""
        last = prompt_buf.shape[1] - 1
        emitted = []
        for t in range(z.shape[0]):
            in_prompt = lengths < plens
            ptok = torch.gather(prompt_buf, 1,
                                torch.clamp(lengths, 0, last).long()[:, None])
            act = active & (lengths < stop_at)
            tok, kv, lengths = self.dbm.serve_step_paged(
                params, kv, table, lengths, z0=z[t],
                noise=None if noise is None else noise[t],
                forced=torch.where(in_prompt, ptok[:, 0], -1), active=act,
                steps_per_block=self.steps_per_block,
                temperature=self.temperature, top_k=self.top_k,
                precision=self.pol, impl=self.impl,
                cond_lengths=cond_lengths)
            emitted.append(torch.where(act & ~in_prompt, tok, -1))
        return kv, lengths, torch.stack(emitted, dim=1)

    def decode(self, params, kv, table, lengths, stop_at, n: int, *,
               z0=None, noise=None, generator=None,
               marks: Optional[_Marks] = None, cond_lengths=None):
        """n serve steps past the prompt: ``_serve`` with every slot active;
        slot b commits while lengths[b] < stop_at[b]. ``z0`` (n, B, 1, d)
        and ``noise`` (n, B, vocab) inject the draws, else ``draw`` makes
        them from ``generator``. The first step runs alone, so that
        ``marks`` can mark the first token. Returns (kv, lengths, tokens
        (B, n), -1 past stop_at)."""
        B, dev = lengths.shape[0], lengths.device
        z, noise = (None if x is None else
                    torch.as_tensor(x, dtype=torch.float32, device=dev)
                    for x in self.draw(n, B, generator, dev, z0, noise))
        no_prompt = torch.zeros((B, 1), dtype=torch.int64, device=dev)
        plens = torch.zeros_like(lengths)
        active = torch.ones((B,), dtype=torch.bool, device=dev)
        toks = []
        for steps in (slice(0, 1), slice(1, n)):
            if steps.start >= steps.stop:
                continue
            kv, lengths, tok = self._serve(
                params, kv, table, lengths, no_prompt, plens, stop_at, active,
                z[steps], None if noise is None else noise[steps],
                cond_lengths)
            toks.append(tok)
            if steps.start == 0 and marks is not None:
                marks.mark("first_token")
        self.dispatches += 1
        return kv, lengths, torch.cat(toks, dim=1)

    def generate(self, params, prompts, max_new: int, *,
                 prompt_lengths=None, page_size: int = KVC.DEFAULT_PAGE_SIZE,
                 z0=None, noise=None,
                 generator: Optional[torch.Generator] = None,
                 aux_inputs=None, cond_lengths=None):
        """prompts: (B, S0) token ids, right-padded when ``prompt_lengths``
        is ragged -> (B, S0 + max_new) int64 on the CPU; row b holds its
        prompt, then its ``max_new`` tokens from ``prompt_lengths[b]`` on.
        Runs on the device of ``params``. ``z0`` (max_new, B, 1, d) injects
        each step's initial z and ``noise`` (max_new, B, vocab) its
        sampling noise; else they come from ``generator``.

        ``aux_inputs`` ({"image_embs" or "audio_embs": (B, Sk, d)}) is
        encoded once and written into every slot's conditioning block
        before prefill; the steps read it under ``cond_lengths`` (B,)
        (default: Sk for every row; a conditioned family without aux inputs
        reads none)."""
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
        clens = self._conditioning(params, kv, B, aux_inputs, cond_lengths)
        kv, lengths = self.run_prefill(params, kv, table, lengths, prompt_buf,
                                       plens, clens)
        marks.mark("prefilled")
        kv, lengths, gen = self.decode(params, kv, table, lengths,
                                       plens + max_new, max_new, z0=z0,
                                       noise=noise, generator=generator,
                                       marks=marks, cond_lengths=clens)
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

    def encode_ctx(self) -> LayerCtx:
        """The context an admission-time encode of conditioning runs in
        (the encoder-decoder's encoder): the engine's ``impl``."""
        return LayerCtx(cfg=self.dbm.cfg, mode="train", impl=self.impl)

    def _conditioning(self, params, kv, B: int, aux_inputs, cond_lengths):
        """Write every slot's conditioning block from ``aux_inputs`` (B, Sk,
        d) before prefill, as JAX's engine does (the encoder, if the family
        has one, under the engine's ``impl``). Returns the steps'
        ``cond_lengths``: None for an unconditioned family, zeros for a
        conditioned one served without aux inputs."""
        model = self.dbm.model
        device = params["embed"]["table"].device
        if not aux_inputs:
            return (torch.zeros((B,), dtype=torch.int32, device=device)
                    if model.max_cond_tokens else None)
        aux = {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
               for k, v in aux_inputs.items()}
        cond = model.encode_conditioning(params, aux, self.encode_ctx())
        if cond is None:
            spec = model.aux_input_specs(B)
            raise ValueError(
                f"aux_inputs {sorted(aux_inputs)} not understood by family "
                f"{self.dbm.cfg.family!r}: expected "
                f"{sorted(spec) if spec else 'no aux inputs'}")
        if cond_lengths is not None and not model.cond_padding_safe:
            raise ValueError(
                "ragged cond_lengths through the static batch is unsound for "
                f"family {self.dbm.cfg.family!r}: its frontend mixes padded "
                "rows into every row. Serve ragged conditioning through "
                "ContinuousBatcher.submit, which encodes each request at its "
                "true length.")
        model.set_conditioning(params, kv, cond)
        if cond_lengths is None:
            return torch.full((B,), cond.shape[1], dtype=torch.int32,
                              device=device)
        return torch.as_tensor(np.asarray(cond_lengths), dtype=torch.int32,
                               device=device)


_ENGINE_DEFAULTS = dict(steps_per_block=1, temperature=0.0, top_k=0,
                        precision="bf16", impl="kernels", prefill="chunked",
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
             prefill: str = "chunked", chunk_size: int = DEFAULT_CHUNK,
             z0=None, noise=None, generator=None, aux_inputs=None,
             cond_lengths=None):
    """prompts: (B, S0) -> (B, S0 + max_new): prefill (chunked, or the
    per-token reference), then the denoise → sample → commit loop over the
    paged cache, conditioned on ``aux_inputs`` where given (see
    ``DecodeEngine.generate``)."""
    eng = get_engine(dbm, steps_per_block=steps_per_block,
                     temperature=temperature, top_k=top_k,
                     precision=precision, kv_dtype=kv_dtype, impl=impl,
                     prefill=prefill, chunk_size=chunk_size)
    return eng.generate(params, prompts, max_new,
                        prompt_lengths=prompt_lengths, page_size=page_size,
                        z0=z0, noise=noise, generator=generator,
                        aux_inputs=aux_inputs, cond_lengths=cond_lengths)


# ---------------------------------------------------------------------------
# Continuous batching
# ---------------------------------------------------------------------------

# Priority classes: higher wins. Admission takes the best (priority, oldest)
# queued request; preemption for an admission spills only strictly
# lower-priority work.
PRIORITY_CLASSES = {"batch": 0, "standard": 1, "interactive": 2}


class AdmissionError(RuntimeError):
    """Raised by ``submit`` when admission control sheds the request (queue
    depth or pool pressure over its threshold). ``retry_after`` is the
    backoff hint in seconds, from the smoothed service time (the HTTP
    frontend sends it as the 429's ``Retry-After``)."""

    def __init__(self, msg: str, retry_after: float):
        super().__init__(msg)
        self.retry_after = float(retry_after)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    aux_inputs: Optional[dict] = None   # {"image_embs": (Sk, d) fp32}, or
    #                                     {"audio_embs": ...}
    cond_fp: int = 0              # conditioning fingerprint (0 = none)
    out: List[int] = dataclasses.field(default_factory=list)
    pages: List[int] = dataclasses.field(default_factory=list)
    shared_tokens: int = 0        # prompt tokens served from the prefix cache
    registered: bool = False      # prefix pages inserted into the cache
    submit_t: float = 0.0
    first_token_t: Optional[float] = None
    cancelled: bool = False       # retired early via ``cancel(rid)``
    error: Optional[str] = None   # rejection reason (non-strict scheduling)
    priority: int = PRIORITY_CLASSES["standard"]
    ttft_deadline: Optional[float] = None    # absolute wall-clock deadline
    tpot_deadline_s: Optional[float] = None  # most seconds per output token
    deadline_blown: bool = False  # retired by the deadline enforcer
    # preemption: the host snapshot while queued, and its scheduling row
    spilled: Optional[KVC.SpilledSlot] = None
    spill_meta: Optional[dict] = None
    preempt_count: int = 0
    # disaggregated prefill/decode migration (``launch.router``): on a
    # shared pool, the physical pages of the committed KV with their refs,
    # travelling with the request; admission maps them instead of copying
    handoff_pages: Optional[List[int]] = None
    migrations: int = 0           # completed prefill -> decode handoffs
    failovers: int = 0            # re-routed off a dead worker

    @property
    def done(self) -> bool:
        return len(self.out) >= self.max_new

    @property
    def ttft(self) -> Optional[float]:
        return (None if self.first_token_t is None
                else self.first_token_t - self.submit_t)


@dataclasses.dataclass
class _Graphed:
    """A dispatch captured as a CUDA graph: the static input buffers it
    reads, the outputs it writes, the launches its capture recorded, and
    the tensors it reads that nothing else may free."""
    graph: "torch.cuda.CUDAGraph"
    inputs: dict
    outputs: tuple
    launches: dict
    keep: object


# the host arrays each dispatch reads, in the engine's argument order
_INPUTS = {"chunk": ("table", "lengths", "prompt_buf", "plens"),
           "segment": ("table", "lengths", "prompt_buf", "plens", "stop_at",
                       "active")}


def _check_captured(graph, launches: dict) -> None:
    """Raise unless the captured ``graph`` holds each launch the wrappers
    counted during its capture: a launcher that put its kernel on another
    stream than the capturing one ran it once, outside the graph, and
    every replay would skip it."""
    from repro_torch import kernels as K
    from repro_torch.kernels import _build
    names = _build.graph_kernel_names(graph)
    for wrapper, n in launches.items():
        kernels = getattr(K.WRAPPERS[wrapper], "kernel_names", None)
        if kernels is None:
            raise RuntimeError(f"CUDA-graph capture: {wrapper} names no "
                               "kernel to look for in the graph")
        held = sum(any(k in name for k in kernels) for name in names)
        if held != n:
            raise RuntimeError(
                f"CUDA-graph capture: {wrapper} launched {n} times but the "
                f"graph holds {held} of its kernels; a launcher ran outside "
                "the capture stream")


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class SharedPagePool:
    """ONE physical page pool shared by several batchers (disaggregated
    prefill/decode with page-handle migration): the free list, the refcount
    map, the pool's paged tensors and one lock are common; each batcher
    keeps its own page table, slots and dense per-slot state (the
    conditioning blocks). A page a prefill worker hands to a decode worker is
    visible there without a byte copied: the request carries only the
    physical page ids (``Request.handoff_pages``) and its dense rows.

    JAX pulls and publishes the pool's leaves around every step; here the
    tensors are written in place, so the first batcher makes them and every
    later one grafts the same PagedKV leaves into its own cache tree at
    construction (JAX's graft), before any capture.
    ``lock`` serializes the sharers' steps on the host. On the card every
    dispatch ends in a readback on the batcher's stream and starts by
    waiting for the default stream (where copy-on-write, restore and spill
    run, whichever thread calls them), so a page one sharer wrote is
    complete before another's dispatch reads it."""

    def __init__(self, total_pages: int):
        self.total_pages = int(total_pages)
        self.free_pages: List[int] = list(range(1, self.total_pages))
        self.page_refs: dict = {}
        self.lock = threading.RLock()
        # the shared part of the first sharer's cache: its PagedKV leaves
        # (the whole cache of a purely paged family)
        self.kv = None
        self._spec = None            # (cfg, page size, kv dtype, device)

    def join(self, dbm, policy, page_size: int, device,
             num_slots: int):
        """One more batcher's cache: the first makes the pool, every later
        one builds its own dense per-slot leaves (over a one-page pool of
        its own, dropped at once) and takes the pool's PagedKV leaves in
        place of its pages. All must serve the same model with the same
        page size, KV dtype and device."""
        if not dbm.model.kv_carries_all_state:
            raise ValueError(
                f"a SharedPagePool shares paged KV only; family "
                f"{dbm.cfg.family!r} keeps sequence state outside the pages")
        spec = (dbm.cfg, page_size, KVC.resolve_kv_dtype(policy.kv),
                torch.device(device))
        if self.kv is None:
            kv = dbm.model.init_paged_cache(num_slots, self.total_pages,
                                            page_size, policy, device=device)
            dense = dbm.model.paged_state_axes
            self.kv = kv if isinstance(kv, KVC.PagedKV) else {
                k: v for k, v in kv.items() if k not in dense}
            self._spec = spec
            return kv
        if spec != self._spec:
            raise ValueError(
                "batchers sharing a pool must serve the same model with the "
                f"same page_size, kv dtype and device: {spec[1:]} against "
                f"{self._spec[1:]}")
        own = dbm.model.init_paged_cache(num_slots, 1, page_size, policy,
                                         device=device)
        return KVC.graft_paged(own, KVC.paged_leaves(self.kv))


class ContinuousBatcher:
    """Slot-based continuous batching over a shared page pool (port of
    ``repro.launch.serve.ContinuousBatcher``).

    ``num_slots`` request slots share ``total_pages`` physical pages (page 0
    is the trash page). Each ``step`` applies pending cancels and
    preemptions, admits queued requests into free slots, runs one
    prefill-chunk dispatch for the slots still in their prompt (chunked
    mode), one ``seg_len``-step decode segment for the others, and retires
    finished slots. ``prefill="per-token"`` commits prompt tokens one a
    step inside the segment instead.

    ``prefix_cache=True`` shares prompt-prefix pages across requests
    (``cache.PrefixPageCache``): a request whose prompt extends a served
    prefix maps those pages read-only, prefills from the first unshared
    token and copies the boundary page before writing into it. Under pool
    pressure the scheduler spills the lowest-priority slot to host memory
    (``cache.spill_slot``) and restores it later, never deadlocking.

    On the card the chunk step and the decode segment are CUDA graphs,
    each captured at its first dispatch (or by ``capture``) over static
    buffers and replayed for every dispatch; the pool is written in place,
    so its tensors keep their storage for the batcher's life (``step``
    checks). ``graphs=False`` runs both eagerly on the card too. The
    segment's draws come from ``draw_segment`` (``generator``).

    SLOs and admission control: ``submit`` takes a ``priority`` and
    relative ``ttft_slo_s`` / ``tpot_slo_s``; a request that misses one is
    retired with its partial output and ``error`` set (``deadline_blown``).
    ``max_queue`` sheds a submit when as many requests at or above its
    priority are queued, ``shed_below_pages`` sheds batch-class submits
    while fewer pages are free: ``submit`` raises ``AdmissionError`` with a
    ``retry_after`` hint from the smoothed service time.

    ``faults`` (a ``repro_torch.launch.faults.FaultInjector``) is consulted
    at JAX's four serving hook points: ``alloc_exhaust`` in page allocation
    (the pool pretends to be empty), ``token_stall`` in token delivery (a
    sleep), and ``engine_crash`` / ``worker_die`` at the top of ``step``
    (``InjectedFault`` / ``WorkerDied``, raised before any bookkeeping
    mutates). ``recover`` spills every active slot back to the queue after
    a crash, ``abort_all`` errors out all work, ``extract_all`` pops it
    (``repro_torch.launch.server.EngineRunner`` is the supervisor).

    ``token_cb``, when set, is called from the stepping thread with each
    request and the tokens a segment emitted for it. ``submit``/``cancel``/
    ``pause``/``resume``/``preempt`` may be called from any thread; they
    touch only host state and take effect at the next ``step``.

    ``shared_pool`` (a ``SharedPagePool``) puts several batchers on one
    pool: ``_detach_slot`` hands a slot's pages to its request
    (``handoff_pages``) and the admission of another sharer maps them (the
    page-handle migration of ``launch.router``).

    Conditioned requests (a family with ``max_cond_tokens``: the VLM, the
    encoder-decoder): ``submit(aux_inputs={"image_embs": (Sk, d)})`` (or
    ``audio_embs``) fingerprints the conditioning for the prefix cache;
    admission encodes it alone at its true length and writes the slot's
    conditioning block once (``_write_conditioning``, in place, on the
    stepping thread's stream, which every dispatch waits for) and every
    dispatch reads it under
    ``cond_lengths`` (0 for an unconditioned slot, whose cross term is
    exactly 0). The block travels with a spilled or migrated request as
    the dense row of its snapshot.
    """

    def __init__(self, dbm, params, *, num_slots: int = 8,
                 page_size: int = KVC.DEFAULT_PAGE_SIZE,
                 max_prompt: int = 64, max_len: int = 128,
                 total_pages: Optional[int] = None, seg_len: int = 16,
                 steps_per_block: int = 1, temperature: float = 0.0,
                 top_k: int = 0, precision="bf16", kv_dtype=None,
                 impl: str = "kernels", prefill: str = "chunked",
                 chunk_size: Optional[int] = None,
                 prefix_cache: bool = False,
                 generator: Optional[torch.Generator] = None,
                 graphs: Optional[bool] = None,
                 max_queue: Optional[int] = None,
                 shed_below_pages: int = 0, faults=None,
                 shared_pool: Optional[SharedPagePool] = None):
        self.dbm, self.params = dbm, params
        self.faults = faults
        self.device = params["embed"]["table"].device
        if graphs is None:
            graphs = self.device.type == "cuda"
        if graphs and self.device.type != "cuda":
            raise ValueError("graphs=True: CUDA graphs need the card")
        self.graphs = graphs
        chunk_size = (min(DEFAULT_CHUNK, max_prompt) if chunk_size is None
                      else chunk_size)
        self.eng = get_engine(dbm, steps_per_block=steps_per_block,
                              temperature=temperature, top_k=top_k,
                              precision=precision, kv_dtype=kv_dtype,
                              impl=impl, prefill=prefill,
                              chunk_size=chunk_size)
        self.chunked = prefill == "chunked"
        self.chunk_size = chunk_size
        if prefix_cache and not dbm.model.kv_carries_all_state:
            raise ValueError(
                f"prefix_cache=True is unsound for family "
                f"{dbm.cfg.family!r}: per-slot recurrent state is not paged")
        self.prefix = KVC.PrefixPageCache(page_size) if prefix_cache else None
        self.page_size, self.seg_len = page_size, seg_len
        self.max_prompt, self.max_len = max_prompt, max_len
        pps = KVC.pages_for(max_len, page_size)
        # worst-case pages per slot, plus under prefix sharing one
        # copy-on-write spare per slot (a decode write into a cache-retained
        # boundary page copies it even when every mapped page is live)
        cow_spare = num_slots if prefix_cache else 0
        self.total_pages = (1 + num_slots * pps + cow_spare
                            if total_pages is None else total_pages)
        self._shared = shared_pool
        # a family with per-slot conditioning blocks: every dispatch reads them
        # under ``cond_lengths``
        self.conditioned = dbm.model.max_cond_tokens > 0
        if shared_pool is None:
            self.kv = dbm.model.init_paged_cache(num_slots, self.total_pages,
                                                 page_size, self.eng.pol,
                                                 device=self.device)
            self.free_pages = list(range(1, self.total_pages))
            self.page_refs = {}      # phys page -> refcount (slots + cache)
            # serializes step, recover, abort_all and extract_all (the
            # router's failover calls the last from its own thread)
            self._pool_lock = threading.RLock()
        else:
            # one free list, refcount map, pool and lock for every sharer
            self.total_pages = shared_pool.total_pages
            self.kv = shared_pool.join(dbm, self.eng.pol, page_size,
                                       self.device, num_slots)
            self.free_pages = shared_pool.free_pages
            self.page_refs = shared_pool.page_refs
            self._pool_lock = shared_pool.lock
        self._pool_ptrs = KVC.pool_ptrs(self.kv)
        self.num_slots = num_slots
        self.table = np.zeros((num_slots, pps), np.int32)   # 0 = trash page
        self.lengths = np.zeros(num_slots, np.int32)
        self.plens = np.zeros(num_slots, np.int32)
        self.stop_at = np.zeros(num_slots, np.int32)
        self.active = np.zeros(num_slots, bool)
        self.prompt_buf = np.zeros((num_slots, max_prompt), np.int64)
        self.cond_lengths = np.zeros(num_slots, np.int32)   # cond. tokens
        self.slot_req: List[Optional[Request]] = [None] * num_slots
        self.queue: collections.deque = collections.deque()
        self._next_rid = 0
        self.steps = 0               # decode-segment steps (all slots)
        self.ingest_dispatches = 0   # prefill-chunk calls this batcher made
        self.decode_dispatches = 0   # decode segments this batcher ran
        self.cow_copies = 0          # copy-on-write page copies
        self._lock = threading.Lock()        # guards queue/cancel/pause sets
        self._cancel_pending: set = set()
        self._paused: set = set()
        self.cancelled_count = 0
        self._axes = dbm.model.paged_state_axes
        self._preempt_pending: set = set()
        self.preemptions = 0         # slots spilled to host
        self.restores = 0            # spilled requests re-admitted
        self.generator = (generator if generator is not None else
                          torch.Generator(device=self.device).manual_seed(0))
        self._graphs: dict = {}      # "chunk" / "segment" -> _Graphed
        # the stream the graphs are captured and replayed on, whichever
        # thread steps the batcher
        self.stream = torch.cuda.Stream(self.device) if graphs else None
        # eager dispatches run before each capture (one chunk step, one
        # segment step), counted in the launch arithmetic
        self.graph_warmups = {"chunk": 0, "segment": 0}
        self.token_cb: Optional[Callable[[Request, List[int]], None]] = None
        # admission control, SLO deadlines, recovery
        self.max_queue = max_queue           # class-aware queue-depth shed
        self.shed_below_pages = shed_below_pages  # pool-pressure shed
        self.shed_count = 0                  # submissions refused
        self.deadline_cancels = 0            # requests retired by SLO misses
        self._svc_ewma: Optional[float] = None   # submit -> finish seconds

    # ---- submission and flow control (any thread) --------------------
    def submit(self, prompt, max_new: int, aux_inputs=None, *,
               priority="standard", ttft_slo_s: Optional[float] = None,
               tpot_slo_s: Optional[float] = None) -> int:
        """Queue a request; returns its rid. ``priority`` (a
        ``PRIORITY_CLASSES`` name or an int) orders admission and picks
        preemption victims; ``ttft_slo_s`` / ``tpot_slo_s`` are relative
        SLOs in seconds. Raises ``AdmissionError`` when admission control
        sheds the request: the backlog counted against ``max_queue`` is
        the queued work at or above this priority, so under mixed overload
        the low classes shed first. ``aux_inputs`` ({"image_embs" or
        "audio_embs": (Sk, d)}, no batch axis) conditions the request; the family must take
        conditioning and Sk fit its block."""
        aux_inputs = self.check_aux(self.dbm, aux_inputs)
        if isinstance(priority, str):
            if priority not in PRIORITY_CLASSES:
                raise ValueError(f"unknown priority class {priority!r}: "
                                 f"expected {sorted(PRIORITY_CLASSES)}")
            priority = PRIORITY_CLASSES[priority]
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt: a request must carry at least "
                             "one token")
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        if prompt.size > self.max_prompt:
            raise ValueError(f"prompt of {prompt.size} tokens exceeds "
                             f"max_prompt {self.max_prompt}")
        if prompt.size + max_new > self.max_len:
            raise ValueError(f"request of {prompt.size} + {max_new} tokens "
                             f"exceeds max_len {self.max_len}")
        priority = int(priority)
        with self._lock:
            if self.max_queue is not None:
                backlog = sum(1 for r in self.queue if r.priority >= priority)
                if backlog >= self.max_queue:
                    self.shed_count += 1
                    raise AdmissionError(
                        f"queue depth {backlog} at priority >= {priority} "
                        f"over threshold {self.max_queue}",
                        self.retry_after_hint())
            if (self.shed_below_pages and priority <= 0
                    and len(self.free_pages) < self.shed_below_pages):
                self.shed_count += 1
                raise AdmissionError(
                    f"pool pressure: {len(self.free_pages)} free pages below "
                    f"threshold {self.shed_below_pages} (batch class shed)",
                    self.retry_after_hint())
            rid = self._next_rid
            self._next_rid += 1
        req = Request(rid, prompt, max_new, aux_inputs=aux_inputs,
                      cond_fp=KVC.conditioning_fingerprint(aux_inputs),
                      priority=priority, tpot_deadline_s=tpot_slo_s)
        req.submit_t = time.time()
        if ttft_slo_s is not None:
            req.ttft_deadline = req.submit_t + float(ttft_slo_s)
        with self._lock:
            self.queue.append(req)
        return rid

    @staticmethod
    def check_aux(dbm, aux_inputs) -> Optional[dict]:
        """``aux_inputs`` as fp32 numpy arrays, or None for none; raises
        ``ValueError`` for an unconditioned family, a shape other than (Sk,
        d_model) or Sk over the block's capacity."""
        if not aux_inputs:
            return None
        cap = dbm.model.max_cond_tokens
        if cap == 0:
            raise ValueError(f"family {dbm.cfg.family!r} takes no aux "
                             "conditioning inputs")
        out = {}
        for k, v in aux_inputs.items():
            v = np.asarray(v.cpu() if torch.is_tensor(v) else v, np.float32)
            if v.ndim != 2 or v.shape[1] != dbm.cfg.d_model:
                raise ValueError(f"{k}: expected (Sk, {dbm.cfg.d_model}), "
                                 f"got {v.shape}")
            if v.shape[0] > cap:
                raise ValueError(f"{k}: {v.shape[0]} tokens exceed the "
                                 f"conditioning block capacity {cap}")
            out[k] = v
        return out

    def submit_request(self, req: Request) -> None:
        """Enqueue a pre-built ``Request`` untouched (a spilled one restores
        at admission)."""
        with self._lock:
            self.queue.append(req)

    def kv_stats(self) -> dict:
        """The pool's storage dtype and bytes, in total and by dtype (an
        int8 pool reports its fp32 scales); a cache with no pages (the
        xLSTM's) has no KV dtype."""
        leaves = KVC.paged_leaves(self.kv)
        return {"kv_dtype": (str(leaves[0].k.dtype).replace("torch.", "")
                             if leaves else None),
                "kv_quantized": bool(leaves and leaves[0].quantized),
                "kv_bytes": KVC.cache_bytes(self.kv),
                "kv_bytes_by_dtype": KVC.cache_bytes_by_dtype(self.kv)}

    def cancel(self, rid: int) -> bool:
        """Abort ``rid`` at the next step: a queued request is dropped, an
        admitted one retires its slot and frees its pages (shared pages only
        lose this slot's ref). False when ``rid`` is unknown or finished."""
        with self._lock:
            known = (any(r.rid == rid for r in self.queue)
                     or any(r is not None and r.rid == rid
                            for r in self.slot_req))
            if known:
                self._cancel_pending.add(rid)
        return known

    def pause(self, rid: int) -> None:
        """Keep ``rid``'s slot and pages but leave it out of decode segments
        until ``resume``."""
        with self._lock:
            self._paused.add(rid)

    def resume(self, rid: int) -> None:
        with self._lock:
            self._paused.discard(rid)

    def preempt(self, rid: int) -> bool:
        """Spill admitted request ``rid`` to host memory at the next step
        and requeue it. False when ``rid`` is not in a slot."""
        with self._lock:
            known = any(r is not None and r.rid == rid for r in self.slot_req)
            if known:
                self._preempt_pending.add(rid)
        return known

    def retry_after_hint(self) -> float:
        """Backoff hint for shed requests: the smoothed submit-to-finish
        service time, clipped to [0.1 s, 5 s] (0.5 s before any request
        finished)."""
        return float(min(5.0, max(0.1, self._svc_ewma or 0.5)))

    def _note_service(self, dt: float) -> None:
        a = 0.2
        self._svc_ewma = (dt if self._svc_ewma is None
                          else a * dt + (1 - a) * self._svc_ewma)

    # ---- recovery (the supervisor's side) ------------------------------
    def recover(self) -> None:
        """After a crash in ``step``: spill every active slot back to the
        queue, so the next steps re-admit and resume them with no token
        lost or repeated (``out`` persists; ``_collect`` only appends)."""
        with self._pool_lock:
            for s in range(self.num_slots):
                if self.active[s]:
                    self._preempt_slot(s)

    def abort_all(self, msg: str) -> List[Request]:
        """Error out every queued and active request (the supervisor giving
        up): slots retire, pages (handed ones too) return to the pool, and
        each request carries ``error`` (``msg`` unless it had one). Returns
        them."""
        with self._pool_lock:
            reqs = self.extract_all()
            for r in reqs:
                self._drop_payload(r)
                r.error = r.error or msg
        return reqs

    def extract_all(self, detach: bool = False) -> List[Request]:
        """Pop every queued and active request without erroring it (the
        failover harvest after this batcher's worker died). By default
        active slots release their pages: their KV died with the worker,
        partial output and queued payloads survive on the host, and the
        router re-prefills. ``detach=True`` (a shared pool, where the KV
        survives the worker) hands each active slot's used pages to its
        request (``handoff_pages``) so the router can migrate it again
        without a replay. Queued requests pop with their payloads."""
        with self._pool_lock:
            with self._lock:
                reqs = list(self.queue)
                self.queue.clear()
                self._paused.clear()     # every request leaves this batcher
            for s in range(self.num_slots):
                if self.slot_req[s] is not None and self.active[s]:
                    reqs.append(self._detach_slot(s) if detach
                                else self._retire_slot(s))
        return reqs

    # ---- page accounting ---------------------------------------------
    def _alloc_page(self) -> Optional[int]:
        """Pop a free page, evicting prefix-cache entries under pressure."""
        if self.faults is not None and self.faults.fire("alloc_exhaust"):
            return None              # injected exhaustion: pretend pool empty
        if not self.free_pages and self.prefix is not None:
            self.prefix.evict(self.page_refs, self.free_pages, need=1)
        if not self.free_pages:
            return None
        page = self.free_pages.pop()
        self.page_refs[page] = self.page_refs.get(page, 0) + 1
        return page

    def _release_pages(self, pages) -> None:
        for p in pages:
            self.page_refs[p] -= 1
            if self.page_refs[p] == 0:
                del self.page_refs[p]
                self.free_pages.append(p)

    def _cow(self, slot: int, logical: int) -> bool:
        """Give ``slot`` a private copy of its ``logical``-th page. False
        when no page could be allocated."""
        src = int(self.table[slot, logical])
        dst = self._alloc_page()
        if dst is None:
            return False
        KVC.copy_pool_pages(self.kv, src, dst)
        self.cow_copies += 1
        self.table[slot, logical] = dst
        self.slot_req[slot].pages[logical] = dst
        self._release_pages([src])   # drop this slot's ref on the shared page
        return True

    def _make_writable(self, slot: int, lo: int, hi: int) -> bool:
        """Copy-on-write every shared page overlapping token positions
        [lo, hi) of ``slot`` before a dispatch writes there."""
        psz = self.page_size
        for lp in range(lo // psz, (max(hi, lo + 1) - 1) // psz + 1):
            phys = int(self.table[slot, lp])
            if phys != KVC.TRASH_PAGE and self.page_refs.get(phys, 0) > 1:
                if not self._cow(slot, lp):
                    return False
        return True

    def _make_writable_or_preempt(self, s: int, lo: int, hi: int) -> bool:
        """Copy-on-write, spilling the lowest-priority active peer at or
        below this slot's priority when no page is free; with no such peer
        slot ``s`` spills itself (spilling allocates nothing, so this
        ends). False when ``s`` was spilled."""
        while True:
            if self._make_writable(s, lo, hi):
                return True
            me = self.slot_req[s]
            victims = [v for v in range(self.num_slots)
                       if v != s and self.active[v]
                       and self.slot_req[v].priority <= me.priority]
            if not victims:
                self._preempt_slot(s)
                return False
            v = min(victims, key=lambda v: (self.slot_req[v].priority,
                                            -self.slot_req[v].rid))
            self._preempt_slot(v)

    # ---- scheduling between dispatches -------------------------------
    def _order_key(self, r: Request):
        return (-r.priority,
                r.ttft_deadline if r.ttft_deadline is not None
                else float("inf"),
                r.rid)

    def _pop_best(self) -> Optional[Request]:
        """Pop the best queued request: highest priority, then earliest TTFT
        deadline, then oldest rid (a preempted request keeps its rid, so it
        restores ahead of newer peers)."""
        with self._lock:
            if not self.queue:
                return None
            i = min(range(len(self.queue)),
                    key=lambda i: self._order_key(self.queue[i]))
            req = self.queue[i]
            del self.queue[i]
        return req

    def _requeue(self, req: Request) -> None:
        with self._lock:
            self.queue.appendleft(req)

    def _admit(self) -> int:
        new_slots = np.zeros(self.num_slots, bool)
        admitted = []
        budget = self.num_slots     # preemptions allowed per admission pass
        for s in range(self.num_slots):
            if self.active[s]:
                continue
            req = self._pop_best()
            if req is None:
                break
            # a spilled request restores into private pages: its snapshot
            # holds the prefix content already
            restoring = req.spilled is not None
            match = (self.prefix.match(req.prompt, req.cond_fp)
                     if self.prefix is not None and not restoring
                     else KVC.PrefixMatch([], 0, 0))
            # pin the matched pages before any eviction can free them
            for p in match.pages:
                self.page_refs[p] += 1
            total = KVC.pages_for(len(req.prompt) + req.max_new,
                                  self.page_size)
            # a page-handle migration arrives holding refs on the pages of
            # its committed KV: they map as they are, only the rest allocates
            handed = req.handoff_pages or []
            # fresh pages: past the shared prefix and the handed pages, plus
            # a copy destination for a matched partial tail page
            need = (total - len(match.pages) - len(handed)
                    + (1 if match.tail_tokens else 0))
            if need > len(self.free_pages) and self.prefix is not None:
                self.prefix.evict(self.page_refs, self.free_pages, need)
            # spill strictly lower-priority work for the shortfall, within
            # this pass's budget
            while need > len(self.free_pages) and budget > 0:
                victims = [v for v in range(self.num_slots) if self.active[v]
                           and self.slot_req[v].priority < req.priority]
                if not victims:
                    break
                v = min(victims, key=lambda v: (self.slot_req[v].priority,
                                                -self.slot_req[v].rid))
                self._preempt_slot(v)
                budget -= 1
            if need > len(self.free_pages):
                self._release_pages(match.pages)   # unpin; retry next step
                self._requeue(req)
                break
            row: List[int] = []
            ok = True
            pinned_tail = [match.pages[-1]] if match.tail_tokens else []
            row.extend(match.pages[:-1] if match.tail_tokens
                       else match.pages)   # the pin becomes the slot's ref
            if match.tail_tokens:          # copy-on-write the boundary page
                dst = self._alloc_page()
                if dst is None:
                    ok = False
                else:
                    KVC.copy_pool_pages(self.kv, match.pages[-1], dst)
                    self.cow_copies += 1
                    self._release_pages(pinned_tail)   # unpin the source
                    pinned_tail = []
                    row.append(dst)
            row.extend(handed)         # their refs travelled with the request
            while ok and len(row) < total:
                p = self._alloc_page()
                if p is None:
                    ok = False
                else:
                    row.append(p)
            if not ok:
                # unwind every ref this admission took (not the handed
                # pages': they stay with the request); retry next step
                keep = set(handed)
                self._release_pages([p for p in row if p not in keep]
                                    + pinned_tail)
                self._requeue(req)
                break
            req.pages = row
            if not restoring:
                req.shared_tokens = match.n_tokens
            if self.prefix is not None and match.n_tokens > 0:
                self.prefix.hits += 1
                self.prefix.tokens_shared += match.n_tokens
            self.table[s, :] = KVC.TRASH_PAGE
            self.table[s, :len(row)] = row
            self.lengths[s] = match.n_tokens   # prefill resumes at the suffix
            self.plens[s] = len(req.prompt)
            self.stop_at[s] = len(req.prompt) + req.max_new
            self.prompt_buf[s, :] = 0
            self.prompt_buf[s, :len(req.prompt)] = req.prompt
            self.slot_req[s] = req
            self.active[s] = True
            new_slots[s] = True
            admitted.append((s, req, restoring))
        if new_slots.any():
            # recycled slots must not inherit per-slot state
            self.kv = self.dbm.model.reset_paged_slots(
                self.kv, torch.from_numpy(new_slots))
        for s, req, restoring in admitted:    # after the reset
            if restoring:
                self._restore_into_slot(s, req)
            else:
                self._write_conditioning(s, req)
        return int(new_slots.sum())

    def _write_conditioning(self, slot: int, req: Request) -> None:
        """Encode a newly admitted request's conditioning alone, at its true
        length, and write its block into ``slot``'s row once, in place, on
        this thread's stream (every dispatch waits for
        it), and set the slot's ``cond_lengths``."""
        if req.aux_inputs is None:
            self.cond_lengths[slot] = 0
            return
        aux = {k: torch.from_numpy(v)[None].to(self.device)
               for k, v in req.aux_inputs.items()}
        model = self.dbm.model
        model.set_conditioning(
            self.params, self.kv,
            model.encode_conditioning(self.params, aux,
                                      self.eng.encode_ctx()),
            slot)
        self.cond_lengths[slot] = next(iter(req.aux_inputs.values())
                                       ).shape[0]

    def _register_prefixes(self) -> None:
        """Insert freshly prefilled prompts' pages into the prefix cache
        (which takes one ref per page)."""
        if self.prefix is None:
            return
        for s in range(self.num_slots):
            req = self.slot_req[s]
            if (req is None or req.registered or not self.active[s]
                    or self.lengths[s] < self.plens[s]):
                continue
            npg = KVC.pages_for(int(self.plens[s]), self.page_size)
            self.prefix.insert(req.prompt,
                               [int(self.table[s, i]) for i in range(npg)],
                               self.page_refs, req.cond_fp)
            req.registered = True

    # ---- preemption: spill to host, restore --------------------------
    def _clear_slot_row(self, s: int) -> None:
        """Blank slot ``s``'s scheduling row; the slot is free after."""
        self.table[s, :] = KVC.TRASH_PAGE
        self.active[s] = False
        self.lengths[s] = self.plens[s] = self.stop_at[s] = 0
        self.cond_lengths[s] = 0
        self.slot_req[s] = None

    def _spill_slot(self, s: int) -> Request:
        """Snapshot slot ``s``'s used pages (``pages_for(lengths[s])``) to
        host memory, release its pages and free the slot. No dispatch runs
        for a spilled slot, so the round trip draws nothing."""
        req = self.slot_req[s]
        n_used = KVC.pages_for(int(self.lengths[s]), self.page_size)
        used = [int(self.table[s, i]) for i in range(n_used)]
        req.spilled = KVC.spill_slot(self.kv, s, used, self._axes)
        req.spill_meta = dict(length=int(self.lengths[s]),
                              cond_length=int(self.cond_lengths[s]))
        self._release_pages(req.pages)
        req.pages = []
        self._clear_slot_row(s)
        return req

    def _detach_slot(self, s: int) -> Request:
        """The page-handle twin of ``_spill_slot`` on a shared pool: hand
        slot ``s``'s used pages to its request (``handoff_pages``, their
        refs with them; the scratch tail releases) and free the slot. The
        receiving batcher maps those pages, so the migration moves the page
        table, not the KV bytes; shared prefix pages keep their refcounts,
        and copy-on-write still guards a divergent write there."""
        req = self.slot_req[s]
        n_used = KVC.pages_for(int(self.lengths[s]), self.page_size)
        req.handoff_pages = [int(self.table[s, i]) for i in range(n_used)]
        req.spilled = KVC.spill_slot(self.kv, s, [], self._axes)
        req.spill_meta = dict(length=int(self.lengths[s]),
                              cond_length=int(self.cond_lengths[s]))
        self._release_pages(req.pages[n_used:])
        req.pages = []
        self._clear_slot_row(s)
        return req

    def _preempt_slot(self, s: int) -> Request:
        """Spill slot ``s`` and requeue its request at the front with its
        rid and partial output."""
        req = self._spill_slot(s)
        req.preempt_count += 1
        self.preemptions += 1
        self._requeue(req)
        return req

    def _drop_payload(self, req: Request) -> None:
        """Discard the unrestored payload of a request that dies queued:
        the host snapshot drops, and handed pages return their refs to the
        pool."""
        if req.handoff_pages:
            self._release_pages(req.handoff_pages)
        req.handoff_pages = None
        req.spilled = req.spill_meta = None

    def _restore_into_slot(self, s: int, req: Request) -> None:
        """Write a spilled request's snapshot into its new private pages
        (none for a page-handle migration: the handed pages hold it) and
        resume its row at the spilled length."""
        n = req.spilled.n_pages
        KVC.restore_slot(self.kv, s, req.pages[:n], req.spilled, self._axes)
        self.lengths[s] = req.spill_meta["length"]
        self.cond_lengths[s] = req.spill_meta.get("cond_length", 0)
        req.spilled = req.spill_meta = None
        req.handoff_pages = None
        self.restores += 1

    def _apply_preemptions(self) -> None:
        with self._lock:
            pre, self._preempt_pending = self._preempt_pending, set()
        if not pre:
            return
        for s in range(self.num_slots):
            req = self.slot_req[s]
            if req is not None and self.active[s] and req.rid in pre:
                self._preempt_slot(s)

    # ---- retirement ----------------------------------------------------
    def _retire_slot(self, s: int) -> Request:
        """Free slot ``s``: release its page refs (shared pages survive
        while the cache or another slot holds them) and zero its row, so a
        slot cancelled mid-prefill commits nothing more."""
        req = self.slot_req[s]
        self._release_pages(req.pages)
        req.pages = []
        self._clear_slot_row(s)
        with self._lock:
            self._paused.discard(req.rid)
        return req

    def _retire(self) -> List[Request]:
        out = []
        for s in range(self.num_slots):
            req = self.slot_req[s]
            if (req is not None and self.active[s]
                    and self.lengths[s] >= self.stop_at[s]):
                self._note_service(time.time() - req.submit_t)
                out.append(self._retire_slot(s))
        return out

    def _enforce_deadlines(self) -> List[Request]:
        """Retire deadline-blown requests with their partial output: queued
        requests past their TTFT deadline are dropped before admission;
        active slots retire when the first token is late or the output pace
        falls behind ``tpot_deadline_s`` (over the emitted tokens; a paused
        slot is its consumer's stall and is exempt while paused)."""
        now = time.time()
        out: List[Request] = []
        with self._lock:
            kept: collections.deque = collections.deque()
            for r in self.queue:
                if (r.ttft_deadline is not None and r.first_token_t is None
                        and now > r.ttft_deadline):
                    r.deadline_blown = True
                    r.error = "ttft deadline exceeded"
                    self._drop_payload(r)
                    out.append(r)
                else:
                    kept.append(r)
            self.queue = kept
            paused = set(self._paused)
        for s in range(self.num_slots):
            req = self.slot_req[s]
            if req is None or not self.active[s] or req.rid in paused:
                continue
            blown = None
            if (req.ttft_deadline is not None and req.first_token_t is None
                    and now > req.ttft_deadline):
                blown = "ttft deadline exceeded"
            elif (req.tpot_deadline_s is not None and len(req.out) >= 2
                  and ((now - req.first_token_t) / (len(req.out) - 1)
                       > req.tpot_deadline_s)):
                blown = "tpot deadline exceeded"
            if blown:
                req.deadline_blown = True
                req.error = blown
                out.append(self._retire_slot(s))
        self.deadline_cancels += len(out)
        return out

    def _apply_cancellations(self) -> List[Request]:
        """Drop cancelled queued requests and retire cancelled slots.
        Returns the cancelled requests."""
        with self._lock:
            cancels, self._cancel_pending = self._cancel_pending, set()
        if not cancels:
            return []
        out = []
        with self._lock:
            kept = collections.deque()
            for r in self.queue:
                if r.rid in cancels:
                    r.cancelled = True
                    self._drop_payload(r)
                    out.append(r)
                else:
                    kept.append(r)
            self.queue = kept
        for s in range(self.num_slots):
            req = self.slot_req[s]
            if req is not None and req.rid in cancels:
                req.cancelled = True
                out.append(self._retire_slot(s))
        self.cancelled_count += len(out)
        return out

    def _collect(self, emitted: np.ndarray) -> None:
        now = time.time()
        for s in range(self.num_slots):
            req = self.slot_req[s]
            if req is None:
                continue
            toks = [int(t) for t in emitted[s] if t >= 0]
            if toks and req.first_token_t is None:
                req.first_token_t = now
            req.out.extend(toks)
            if toks and self.faults is not None:
                self.faults.maybe_sleep("token_stall")
            if toks and self.token_cb is not None:
                self.token_cb(req, toks)

    def _paused_mask(self) -> np.ndarray:
        with self._lock:
            paused = set(self._paused)
        return np.array([self.slot_req[s] is not None
                         and self.slot_req[s].rid in paused
                         for s in range(self.num_slots)], bool)

    def has_work(self) -> bool:
        """True while queued or active requests or unapplied cancels
        remain."""
        with self._lock:
            pending = bool(self._cancel_pending)
        return pending or bool(self.queue) or bool(self.active.any())

    # ---- the decode segment ------------------------------------------
    def draw_segment(self, n: int):
        """The random draws of an n-step segment, made outside it: each
        step's initial z, σ_max · N(0, 1) of shape (n, num_slots, 1, d),
        and for temperature > 0 the Gumbel noise (n, num_slots, vocab) of
        the categorical draw, from ``generator``. A test may replace this
        to feed another package's draws."""
        return self.eng.draw(n, self.num_slots, self.generator, self.device)

    def _device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    @torch.no_grad()
    def capture(self) -> None:
        """Capture the dispatches this batcher replays: the decode segment,
        and the chunk step in chunked mode (nothing when it runs them
        eagerly). A graph's slots, ``seg_len``, page-table width, policy and
        impl are the batcher's, so each is captured once."""
        if not self.graphs:
            return
        for name in (("chunk", "segment") if self.chunked else ("segment",)):
            self._graph(name)

    def _graph(self, name: str) -> _Graphed:
        """The CUDA graph of dispatch ``name``, captured at first use over
        zeroed static buffers on the batcher's ``stream``. One eager step
        runs first with every slot idle (its writes reach only the trash
        page): it makes the cuBLAS workspaces and the compute-dtype weight
        copy outside the graph's memory pool. The launches the capture
        recorded are taken back off the counters, checked against the
        graph's kernels, and added again at each replay."""
        from repro_torch import kernels as K
        if name in self._graphs:
            return self._graphs[name]
        S, dev = self.num_slots, self.device
        inputs = {k: torch.zeros_like(self._device(getattr(self, k)))
                  for k in _INPUTS[name] + self._cond_inputs
                  if k != "active"}
        cond = {k: inputs[k] for k in self._cond_inputs}
        if name == "chunk":
            def call(_):
                return self.eng._prefill_chunk1(
                    self.params, self.kv, *(inputs[k] for k in _INPUTS[name]),
                    **cond)
        else:
            inputs["active"] = torch.zeros(S, dtype=torch.bool, device=dev)
            inputs["z"] = torch.zeros(
                (self.seg_len, S, 1, self.dbm.cfg.d_model), device=dev)
            inputs["noise"] = (None if self.eng.temperature == 0.0 else
                                torch.zeros((self.seg_len, S,
                                             self.dbm.cfg.vocab_size),
                                            device=dev))

            def call(steps):
                g = inputs["noise"]
                return self.eng._serve(
                    self.params, self.kv, *(inputs[k] for k in _INPUTS[name]),
                    inputs["z"][:steps], None if g is None else g[:steps],
                    **cond)

        cur = torch.cuda.current_stream(dev)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            call(1)
        self.graph_warmups[name] += 1
        before = K.launch_counts()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph, stream=self.stream):
            outputs = call(self.seg_len)
        cur.wait_stream(self.stream)
        launches = {k: c - before[k] for k, c in K.launch_counts().items()
                    if c != before[k]}
        K.add_launch_counts({k: -c for k, c in launches.items()})
        _check_captured(graph, launches)
        graph.instantiate()
        keep = self.dbm.params_for(self.params, self.eng.pol.compute_for(
            self.dbm.cfg.family))
        self._graphs[name] = _Graphed(graph, inputs, outputs, launches, keep)
        return self._graphs[name]

    def _dispatch(self, name: str, host: dict, z=None, noise=None):
        """Run dispatch ``name`` on the ``host`` arrays: a graph replay on
        the batcher's ``stream`` (ordered after the caller's stream, which
        then waits for it), else the engine's call. Returns its outputs
        after the pool: (lengths,) or (lengths, emitted)."""
        from repro_torch import kernels as K
        if not self.graphs:
            args = [self._device(host[k]) for k in _INPUTS[name]]
            cond = {k: self._device(host[k]) for k in self._cond_inputs}
            if name == "chunk":
                return self.eng._prefill_chunk1(self.params, self.kv,
                                                 *args, **cond)[1:]
            return self.eng._serve(
                self.params, self.kv, *args,
                torch.as_tensor(z, dtype=torch.float32, device=self.device),
                None if noise is None else torch.as_tensor(
                    noise, dtype=torch.float32, device=self.device),
                **cond)[1:]
        g = self._graph(name)
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            for k in _INPUTS[name] + self._cond_inputs:
                g.inputs[k].copy_(torch.from_numpy(host[k]))
            if name == "segment":
                g.inputs["z"].copy_(z)
                if noise is not None:
                    g.inputs["noise"].copy_(noise)
            g.graph.replay()
            out = [_host(t) for t in g.outputs[1:]]
        cur.wait_stream(self.stream)
        K.add_launch_counts(g.launches)
        return out

    @property
    def _cond_inputs(self) -> tuple:
        """The host array a conditioned family's dispatches also read (a
        keyword argument of the engine's calls)."""
        return ("cond_lengths",) if self.conditioned else ()

    def _chunk(self) -> np.ndarray:
        """One prefill-chunk dispatch; returns the host lengths."""
        lengths, = self._dispatch("chunk", dict(
            table=self.table, lengths=self.lengths,
            prompt_buf=self.prompt_buf, plens=self.plens,
            cond_lengths=self.cond_lengths))
        return _host(lengths).astype(np.int32)

    def _decode_segment(self, active: np.ndarray):
        """One decode segment for the ``active`` slots. Returns host
        (lengths, emitted (num_slots, seg_len))."""
        z, noise = self.draw_segment(self.seg_len)
        lengths, emitted = self._dispatch("segment", dict(
            table=self.table, lengths=self.lengths,
            prompt_buf=self.prompt_buf, plens=self.plens,
            stop_at=self.stop_at, active=active,
            cond_lengths=self.cond_lengths), z, noise)
        return _host(lengths).astype(np.int32), _host(emitted)

    # ---- the loop ------------------------------------------------------
    @torch.no_grad()
    def step(self, *, strict: bool = True) -> List[Request]:
        """One scheduling iteration (see the class docstring). Returns the
        requests finished, cancelled or rejected in it.

        ``strict=True`` raises when the head of the queue can never be
        admitted (it needs more pages than the pool holds); ``strict=False``
        pops it with ``error`` set instead. Pool exhaustion during
        copy-on-write never raises: the lowest-priority slot spills. On a
        ``SharedPagePool`` the step holds the pool's lock, so the sharers
        step one at a time."""
        with self._pool_lock:
            finished = self._step(strict=strict)
        if KVC.pool_ptrs(self.kv) != self._pool_ptrs:
            raise RuntimeError("the page pool's storage moved: a captured "
                               "decode segment would read freed memory")
        return finished

    def _step(self, *, strict: bool = True) -> List[Request]:
        if self.faults is not None:
            # injected BEFORE any bookkeeping mutates; worker_die is the
            # harder failure (simulated process death, no restart)
            self.faults.maybe_raise("engine_crash")
            if self.faults.fire("worker_die"):
                raise WorkerDied(
                    f"injected worker_die "
                    f"(call {self.faults.calls['worker_die']})")
        finished = self._apply_cancellations()
        self._apply_preemptions()
        finished.extend(self._enforce_deadlines())
        if not (self.queue or self.active.any()):
            return finished
        if not self._admit() and not self.active.any():
            # nothing running and nothing admitted: impossible only when the
            # head request needs more pages than the pool can ever hold
            req = self._pop_best()
            if req is None:
                return finished
            need = KVC.pages_for(len(req.prompt) + req.max_new,
                                 self.page_size)
            if need <= self.total_pages - 1:
                self._requeue(req)
                return finished
            msg = ("page pool too small for the next queued request "
                   f"(needs {need} of {self.total_pages - 1} pages)")
            if strict:
                self._requeue(req)
                raise RuntimeError(msg)
            req.error = msg
            self._drop_payload(req)
            finished.append(req)
            return finished
        in_prompt = self.active & (self.lengths < self.plens)
        if self.chunked and in_prompt.any():
            # one chunk dispatch advances every prefilling slot by up to
            # chunk_size tokens; the other slots see n_valid == 0
            for s in np.nonzero(in_prompt)[0]:
                if not self.active[s]:
                    continue        # spilled by an earlier slot's CoW relief
                lo = int(self.lengths[s])
                hi = min(lo + self.chunk_size, int(self.plens[s]))
                self._make_writable_or_preempt(s, lo, hi)
            in_prompt = self.active & (self.lengths < self.plens)
        if self.chunked and in_prompt.any():
            self.lengths = self._chunk()
            self.eng.dispatches += 1
            self.eng.prefill_steps += 1
            self.ingest_dispatches += 1
            self._register_prefixes()
        decode_ready = (self.active & (self.lengths >= self.plens)
                        if self.chunked else self.active)
        decode_ready = decode_ready & ~self._paused_mask()
        if decode_ready.any():
            for s in np.nonzero(decode_ready)[0]:
                if not self.active[s]:
                    continue        # spilled by an earlier slot's CoW relief
                lo = int(self.lengths[s])
                hi = min(lo + self.seg_len, int(self.stop_at[s]))
                self._make_writable_or_preempt(s, lo, hi)
            decode_ready = decode_ready & self.active
        if decode_ready.any():
            self.lengths, emitted = self._decode_segment(decode_ready)
            self.eng.dispatches += 1
            self.decode_dispatches += 1
            self.steps += self.seg_len
            self._collect(emitted)
            if not self.chunked:
                self._register_prefixes()
        finished.extend(self._retire())
        return finished

    def run(self) -> List[Request]:
        """Drain the queue; returns the finished requests by rid."""
        finished = []
        while self.has_work():
            finished.extend(self.step())
        return sorted(finished, key=lambda r: r.rid)


# ---------------------------------------------------------------------------
# Command line
# ---------------------------------------------------------------------------

def cli_device(name: str) -> torch.device:
    """The device a serving CLI runs on: the card unless the caller asks
    for the CPU (the plain versions)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the port serves on the card "
                         "(pass --device cpu to run its plain versions)")
    return device


def load_model(args, device: torch.device):
    """(cfg, dbm, params, generator) for a serving CLI: ``args.arch``
    (reduced unless ``args.full``) in ``args.blocks`` blocks, random
    weights from ``args.seed``, then the blocks saved in ``args.ckpt_dir``
    (``block_XX.npz``, JAX's layout) where given. The generator goes on to
    make the serving draws."""
    cfg = get_config(args.arch)
    cfg = cfg if args.full else reduced(cfg)
    db = DBConfig(num_blocks=min(args.blocks, build_model(cfg).n_units),
                  overlap_gamma=0.1)
    dbm = DiffusionBlocksModel(cfg, db)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = dbm.init(gen)
    if args.ckpt_dir:
        load_blocks(args.ckpt_dir, params, dbm.ranges)
    return cfg, dbm, params, gen


def conditioning_pool(dbm, n: int, rs: np.random.RandomState):
    """(aux key, ``n`` conditioning inputs (Sk, d) fp32 from ``rs``) for
    ``--conditioned``, as JAX's CLIs draw them; exits for a family that
    takes no aux inputs."""
    specs = dbm.model.aux_input_specs(1)
    if not specs:
        raise SystemExit(f"--conditioned: family {dbm.cfg.family!r} takes "
                         "no aux inputs (pick a vlm or audio arch)")
    Sk = dbm.model.max_cond_tokens
    return next(iter(specs)), [rs.randn(Sk, dbm.cfg.d_model).astype(
        np.float32) for _ in range(n)]


def add_model_args(ap: argparse.ArgumentParser) -> None:
    """The model arguments both serving CLIs take (see ``load_model``)."""
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--full", action="store_true",
                    help="serve the published widths (default: reduced)")
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--ckpt-dir", default="",
                    help="serve the blocks saved here (block_XX.npz)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and noise")
    ap.add_argument("--device", default="cuda")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_model_args(ap)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--scheduler", choices=("static", "continuous"),
                    default="static")
    ap.add_argument("--steps-per-block", type=int, default=1)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--precision", default="bf16")
    ap.add_argument("--kv-dtype", default=None,
                    choices=("int8", "bf16", "fp32", "auto"))
    ap.add_argument("--impl", default="kernels", choices=KVC.IMPLS,
                    help="kernels: the Hopper kernels; ref: their plain "
                         "PyTorch versions")
    ap.add_argument("--prefill", choices=("chunked", "per-token"),
                    default="chunked",
                    help="prompt ingest: chunked, or the per-token "
                         "reference")
    ap.add_argument("--chunk-size", type=int, default=DEFAULT_CHUNK)
    ap.add_argument("--prefix-cache", action="store_true",
                    help="continuous: share prompt-prefix pages across "
                         "requests (copy-on-write)")
    ap.add_argument("--page-size", type=int, default=KVC.DEFAULT_PAGE_SIZE)
    ap.add_argument("--num-slots", type=int, default=4,
                    help="continuous: concurrent request slots")
    ap.add_argument("--seg-len", type=int, default=16,
                    help="continuous: decode steps between host scheduling")
    ap.add_argument("--requests", type=int, default=12,
                    help="continuous: queued requests")
    ap.add_argument("--ragged", action="store_true",
                    help="vary prompt lengths across the batch/queue")
    ap.add_argument("--conditioned", action="store_true",
                    help="attach image or audio conditioning (vlm and "
                         "audio archs): random "
                         "embeddings from a small pool, so the "
                         "conditioning-aware prefix cache can hit")
    ap.add_argument("--cond-pool", type=int, default=3,
                    help="distinct conditioning inputs in the pool")
    args = ap.parse_args(argv)

    device = cli_device(args.device)
    cfg, dbm, params, gen = load_model(args, device)

    lm = MarkovLM(vocab_size=cfg.vocab_size, seed=7)
    rs = np.random.RandomState(1)
    aux_key, pool = (conditioning_pool(dbm, args.cond_pool, rs)
                     if args.conditioned else (None, []))
    kw = dict(steps_per_block=args.steps_per_block,
              temperature=args.temperature, top_k=args.top_k,
              precision=args.precision, kv_dtype=args.kv_dtype,
              impl=args.impl, prefill=args.prefill,
              chunk_size=min(args.chunk_size, max(args.prompt_len, 1)))

    if args.scheduler == "static":
        prompts = lm.sample(rs, args.batch, args.prompt_len)
        plens = None
        if args.ragged:
            plens = rs.randint(max(2, args.prompt_len // 2),
                               args.prompt_len + 1, size=args.batch)
        aux = (None if aux_key is None else
               {aux_key: np.stack([pool[0]] * args.batch)})
        eng = get_engine(dbm, **kw)
        t0 = time.perf_counter()
        out = eng.generate(params, prompts, args.max_new,
                           prompt_lengths=plens, page_size=args.page_size,
                           generator=gen, aux_inputs=aux)
        dt = time.perf_counter() - t0
        n_tok = args.batch * args.max_new
        print(f"[static] {cfg.name} on {device}: generated {args.batch}x"
              f"{args.max_new} tokens in {dt:.2f}s ({n_tok / dt:.1f} tok/s "
              f"incl. kernel builds) | ttft "
              f"{eng.last_timing['ttft_ms']:.1f} ms | "
              f"dispatches={eng.dispatches} | prefill={args.prefill} "
              f"({eng.prefill_steps} serial steps) | "
              f"cache={KVC.cache_bytes(eng.last_kv) / 1e6:.1f}MB paged")
        rows = out.numpy()
        lens = (np.asarray(plens) if plens is not None
                else np.full(args.batch, args.prompt_len)) + args.max_new
        seqs = [rows[b, :lens[b]] for b in range(args.batch)]
    else:
        cb = ContinuousBatcher(dbm, params, num_slots=args.num_slots,
                               page_size=args.page_size,
                               max_prompt=args.prompt_len,
                               max_len=args.prompt_len + args.max_new,
                               seg_len=args.seg_len,
                               prefix_cache=args.prefix_cache,
                               generator=gen, **kw)
        for i in range(args.requests):
            plen = (rs.randint(max(2, args.prompt_len // 2),
                               args.prompt_len + 1)
                    if args.ragged else args.prompt_len)
            aux = None if aux_key is None else {aux_key: pool[i % len(pool)]}
            cb.submit(lm.sample(rs, 1, plen)[0], args.max_new,
                      aux_inputs=aux)
        t0 = time.perf_counter()
        done = cb.run()
        dt = time.perf_counter() - t0
        n_tok = sum(len(r.out) for r in done)
        ttfts = [r.ttft for r in done if r.ttft is not None]
        disp = cb.eng.dispatches
        print(f"[continuous] {cfg.name} on {device}: served {len(done)} "
              f"requests / {n_tok} tokens in {dt:.2f}s ({n_tok / dt:.1f} "
              f"tok/s incl. kernel builds and graph capture) | "
              f"slots={args.num_slots} pool={cb.total_pages} pages x "
              f"{args.page_size} | dispatches={disp} "
              f"({disp / max(n_tok, 1):.3f}/token) | mean TTFT "
              f"{np.mean(ttfts):.3f}s | "
              f"cache={KVC.cache_bytes(cb.kv) / 1e6:.1f}MB paged")
        if cb.prefix is not None:
            print(f"prefix cache: {cb.prefix.hits} hits, "
                  f"{sum(r.shared_tokens for r in done)} prompt tokens "
                  f"served from shared pages, {cb.cow_copies} copy-on-write "
                  f"page copies")
        seqs = [np.concatenate([r.prompt, np.asarray(r.out, np.int64)])
                for r in done]
    print("legal-transition rate:", _ragged_transition_accuracy(lm, seqs))


if __name__ == "__main__":
    main()
