"""Disaggregated prefill/decode serving with fault-tolerant migration (port
of ``repro.launch.router``).

``DisaggRouter`` fronts a fleet of supervised workers (``launch.workers``):
prompts go to PREFILL workers, and the moment a prompt is committed the
request MIGRATES to a DECODE worker, as a ``SpilledSlot`` byte-copy payload
(``handoff="copy"``, separate pools) or as page handles
(``handoff="pages"``, one ``SharedPagePool``), so a long prompt's ingest
never takes chunk dispatches from the decode segments. A migration draws
nothing: the prefill side runs no decode step for a migrating request, so
the decode worker's greedy output equals an uninterrupted unified run's.

Every seam is built to fail:

  handoff loss      the ``handoff_drop`` hook loses the payload in transit:
                    the router RE-PREFILLS, a fresh inner request whose
                    prompt is the original prompt plus every token already
                    delivered (greedy decoding makes the continuation
                    exact), from the prefix cache where one is configured.
  handoff timeout   a send slower than ``handoff_timeout_s`` (the
                    ``handoff_stall`` hook) keeps the payload and retries
                    with exponential backoff, ``handoff_max_retries`` times,
                    then falls back to a re-prefill.
  worker death      ``WorkerDied`` (the ``worker_die`` hook) ends the engine
                    thread with no recovery and no stream cleanup. The
                    router's sweep notices (thread gone or ``died``),
                    harvests the batcher (``extract_all``) and fails the
                    survivors over: requests whose payload is intact migrate
                    again (page handles stay valid on a shared pool), the
                    others re-prefill from prompt + delivered tokens. A dead
                    worker restarts after ``restart_dead_after_s`` if set.
  role wipe-out     with every worker of one role down the router DEGRADES
                    to unified mode: the survivors serve prefill and decode
                    (``PrefillBatcher.boundary_spill = False``) and pending
                    handoffs land wherever there is life. When both roles
                    have survivors again it RE-SPLITS; a request caught
                    decoding on a prefill worker meets the boundary at its
                    next step and migrates out.

Draws: JAX gives each worker its own key and hands a dead decode worker's
key to an idle receiver. Here each worker's batcher draws from its own
``generator`` (seeded from ``seed``) or from the ``draw_segment`` a caller
set on it; a failover hands the dead batcher's draw source (generator
state and ``draw_segment``) to an idle receiver, so the continuation is
bit-identical to the uninterrupted run.

Admission control is the single engine's: ``max_queue`` sheds by the
priority-aware backlog not yet decoding, ``shed_below_pages`` sheds batch
work under decode-pool pressure, both with ``AdmissionError`` and its
``retry_after`` hint.

Threading: the workers' engine threads call ``_worker_tokens`` and
``_worker_finish`` (router lock only); the router's tick thread owns
handoffs, failover, mode flips and cancellation. The tick thread never
takes a batcher's pool lock while it holds the router lock: engine threads
hold their pool lock when they call back into the router lock, so the other
order would deadlock. On the card every worker's graphs are captured in
``start``, on the calling thread, one worker after another, before any
worker's engine thread or the tick thread runs: a CUDA call from another
thread breaks a capture, and nothing captures after.
"""
from __future__ import annotations

import collections
import copy
import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.launch.faults import FaultInjector
from repro_torch.launch.serve import (PRIORITY_CLASSES, AdmissionError,
                                      ContinuousBatcher, Request,
                                      SharedPagePool)
from repro_torch.launch.server import EngineRunner, _weak_method
from repro_torch.launch.workers import PrefillBatcher, Worker
from repro_torch.nn import cache as KVC


@dataclasses.dataclass
class RoutedRequest:
    """The router's client-facing record of a request. Worker-side
    ``Request``s (``inner``) come and go (migration moves one between
    workers, failover may replace it), but THIS object owns the delivered
    tokens and the terminal flags, and has what the HTTP frontend's
    ``TokenStream`` and ``_final_payload`` read of a ``Request``."""
    rid: int
    prompt: np.ndarray
    max_new: int
    aux_inputs: Optional[dict] = None   # {"image_embs"/"audio_embs": (Sk, d)}
    cond_fp: int = 0                    # its conditioning fingerprint
    priority: int = PRIORITY_CLASSES["standard"]
    ttft_deadline: Optional[float] = None
    tpot_deadline_s: Optional[float] = None
    out: List[int] = dataclasses.field(default_factory=list)
    submit_t: float = 0.0
    first_token_t: Optional[float] = None
    cancelled: bool = False
    error: Optional[str] = None
    deadline_blown: bool = False
    preempt_count: int = 0
    migrations: int = 0          # completed prefill -> decode handoffs
    failovers: int = 0           # re-routed off a dead worker
    paused: bool = False         # consumer backpressure (survives migration)
    phase: str = "prefill"       # prefill | handoff | decode | done
    where: Optional[str] = None  # the worker holding it now
    inner: Optional[Request] = None
    finished: bool = False
    # a dead worker's draw source, taken at failover (``worker_die`` raises
    # before the step draws anything, so it is the exact resume state): an
    # idle receiving decode worker adopts it and the continuation is
    # bit-identical; a busy one keeps its own (a different, valid sample)
    resume_draws: Optional[tuple] = None

    @property
    def ttft(self) -> Optional[float]:
        return (None if self.first_token_t is None
                else self.first_token_t - self.submit_t)


@dataclasses.dataclass
class _Handoff:
    """One prefill -> decode migration in transit, owned by the router."""
    inner: Request
    routed: RoutedRequest
    attempts: int = 0
    due: float = 0.0             # earliest send time (backoff)


def _draw_source(cb: ContinuousBatcher) -> tuple:
    """What a batcher draws from: its generator's state and the
    ``draw_segment`` set on it (None: its own method)."""
    return cb.generator.get_state(), cb.__dict__.get("draw_segment")


def _adopt_draws(cb: ContinuousBatcher, source: tuple) -> None:
    """Make ``cb`` draw from here on as the batcher ``source`` was taken
    from would have."""
    state, draw = source
    cb.generator.set_state(state)
    if draw is None:
        cb.__dict__.pop("draw_segment", None)
    else:
        cb.draw_segment = copy.copy(draw)


class DisaggRouter:
    """Coordinator over ``n_prefill`` + ``n_decode`` supervised workers.

    Has enough of the ``ContinuousBatcher`` surface (``submit``,
    ``cancel``, ``pause``, ``resume``, ``retry_after_hint``, ``dbm``,
    ``max_prompt``, ``max_len``, ``eng``, ``token_cb``) for
    ``InferenceServer`` to drive it through ``RouterRunner``; ``is_router``
    tells them apart. ``cb_kw`` are the workers' ``ContinuousBatcher``
    arguments; each worker's draws come from a generator seeded from
    ``seed``."""

    is_router = True

    def __init__(self, dbm, params, *, n_prefill: int = 1, n_decode: int = 1,
                 handoff: str = "copy",
                 shared_pages: Optional[int] = None,
                 handoff_timeout_s: float = 0.5,
                 handoff_max_retries: int = 3,
                 handoff_backoff_s: float = 0.02,
                 restart_dead_after_s: Optional[float] = None,
                 tick_s: float = 0.002,
                 max_queue: Optional[int] = None,
                 shed_below_pages: int = 0,
                 faults: Optional[FaultInjector] = None,
                 seed: int = 0, max_restarts: int = 3, **cb_kw):
        if n_prefill < 1 or n_decode < 1:
            raise ValueError("need at least one worker per role")
        if handoff not in ("copy", "pages"):
            raise ValueError(f"handoff must be 'copy' or 'pages', "
                             f"got {handoff!r}")
        self.dbm, self.params = dbm, params
        self.handoff = handoff
        self.handoff_timeout_s = float(handoff_timeout_s)
        self.handoff_max_retries = int(handoff_max_retries)
        self.handoff_backoff_s = float(handoff_backoff_s)
        self.restart_dead_after_s = restart_dead_after_s
        self.tick_s = float(tick_s)
        self.max_queue = max_queue
        self.shed_below_pages = int(shed_below_pages)
        self.faults = faults
        self.max_prompt = int(cb_kw.get("max_prompt", 64))
        self.max_len = int(cb_kw.get("max_len", 128))
        # worker batchers take prompts up to max_len: a re-prefill replays
        # the original prompt + the delivered tokens as its prompt
        inner_kw = dict(cb_kw, max_prompt=self.max_len, faults=faults)
        self.pool: Optional[SharedPagePool] = None
        if handoff == "pages":
            if shared_pages is None:
                slots = int(cb_kw.get("num_slots", 8))
                pps = KVC.pages_for(self.max_len,
                                    int(cb_kw.get("page_size",
                                                  KVC.DEFAULT_PAGE_SIZE)))
                shared_pages = 1 + (n_prefill + n_decode) * slots * pps
            self.pool = SharedPagePool(shared_pages)
            inner_kw["shared_pool"] = self.pool
        device = params["embed"]["table"].device
        seeds = np.random.SeedSequence(seed).generate_state(
            n_prefill + n_decode)

        def generator(i):
            return torch.Generator(device=device).manual_seed(int(seeds[i]))

        self.prefill_workers: List[Worker] = []
        self.decode_workers: List[Worker] = []
        for i in range(n_prefill):
            cb = PrefillBatcher(dbm, params, handoff=handoff,
                                generator=generator(i), **inner_kw)
            self.prefill_workers.append(self._make_worker(
                f"prefill{i}", "prefill", cb, max_restarts))
        # decode workers admit no fresh prompt in split mode, so a prefix
        # cache there would only take refs and never hit
        dec_kw = dict(inner_kw, prefix_cache=False)
        for i in range(n_decode):
            cb = ContinuousBatcher(dbm, params,
                                   generator=generator(n_prefill + i),
                                   **dec_kw)
            self.decode_workers.append(self._make_worker(
                f"decode{i}", "decode", cb, max_restarts))
        self.workers = self.prefill_workers + self.decode_workers
        self._by_name = {w.name: w for w in self.workers}
        # ---- router state (guarded by _lock) ----
        self._lock = threading.RLock()
        self.requests: Dict[int, RoutedRequest] = {}
        self._handoffs: collections.deque = collections.deque()
        self._pending_submit: collections.deque = collections.deque()
        self._cancel_pending: set = set()
        self._next_rid = 0
        self.mode = "split"          # split | unified (degraded)
        # ---- counters ----
        self.migrations = 0
        self.failovers = 0
        self.handoff_retries = 0
        self.handoff_drops = 0
        self.re_prefills = 0
        self.degradations = 0
        self.resplits = 0
        self.completed = 0
        self.shed_count = 0
        self._svc_ewma: Optional[float] = None
        # ---- frontend hooks ----
        self.token_cb: Optional[Callable] = None
        self.finish_cb: Optional[Callable] = None
        self._stopping = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.capture_s: List[float] = []   # each worker's capture, in start

    def _make_worker(self, name, role, cb, max_restarts) -> Worker:
        # the workers reach the router weakly: no cycle keeps the fleet's
        # pools and graphs alive once the router is dropped
        return Worker(name, role, cb, max_restarts=max_restarts,
                      on_tokens=_weak_method(self._worker_tokens),
                      on_finish=_weak_method(self._worker_finish))

    # ---- engine surface for InferenceServer ---------------------------
    @property
    def eng(self):
        return self.prefill_workers[0].cb.eng

    @property
    def device(self) -> torch.device:
        return self.prefill_workers[0].cb.device

    def retry_after_hint(self) -> float:
        return float(min(5.0, max(0.1, self._svc_ewma or 0.5)))

    def _note_service(self, dt: float) -> None:
        a = 0.2
        self._svc_ewma = (dt if self._svc_ewma is None
                          else a * dt + (1 - a) * self._svc_ewma)

    # ---- lifecycle -----------------------------------------------------
    def start(self) -> None:
        """Capture every worker's graphs on this thread, one worker after
        another (``capture_s``), then start the workers' engine threads,
        which replay them, and the tick thread: no capture happens after
        this returns. One thread captures them all: on an H100, fleets
        captured so started 1.2-3.3x faster than with each worker capturing
        on its own new engine thread (``chip_smoke.py`` phase 5d)."""
        for w in self.workers:
            t0 = time.perf_counter()
            if w.cb.device.type == "cuda":
                with torch.cuda.device(w.cb.device):
                    w.cb.capture()
            self.capture_s.append(time.perf_counter() - t0)
        for w in self.workers:
            w.start()
        self._thread = threading.Thread(target=self._main, name="router",
                                        daemon=True)
        self._thread.start()

    def wake(self) -> None:
        for w in self.workers:
            w.wake()

    def stop(self, timeout: Optional[float] = 60.0) -> None:
        """Drain: wait for every accepted request to finish (the tick
        thread goes on migrating and failing over meanwhile), error the
        stragglers past ``timeout`` so no stream hangs, then stop the
        workers and the tick thread."""
        deadline = time.time() + (timeout if timeout is not None else 60.0)
        while time.time() < deadline:
            with self._lock:
                if all(r.finished for r in self.requests.values()):
                    break
            self.wake()
            time.sleep(0.01)
        stuck = []
        with self._lock:
            for r in self.requests.values():
                if not r.finished:
                    r.error = r.error or "router drain timeout"
                    stuck.append(r)
        for r in stuck:
            if r.inner is not None:
                self._drop_payload(r.inner)
            self._finish_routed(r)
        self._stopping.set()
        for w in self.workers:
            if w.runner._thread.is_alive():
                w.stop(5.0)
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(5.0)

    # ---- submission ----------------------------------------------------
    def submit(self, prompt, max_new: int, aux_inputs=None, *,
               priority="standard", ttft_slo_s: Optional[float] = None,
               tpot_slo_s: Optional[float] = None) -> int:
        """Route a request to a prefill worker; returns its rid. Raises
        ``ValueError`` for a request the workers cannot take and
        ``AdmissionError`` when admission control sheds it. ``aux_inputs``
        conditions the request as ``ContinuousBatcher.submit``'s do; it
        travels with every re-prefill, and the conditioning block with every
        migration (the dense row of the payload)."""
        aux_inputs = ContinuousBatcher.check_aux(self.dbm, aux_inputs)
        if isinstance(priority, str):
            if priority not in PRIORITY_CLASSES:
                raise ValueError(f"unknown priority class {priority!r}: "
                                 f"expected {sorted(PRIORITY_CLASSES)}")
            priority = PRIORITY_CLASSES[priority]
        priority = int(priority)
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
        with self._lock:
            if self.max_queue is not None:
                backlog = sum(1 for r in self.requests.values()
                              if not r.finished and r.phase != "decode"
                              and r.priority >= priority)
                if backlog >= self.max_queue:
                    self.shed_count += 1
                    raise AdmissionError(
                        f"pre-decode backlog {backlog} at priority >= "
                        f"{priority} over threshold {self.max_queue}",
                        self.retry_after_hint())
            if self.shed_below_pages and priority <= 0:
                free = self._decode_free_pages()
                if free < self.shed_below_pages:
                    self.shed_count += 1
                    raise AdmissionError(
                        f"decode pool pressure: {free} free pages below "
                        f"threshold {self.shed_below_pages}",
                        self.retry_after_hint())
            rid = self._next_rid
            self._next_rid += 1
            routed = RoutedRequest(
                rid, prompt, int(max_new), aux_inputs=aux_inputs,
                cond_fp=KVC.conditioning_fingerprint(aux_inputs),
                priority=priority, tpot_deadline_s=tpot_slo_s)
            routed.submit_t = time.time()
            if ttft_slo_s is not None:
                routed.ttft_deadline = routed.submit_t + float(ttft_slo_s)
            self.requests[rid] = routed
            inner = self._make_inner(routed, prompt, int(max_new))
            target = self._ingest_target()
            if target is None:       # no life anywhere: park for restarts
                self._pending_submit.append((inner, routed))
            else:
                self._place(inner, routed, target)
        return rid

    def _make_inner(self, routed: RoutedRequest, prompt,
                    max_new: int) -> Request:
        inner = Request(routed.rid, np.asarray(prompt, np.int64), max_new,
                        aux_inputs=routed.aux_inputs, cond_fp=routed.cond_fp,
                        priority=routed.priority,
                        tpot_deadline_s=routed.tpot_deadline_s)
        inner.submit_t = routed.submit_t
        # TTFT binds only until the first token was delivered: a failover
        # re-prefill after it must not re-arm the deadline
        if routed.first_token_t is None:
            inner.ttft_deadline = routed.ttft_deadline
        routed.inner = inner
        return inner

    def _place(self, inner: Request, routed: RoutedRequest,
               target: Worker) -> None:
        decode_ready = (inner.spilled is not None
                        and inner.spill_meta["length"] >= len(inner.prompt))
        routed.phase = "decode" if decode_ready else "prefill"
        routed.where = target.name
        if decode_ready:
            self._maybe_adopt_draws(routed, target)
        target.cb.submit_request(inner)
        if routed.paused:
            target.cb.pause(inner.rid)
        target.wake()

    # ---- target selection ---------------------------------------------
    @staticmethod
    def _alive(workers: List[Worker]) -> List[Worker]:
        return [w for w in workers if w.alive]

    @staticmethod
    def _least_loaded(workers: List[Worker]) -> Optional[Worker]:
        if not workers:
            return None
        return min(workers, key=lambda w: (len(w.cb.queue)
                                           + int(w.cb.active.sum())))

    def _ingest_target(self) -> Optional[Worker]:
        cand = self._alive(self.prefill_workers)
        if not cand or self.mode == "unified":
            cand = cand or self._alive(self.workers)
        return self._least_loaded(cand)

    def _decode_target(self) -> Optional[Worker]:
        cand = self._alive(self.decode_workers)
        if not cand or self.mode == "unified":
            cand = cand or self._alive(self.workers)
        return self._least_loaded(cand)

    def _decode_free_pages(self) -> int:
        if self.pool is not None:
            return len(self.pool.free_pages)
        alive = self._alive(self.decode_workers) or self.decode_workers
        return max(len(w.cb.free_pages) for w in alive)

    # ---- flow control / cancellation ----------------------------------
    def cancel(self, rid: int) -> bool:
        with self._lock:
            routed = self.requests.get(rid)
            if routed is None or routed.finished:
                return False
            self._cancel_pending.add(rid)
        self.wake()
        return True

    def pause(self, rid: int) -> None:
        with self._lock:
            routed = self.requests.get(rid)
            if routed is None:
                return
            routed.paused = True
            w = self._by_name.get(routed.where)
        if w is not None:
            w.cb.pause(rid)

    def resume(self, rid: int) -> None:
        with self._lock:
            routed = self.requests.get(rid)
            if routed is None:
                return
            routed.paused = False
            w = self._by_name.get(routed.where)
        if w is not None:
            w.cb.resume(rid)
            w.wake()

    # ---- worker callbacks (engine threads) -----------------------------
    def _worker_tokens(self, req: Request, toks: List[int]) -> None:
        with self._lock:
            routed = self.requests.get(req.rid)
            if routed is None or routed.finished:
                return
            if routed.first_token_t is None and toks:
                routed.first_token_t = time.time()
            routed.out.extend(toks)
            cb = self.token_cb
        if cb is not None:
            cb(routed, toks)

    def _worker_finish(self, req: Request) -> None:
        with self._lock:
            routed = self.requests.get(req.rid)
            if routed is None or routed.finished:
                return
            if routed.inner is not req:
                return               # a superseded inner (failover race)
            routed.cancelled = routed.cancelled or req.cancelled
            routed.deadline_blown = (routed.deadline_blown
                                     or req.deadline_blown)
            routed.error = routed.error or req.error
            routed.preempt_count += req.preempt_count
            self._note_service(time.time() - routed.submit_t)
            self._finish_routed(routed)

    def _finish_routed(self, routed: RoutedRequest) -> None:
        """Terminal bookkeeping and the frontend's notice. Any thread; the
        caller checks ``finished`` under ``_lock`` first."""
        routed.finished = True
        routed.phase = "done"
        routed.inner = None
        routed.where = None
        self.completed += 1
        cb = self.finish_cb
        if cb is not None:
            cb(routed)

    # ---- payload plumbing (tick thread; pool locks, NOT router lock) ---
    def _drop_payload(self, inner: Request) -> None:
        """Release an in-router migration payload: page-handle refs return
        to the shared pool, host snapshots drop."""
        cb = self.workers[0].cb
        with cb._pool_lock:
            cb._drop_payload(inner)

    def _re_prefill(self, routed: RoutedRequest) -> None:
        """Last-resort recovery: rebuild the request from its delivered
        tokens, the prompt being the original prompt + the delivered tokens
        and ``max_new`` the remainder (greedy decoding makes this exact; a
        prefix cache turns the replay into a page map). No lock held."""
        with self._lock:
            if routed.finished:
                return
            delivered = list(routed.out)
            remaining = routed.max_new - len(delivered)
            if remaining <= 0:
                self._finish_routed(routed)
                return
            prompt = (np.concatenate([routed.prompt,
                                      np.asarray(delivered, np.int64)])
                      if delivered else routed.prompt)
            inner = self._make_inner(routed, prompt, remaining)
            self.re_prefills += 1
            target = self._ingest_target()
            if target is None:
                routed.phase = "prefill"
                routed.where = None
                self._pending_submit.append((inner, routed))
            else:
                self._place(inner, routed, target)

    # ---- the tick loop --------------------------------------------------
    def _main(self) -> None:
        while not self._stopping.is_set():
            try:
                self._collect_ready()
                self._send_handoffs()
                self._check_workers()
                self._update_mode()
                self._apply_cancels()
                self._flush_pending()
            except Exception:        # noqa: BLE001 -- the router outlives
                import traceback     # any one tick's surprise
                traceback.print_exc()
            time.sleep(self.tick_s)

    def _collect_ready(self) -> None:
        """Move boundary-spilled requests off every prefill worker into the
        handoff queue (a request that died meanwhile drops its payload)."""
        drops = []
        for w in self.prefill_workers:
            for inner in w.cb.drain_ready():
                with self._lock:
                    routed = self.requests.get(inner.rid)
                    live = (routed is not None and not routed.finished
                            and routed.inner is inner)
                    if live:
                        routed.phase = "handoff"
                        routed.where = None
                        self._handoffs.append(_Handoff(
                            inner, routed, due=time.time()))
                if not live:
                    drops.append(inner)
        for inner in drops:
            self._drop_payload(inner)

    def _send_handoffs(self) -> None:
        """Deliver due handoffs to decode workers, with the three outcomes:
        lost (drop the payload, re-prefill), stalled past the timeout (keep
        it, retry with backoff, re-prefill past the last retry), ok."""
        now = time.time()
        with self._lock:
            due, keep = [], collections.deque()
            while self._handoffs:
                h = self._handoffs.popleft()
                (due if h.due <= now else keep).append(h)
            self._handoffs = keep
        for h in due:
            with self._lock:
                dead = h.routed.finished or h.routed.inner is not h.inner
            if dead:
                self._drop_payload(h.inner)
                continue
            target = self._decode_target()
            if target is None:       # nowhere to send: wait for a restart
                with self._lock:
                    self._handoffs.append(h)
                continue
            verdict = self._send(h, target)
            if verdict == "ok":
                with self._lock:
                    self.migrations += 1
                    h.inner.migrations += 1
                    h.routed.migrations += 1
                    h.routed.phase = "decode"
                    h.routed.where = target.name
                    paused = h.routed.paused
                if paused:
                    target.cb.pause(h.inner.rid)
                target.wake()
            elif verdict == "lost":
                with self._lock:
                    self.handoff_drops += 1
                self._drop_payload(h.inner)
                self._re_prefill(h.routed)
            else:                    # timeout: the payload is kept
                h.attempts += 1
                with self._lock:
                    self.handoff_retries += 1
                if h.attempts > self.handoff_max_retries:
                    self._drop_payload(h.inner)
                    self._re_prefill(h.routed)
                else:
                    h.due = time.time() + (self.handoff_backoff_s
                                           * 2 ** (h.attempts - 1))
                    with self._lock:
                        self._handoffs.append(h)

    def _send(self, h: _Handoff, target: Worker) -> str:
        if self.faults is not None and self.faults.fire("handoff_drop"):
            return "lost"
        t0 = time.time()
        if self.faults is not None:
            self.faults.maybe_sleep("handoff_stall")
        if time.time() - t0 > self.handoff_timeout_s:
            return "timeout"
        with self._lock:             # adopt BEFORE the engine can step
            self._maybe_adopt_draws(h.routed, target)
        target.cb.submit_request(h.inner)
        return "ok"

    def _maybe_adopt_draws(self, routed: RoutedRequest,
                           target: Worker) -> None:
        """One-shot handover: an IDLE receiving engine adopts the dead
        worker's draw source so the failed-over continuation is exact; a
        busy receiver keeps its own (adopting would change its tenants'
        draws)."""
        if routed.resume_draws is None:
            return
        cb = target.cb
        if not cb.active.any() and not cb.queue:
            _adopt_draws(cb, routed.resume_draws)
        routed.resume_draws = None

    def _check_workers(self) -> None:
        """Heartbeat sweep: harvest dead workers and fail their work over;
        restart them after ``restart_dead_after_s``."""
        now = time.time()
        for w in self.workers:
            if not w.started or self._stopping.is_set():
                continue
            r = w.runner
            dead = r.died or (not r._thread.is_alive())
            if dead and not w.failed_over:
                w.failed_over = True
                if self.restart_dead_after_s is not None:
                    w.restart_at = now + self.restart_dead_after_s
                self._failover(w)
            if (w.failed_over and w.restart_at is not None
                    and now >= w.restart_at
                    and not r._thread.is_alive()):
                w.restart()

    def _failover(self, worker: Worker) -> None:
        """Harvest a dead worker's batcher and re-route every survivor.
        Requests whose payload is intact (queued with an unrestored payload,
        or page handles on a shared pool) migrate again with no replay; the
        ones whose KV died with the worker re-prefill from prompt +
        delivered tokens."""
        worker.join_dead(2.0)
        # worker_die raises at the top of the step, before it drew: the
        # batcher's draw source is the exact resume state of this worker's
        # decode stream. A prefill worker in split mode never drew, so only
        # decode and unified streams travel.
        resume = (_draw_source(worker.cb)
                  if worker.role == "decode" or self.mode == "unified"
                  else None)
        # on a shared pool the KV outlives the worker: detach active slots
        # into page handles instead of discarding them
        harvested = worker.cb.extract_all(detach=(self.handoff == "pages"))
        if isinstance(worker.cb, PrefillBatcher):
            harvested.extend(worker.cb.drain_ready())
        replays = []
        for inner in harvested:
            with self._lock:
                routed = self.requests.get(inner.rid)
                drop = (routed is None or routed.finished
                        or routed.inner is not inner)
                if not drop:
                    self.failovers += 1
                    routed.failovers += 1
                    inner.failovers += 1
                    routed.preempt_count += inner.preempt_count
                    inner.preempt_count = 0
                    routed.resume_draws = resume
                    if inner.spilled is not None:
                        # payload intact: mid-prefill back to a prefill
                        # worker, decode-ready to the handoff queue
                        if (inner.spill_meta["length"]
                                >= len(inner.prompt)):
                            routed.phase = "handoff"
                            routed.where = None
                            self._handoffs.append(_Handoff(
                                inner, routed, due=time.time()))
                        else:
                            target = self._ingest_target()
                            if target is None:
                                self._pending_submit.append((inner, routed))
                            else:
                                self._place(inner, routed, target)
                    else:
                        replays.append(routed)
            if drop:
                self._drop_payload(inner)
        for routed in replays:
            self._re_prefill(routed)

    def _update_mode(self) -> None:
        """Degrade to unified when one role has no survivor; re-split when
        both have. A flip changes only where new work lands and the
        ``boundary_spill`` flag: requests in flight migrate themselves."""
        p_alive = bool(self._alive(self.prefill_workers))
        d_alive = bool(self._alive(self.decode_workers))
        with self._lock:
            if self.mode == "split" and p_alive != d_alive:
                self.mode = "unified"
                self.degradations += 1
                flip = False
            elif self.mode == "unified" and p_alive and d_alive:
                self.mode = "split"
                self.resplits += 1
                flip = True
            else:
                return
        for w in self.prefill_workers:
            w.cb.boundary_spill = flip
            w.wake()

    def _apply_cancels(self) -> None:
        with self._lock:
            pending = list(self._cancel_pending)
        for rid in pending:
            drop_inner, w = None, None
            with self._lock:
                routed = self.requests.get(rid)
                if routed is None or routed.finished:
                    self._cancel_pending.discard(rid)
                    continue
                if routed.phase == "handoff" or routed.where is None:
                    # in transit, or parked while no worker was alive:
                    # cancel it here
                    self._handoffs = collections.deque(
                        h for h in self._handoffs if h.inner.rid != rid)
                    self._pending_submit = collections.deque(
                        (i, r) for i, r in self._pending_submit
                        if r.rid != rid)
                    drop_inner = routed.inner
                    routed.cancelled = True
                    self._finish_routed(routed)
                    self._cancel_pending.discard(rid)
                else:
                    w = self._by_name.get(routed.where)
            if drop_inner is not None:
                self._drop_payload(drop_inner)
            elif w is not None:
                # retried each tick until the worker's finish lands (the
                # request may be mid-migration when the cancel arrives)
                w.cb.cancel(rid)
                w.wake()

    def _flush_pending(self) -> None:
        """Re-route submissions parked while no worker was alive."""
        with self._lock:
            if not self._pending_submit:
                return
            parked, self._pending_submit = (list(self._pending_submit),
                                            collections.deque())
            for inner, routed in parked:
                if routed.finished:
                    continue
                target = (self._ingest_target()
                          if inner.spilled is None
                          or inner.spill_meta["length"] < len(inner.prompt)
                          else self._decode_target())
                if target is None:
                    self._pending_submit.append((inner, routed))
                else:
                    self._place(inner, routed, target)

    # ---- health ---------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            inflight = sum(1 for r in self.requests.values()
                           if not r.finished)
            pending_handoffs = len(self._handoffs)
        return {
            "router": True,
            "mode": self.mode,
            "handoff": self.handoff,
            "inflight": inflight,
            "completed": self.completed,
            "pending_handoffs": pending_handoffs,
            "migrations": self.migrations,
            "failovers": self.failovers,
            "handoff_retries": self.handoff_retries,
            "handoff_drops": self.handoff_drops,
            "re_prefills": self.re_prefills,
            "degradations": self.degradations,
            "resplits": self.resplits,
            "shared_pool_free": (len(self.pool.free_pages)
                                 if self.pool is not None else None),
            "workers": [w.stats() for w in self.workers],
        }


class RouterRunner(EngineRunner):
    """The ``EngineRunner`` facade of a ``DisaggRouter`` for the HTTP
    frontend: no engine thread of its own (the router runs its workers and
    tick thread), the same ``TokenStream`` attach and orphan bookkeeping.
    ``EngineRunner.__init__`` points ``router.token_cb`` at ``_on_tokens``;
    this points ``router.finish_cb`` at ``_finish`` (both weakly)."""

    def __init__(self, router: DisaggRouter):
        super().__init__(router, name="router-facade")
        self._thread = None          # the router runs the threads
        router.finish_cb = _weak_method(self._finish)

    def start(self) -> None:
        self.cb.start()

    def wake(self) -> None:
        self.cb.wake()

    def stop(self, timeout: Optional[float] = None) -> None:
        self.cb.stop(timeout if timeout is not None else 60.0)
