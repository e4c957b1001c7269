"""Disaggregated serving workers (port of ``repro.launch.workers``): the
prefill-only batcher and the supervised worker the router manages.

One ``ContinuousBatcher`` interleaves prompt ingest with decode on one pool:
a long prompt takes one chunk dispatch from every decode segment, and the
whole engine is one point of failure. Disaggregation gives each role an
engine of its own:

  PrefillBatcher  a ``ContinuousBatcher`` that stops at the prefill/decode
                  BOUNDARY: the moment a slot's prompt is committed it
                  spills to a migration payload (``Request.spilled``, a
                  host snapshot, or ``Request.handoff_pages``, page handles
                  on a ``SharedPagePool``) and lands in ``ready`` for the
                  router to move to a decode worker. The slot never enters
                  a decode segment here, so a migration draws nothing: the
                  decode worker sees what an uninterrupted run would have.
  Worker          one supervised engine: a batcher, a ``WorkerRunner``
                  thread (``EngineRunner`` with router callbacks in place of
                  per-request ``TokenStream``s), a role, a heartbeat, and
                  ``restart`` to bring a dead worker back over its batcher.

``WorkerDied`` (the ``worker_die`` hook) is fatal to a worker: its engine
thread exits with neither recovery nor stream cleanup. The router's sweep
notices, harvests the batcher (``extract_all``) and fails the survivors
over (``repro_torch.launch.router``).

Degraded (unified) mode: with ``PrefillBatcher.boundary_spill`` off it is a
plain continuous batcher (prefill and decode on one engine), which is how
the router keeps serving when one role has no survivor. Turning it back on
mid-flight is safe: slots already decoding meet the boundary condition
(``lengths >= plens``) at their next step and migrate out.

On the card the router captures each worker's graphs before the worker
first starts (an engine thread captures what was not captured,
``EngineRunner.start``); ``restart`` runs a new thread over the same
batcher and its graphs, and captures nothing.
"""
from __future__ import annotations

import collections
import time
from typing import Callable, List, Optional

from repro_torch.launch.faults import WorkerDied
from repro_torch.launch.serve import ContinuousBatcher, Request
from repro_torch.launch.server import EngineRunner


class PrefillBatcher(ContinuousBatcher):
    """A ``ContinuousBatcher`` that spills requests at the prefill/decode
    boundary instead of decoding them.

    ``handoff="copy"``  the boundary spill is ``_spill_slot``: the used
                        pages' content and the dense rows go to the host and
                        the pages return to this worker's pool; the decode
                        worker restores into its own free pages (byte-copy
                        migration, across separate pools).
    ``handoff="pages"`` the boundary spill is ``_detach_slot``: the physical
                        pages and their refs travel with the request. Every
                        sharing batcher sits on one ``SharedPagePool``.

    Spilled requests wait in ``ready`` (a thread-safe deque) for the
    router's ``drain_ready``. The paused mask keeps them out of the decode
    segment before the spill, so no decode step runs here for them.
    """

    def __init__(self, dbm, params, *, handoff: str = "copy", **kw):
        super().__init__(dbm, params, **kw)
        if not self.chunked:
            raise ValueError(
                "PrefillBatcher requires prefill='chunked': per-token mode "
                "commits prompt tokens inside decode segments, so there is "
                "no clean prefill/decode boundary to spill at")
        if handoff not in ("copy", "pages"):
            raise ValueError(f"handoff must be 'copy' or 'pages', "
                             f"got {handoff!r}")
        if handoff == "pages" and self._shared is None:
            raise ValueError("handoff='pages' moves page handles, which "
                             "only mean something on a SharedPagePool: "
                             "construct every worker with shared_pool=...")
        self.handoff = handoff
        self.boundary_spill = True     # False: degraded unified mode
        self.ready: collections.deque = collections.deque()
        self.migrated_out = 0          # boundary spills made

    def _paused_mask(self):
        m = super()._paused_mask()
        if self.boundary_spill:
            # prefill-complete slots never decode here: they spill out
            m = m | (self.active & (self.lengths >= self.plens))
        return m

    def drain_ready(self) -> List[Request]:
        """Pop every boundary-spilled request (the router's thread)."""
        out = []
        while True:
            try:
                out.append(self.ready.popleft())
            except IndexError:
                return out

    def _step(self, *, strict: bool = True) -> List[Request]:
        finished = super()._step(strict=strict)
        if self.boundary_spill:
            for s in range(self.num_slots):
                if (self.slot_req[s] is not None and self.active[s]
                        and self.lengths[s] >= self.plens[s]):
                    req = (self._detach_slot(s) if self.handoff == "pages"
                           else self._spill_slot(s))
                    with self._lock:   # the request leaves this batcher
                        self._paused.discard(req.rid)
                    self.migrated_out += 1
                    self.ready.append(req)
        return finished


class WorkerRunner(EngineRunner):
    """``EngineRunner`` for a router's worker: two router callbacks
    (``on_tokens``, ``on_finish``) take the place of the per-request
    ``TokenStream``s, and ``WorkerDied`` is fatal: the thread exits with no
    recovery or stream cleanup, and the router's sweep owns what follows."""

    def __init__(self, batcher, *, max_restarts: int = 3,
                 name: str = "worker",
                 on_tokens: Optional[Callable] = None,
                 on_finish: Optional[Callable] = None):
        self._cb_tokens = on_tokens
        self._cb_finish = on_finish
        super().__init__(batcher, max_restarts=max_restarts,
                         fatal_types=(WorkerDied,), name=name)

    def _on_tokens(self, req: Request, toks: List[int]) -> None:
        if self._cb_tokens is not None:
            self._cb_tokens(req, toks)

    def _finish(self, req: Request) -> None:
        self.served += 1
        if self._cb_finish is not None:
            self._cb_finish(req)


class Worker:
    """One supervised serving worker: a batcher, its engine thread, a role
    and the liveness the router reads.

    ``alive`` is the router's routing predicate: the engine thread runs,
    has met no fatal fault (``died``) and has not used up its crash budget
    (``gave_up``). ``restart`` starts a fresh supervised thread over the
    same batcher (and its graphs), valid only once the old thread exited
    and the router harvested the batcher: the failover sequence."""

    def __init__(self, name: str, role: str, batcher: ContinuousBatcher, *,
                 max_restarts: int = 3,
                 on_tokens: Optional[Callable] = None,
                 on_finish: Optional[Callable] = None):
        if role not in ("prefill", "decode"):
            raise ValueError(f"role must be 'prefill' or 'decode', "
                             f"got {role!r}")
        self.name, self.role, self.cb = name, role, batcher
        self._max_restarts = max_restarts
        self._on_tokens, self._on_finish = on_tokens, on_finish
        self.served_total = 0        # completed before the current runner
        self.restarts = 0            # restarts after a death
        self.started = False
        self.restart_at: Optional[float] = None   # the router's timer
        self.failed_over = False     # this death already harvested
        self.runner = self._make_runner()

    def _make_runner(self) -> WorkerRunner:
        return WorkerRunner(self.cb, max_restarts=self._max_restarts,
                            name=f"{self.role}:{self.name}",
                            on_tokens=self._on_tokens,
                            on_finish=self._on_finish)

    # ---- liveness ------------------------------------------------------
    @property
    def alive(self) -> bool:
        r = self.runner
        return (self.started and r._thread.is_alive()
                and not r.died and not r.gave_up)

    @property
    def heartbeat_age(self) -> float:
        return time.time() - self.runner.last_beat

    # ---- lifecycle -----------------------------------------------------
    def start(self) -> None:
        """Start the engine thread; returns once it is ready to step (on
        the card: its batcher's graphs captured, unless they were)."""
        self.runner.start()
        self.started = True

    def wake(self) -> None:
        self.runner.wake()

    def stop(self, timeout: Optional[float] = None) -> None:
        self.runner.stop(timeout)

    def join_dead(self, timeout: float = 1.0) -> None:
        """Wait for a dying engine thread to exit before its batcher is
        harvested (it may still be unwinding out of ``step``)."""
        if self.runner._thread.is_alive():
            self.runner._thread.join(timeout)

    def restart(self) -> None:
        """A fresh supervised engine thread over the same batcher, whose
        draws go on from where they were. The old thread must be dead and
        the batcher harvested (``extract_all``): the new loop starts from
        an empty queue."""
        if self.runner._thread.is_alive():
            raise RuntimeError("restart() on a live worker: stop or kill it "
                               "first")
        self.served_total += self.runner.served
        self.restarts += 1
        self.restart_at = None
        self.failed_over = False
        self.runner = self._make_runner()
        self.runner.start()
        self.started = True

    # ---- health --------------------------------------------------------
    def stats(self) -> dict:
        r = self.runner
        return {
            "name": self.name, "role": self.role, "alive": self.alive,
            "heartbeat_age_s": round(self.heartbeat_age, 3),
            "free_pages": len(self.cb.free_pages),
            "total_pages": self.cb.total_pages,
            **self.cb.kv_stats(),
            "inflight": int(self.cb.active.sum()),
            "queued": len(self.cb.queue),
            "served": self.served_total + r.served,
            "crashes": r.crashes,
            "engine_restarts": r.restarts,
            "worker_restarts": self.restarts,
            "migrated_out": getattr(self.cb, "migrated_out", 0),
        }
