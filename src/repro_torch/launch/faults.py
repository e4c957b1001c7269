"""Deterministic fault injection — ONE injector shared by serving AND
training (a copy of ``repro.launch.faults``, numpy only: the same spec
validation, triggers and seeded schedules, so a spec and seed fire on the
same calls in both packages).

Chaos hooks let tests and the harnesses force the stack down its rare paths
— allocator exhaustion, engine-thread crashes, token-stream stalls, pod
deaths, NaN gradients, torn checkpoint writes — on a SEEDED schedule, so
every failure a test provokes is reproducible bit-for-bit. Hosts never
import randomness for this themselves: a ``FaultInjector`` is handed in
(``ContinuousBatcher(faults=...)``, ``EngineRunner``, ``TrainRunner``,
``CheckpointManager(faults=...)``) and consulted at named hook points; with
no injector (the default) every hook is a no-op costing one attribute check.

The injector is HOST-AGNOSTIC: hooks are plain names, nothing here knows
about batcher or trainer call sites. Any host consults any hook with the
same four consumption patterns — ``fire`` (boolean), ``maybe_raise``
(raise a configurable exception), ``maybe_sleep`` (latency), and
``maybe_corrupt`` (truncate a file, for torn-write simulation) — so serve
and train share one injector and one schedule namespace.

Hook names used by the serving stack:

  ``alloc_exhaust``   ``ContinuousBatcher._alloc_page`` pretends the pool is
                      empty (returns no page) — exercises preemption and the
                      CoW-failure paths without actually shrinking the pool.
  ``engine_crash``    raises ``InjectedFault`` at the top of
                      ``ContinuousBatcher.step`` — exercises the
                      ``EngineRunner`` supervisor restart + in-flight
                      requeue.
  ``token_stall``     sleeps inside token delivery — exercises client
                      timeout / slow-stream handling in the load harness.
  ``worker_die``      raises ``WorkerDied`` at the top of
                      ``ContinuousBatcher.step`` — unlike ``engine_crash``
                      the supervisor treats it as FATAL (simulated process
                      death, no restart); the disaggregation router must
                      detect the dead worker by heartbeat and fail its
                      in-flight requests over (the router; not ported).
  ``handoff_drop``    the router loses a prefill→decode migration payload
                      in transit — exercises the re-prefill fallback.
  ``handoff_stall``   sleeps inside the router's handoff send (pair with
                      ``{"sleep": s}`` above the router's handoff timeout)
                      — exercises the bounded retry/backoff path.

Hook names used by the training stack (``repro_torch.launch.trainrunner``):

  ``pod_die``         block-parallel: the supervisor marks the victim
                      block's pod dead (device state lost → rewind to the
                      last generation), degrades it to the round-robin
                      orphan path, and re-adopts it onto the mesh when the
                      pod revives. db mode has no pods: ``pod_die`` raises
                      ``PodDied`` = simulated PROCESS death → bounded
                      restart from the latest good generation.
  ``grad_nan``        poisons ONE block's loss with NaN for one batch (via
                      the engine's per-block ``loss_mult``) — exercises the
                      per-block anomaly guard: only that block's update is
                      skipped. Optional ``{"block": b}`` pins the victim
                      (default: rotate by fire count).
  ``data_stall``      sleeps inside the training data fetch — exercises the
                      supervisor's heartbeat/stall accounting.
  ``ckpt_corrupt``    ``CheckpointManager`` truncates one freshly written
                      file after publishing a generation — exercises the
                      checksum fallback to the previous manifest generation.

Each hook is configured with ONE trigger spec:

  {"p": 0.05}            fire independently with probability p per call
  {"every": 40}          fire on every 40th call (1-indexed)
  {"at": [3, 7]}         fire on exactly these call indices (1-indexed)

plus optional ``{"start": a, "stop": b}`` bounds on the call index window
(half-open: fires only while ``start <= index < stop``) and, for
``token_stall``, ``{"sleep": seconds}``. Per-hook call counters and a
per-hook ``RandomState`` stream make schedules independent: adding a spec
for one hook never shifts another hook's schedule.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np


class InjectedFault(RuntimeError):
    """Raised by a chaos hook; distinguishable from organic failures so the
    supervisor and the tests can tell injected crashes from real bugs."""


class WorkerDied(InjectedFault):
    """A ``worker_die`` hook fired: the worker process is (simulated) dead.
    Supervisors must NOT restart on this — recovery is the router's job
    (heartbeat detection → failover), which is exactly what the fault
    exists to exercise."""


class PodDied(InjectedFault):
    """A ``pod_die`` hook fired: one training pod (block group) is
    (simulated) dead. The training supervisor must NOT treat this as an
    engine crash — the other blocks keep training; the orphaned block
    degrades to the round-robin path until the pod revives."""


class FaultInjector:
    """Seeded chaos-hook scheduler. ``fire(hook)`` advances that hook's call
    counter and reports whether the fault triggers this call; ``maybe_raise``
    and ``maybe_sleep`` are the common consumption patterns."""

    def __init__(self, specs: Dict[str, dict], seed: int = 0):
        for name, spec in specs.items():
            keys = {"p", "every", "at"} & set(spec)
            if len(keys) != 1:
                raise ValueError(
                    f"hook {name!r} needs exactly one of p/every/at, got "
                    f"{sorted(spec)}")
        self.specs = {k: dict(v) for k, v in specs.items()}
        self.seed = seed
        self.calls: Dict[str, int] = {k: 0 for k in specs}
        self.fired: Dict[str, int] = {k: 0 for k in specs}
        self._rs = {k: np.random.RandomState((seed * 9176 + i) % (2**31 - 1))
                    for i, k in enumerate(sorted(specs))}

    def fire(self, hook: str) -> bool:
        """Advance ``hook``'s schedule by one call; True when the fault
        triggers now. Unknown hooks never fire (and aren't counted)."""
        spec = self.specs.get(hook)
        if spec is None:
            return False
        self.calls[hook] = idx = self.calls[hook] + 1
        if not (spec.get("start", 0) <= idx < spec.get("stop", float("inf"))):
            return False
        if "p" in spec:
            hit = bool(self._rs[hook].rand() < spec["p"])
        elif "every" in spec:
            hit = idx % spec["every"] == 0
        else:
            hit = idx in spec["at"]
        if hit:
            self.fired[hook] += 1
        return hit

    def maybe_raise(self, hook: str, exc: type = InjectedFault) -> None:
        """Raise ``exc`` when the hook fires (``exc`` lets hosts signal
        distinguishable failure classes — e.g. ``PodDied`` — without the
        injector knowing their call sites)."""
        if self.fire(hook):
            raise exc(
                f"injected fault {hook!r} (call {self.calls[hook]})")

    def maybe_sleep(self, hook: str, default: float = 0.05) -> None:
        if self.fire(hook):
            time.sleep(float(self.specs[hook].get("sleep", default)))

    def maybe_corrupt(self, hook: str, path: str) -> bool:
        """Truncate ``path`` to half its size when the hook fires (torn-write
        simulation); True when corruption happened. The file must exist."""
        if not self.fire(hook):
            return False
        import os
        with open(path, "r+b") as f:
            f.truncate(max(0, os.path.getsize(path) // 2))
        return True

    def stats(self) -> Dict[str, dict]:
        return {k: {"calls": self.calls[k], "fired": self.fired[k]}
                for k in self.specs}


def make_injector(specs: Optional[Dict[str, dict]], seed: int = 0):
    """None-tolerant constructor: ``make_injector(None)`` returns None so the
    engine's hot path stays a plain ``if self.faults`` check."""
    return FaultInjector(specs, seed) if specs else None
