"""PyTorch port: continuous batching against the JAX package on the CPU.

``repro_torch.launch.serve.ContinuousBatcher`` (its decode segments run
eagerly on CPU tensors, every kernel wrapper through its plain version)
against ``repro.launch.serve.ContinuousBatcher`` on bridged params. The JAX
batcher draws each segment's z (and, when sampling, its Gumbel noise)
inside its ``serve_scan``; the tests replay that split chain per segment
into the port's ``draw_segment``.

Under fp32 the greedy tokens are identical, and so are the per-step
scheduling logs (slots, preemptions, restores, retirements, free list and
refcounts, deadline cancels and sheds): uniform and ragged queues, chunked
and per-token prefill, the prefix cache with a copy-on-write tail page, an
int8 pool, a tight pool that preempts, SLO deadlines and admission
shedding, and ``recover`` / ``abort_all`` / ``extract_all`` mid-run. Both
serve modules read one fake clock (``clock``), so deadline decisions and
service times agree exactly. The host scheduler alone runs seeded traces
through both batchers with their dispatches replaced by fakes, with SLOs
and shed limits. ``SpilledSlot`` bytes cross between the packages both
ways. The rest ports the JAX tests of page reclaim, slot reuse,
cancellation and prefix sharing at tiny sizes.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_serve import TINY, models

from repro import configs as JC
from repro.launch import serve as JS
from repro.nn import cache as JKVC
from repro_torch.launch import serve as TS
from repro_torch.nn import cache as TKVC

torch.set_num_threads(1)

REDUCED = JC.reduced(JC.get_config("stablelm-1.6b"))
PSZ, CHUNK, SEG = 4, 8, 4
CB_KW = dict(page_size=PSZ, max_prompt=24, max_len=32, seg_len=SEG,
             chunk_size=CHUNK)


@pytest.fixture(scope="module")
def tiny():
    return models(TINY)


class JaxDraws:
    """The draws of JAX's ``serve_scan``, segment by segment: per step
    ``rng, rs = split(rng); rn, rsamp = split(rs)``; z = σ_max · N(rn),
    and the categorical's Gumbel noise from rsamp."""

    def __init__(self, seed, num_slots, cfg, sigma_max, sampled=False):
        self.rng = jax.random.PRNGKey(seed)
        self.shape = (num_slots, 1, cfg.d_model)
        self.gshape = (num_slots, cfg.vocab_size) if sampled else None
        self.sigma_max = sigma_max

    def __call__(self, n):
        zs, gs = [], []
        for _ in range(n):
            self.rng, rs = jax.random.split(self.rng)
            rn, rsamp = jax.random.split(rs)
            zs.append(np.asarray(self.sigma_max
                                 * jax.random.normal(rn, self.shape)))
            if self.gshape is not None:
                gs.append(np.asarray(jax.random.gumbel(rsamp, self.gshape,
                                                       jnp.float32)))
        return (torch.from_numpy(np.stack(zs)),
                torch.from_numpy(np.stack(gs)) if gs else None)


class Clock:
    """The ``time`` both serve modules read: ``time()`` returns ``t``,
    which the tests advance by hand."""

    def __init__(self):
        self.t = 0.0
        self.perf_counter, self.sleep = time.perf_counter, time.sleep

    def time(self):
        return self.t


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    for mod in (JS, TS):
        monkeypatch.setattr(mod, "time", c)
    return c


def state(cb, fin):
    """What one step of a batcher decided: slot occupants, counters, the
    free list and the refcounts, and the requests it finished."""
    return (tuple(None if r is None else r.rid for r in cb.slot_req),
            cb.preemptions, cb.restores, cb.cow_copies,
            cb.ingest_dispatches, cb.decode_dispatches, cb.steps,
            cb.deadline_cancels, cb.shed_count,
            tuple(cb.free_pages), tuple(sorted(cb.page_refs.items())),
            tuple((r.rid, r.cancelled, r.error, r.deadline_blown)
                  for r in fin))


def submit(cb, jax_side, p, n, prio, slo=None):
    """``cb.submit``; a shed returns ("shed", retry_after)."""
    try:
        return cb.submit(np.asarray(p, np.int32) if jax_side else p, n,
                         priority=prio, **(slo or {}))
    except (JS.AdmissionError, TS.AdmissionError) as e:
        return ("shed", str(e), e.retry_after)


def run_both(pair, reqs, *, seed=3, num_slots=3, preempt_at=None,
             late=None, sampled=False, faults=None, clock=None, tick=0.0,
             ops=None, **kw):
    """Serve ``reqs`` [(prompt, max_new, priority[, slo kwargs])] through
    both batchers step by step (``late``: {step: reqs} submitted before
    that step; ``preempt_at``: {step: slot} forced preemptions of the
    slot's request; ``ops``: {step: fn(batcher)} called before that step,
    its result logged; ``faults``: a fault spec, one injector per batcher
    from seed 1; ``clock``: the fake clock, started at 0 for each package
    and advanced by ``tick`` after each step); assert equal per-step logs
    and tokens. Returns the port's batcher and its finished requests."""
    from repro.launch.faults import FaultInjector as JFaults
    from repro_torch.launch.faults import FaultInjector as TFaults
    jdbm, jparams, tdbm, tparams = pair
    kw = {**CB_KW, "precision": "fp32", **kw}
    jcb = JS.ContinuousBatcher(
        jdbm, jparams, num_slots=num_slots,
        faults=faults and JFaults(faults, seed=1), **kw)
    tcb = TS.ContinuousBatcher(
        tdbm, tparams, num_slots=num_slots,
        faults=faults and TFaults(faults, seed=1), **kw)
    tcb.draw_segment = JaxDraws(seed, num_slots, tdbm.cfg,
                                tdbm.db.sigma_max, sampled)
    late = {0: reqs, **(late or {})}
    rng, logs, done = jax.random.PRNGKey(seed), ([], []), ([], [])
    for i, cb in enumerate((jcb, tcb)):
        step = 0
        if clock is not None:
            clock.t = 0.0
        while cb.has_work() or step <= max(late):
            for r in late.get(step, ()):
                logs[i].append(submit(cb, i == 0, *r))
            victim = cb.slot_req[(preempt_at or {}).get(step, 0)]
            if step in (preempt_at or {}) and victim is not None:
                cb.preempt(victim.rid)
            if step in (ops or {}):
                logs[i].append(ops[step](cb))
            if i == 0:
                rng, fin = cb.step(rng)
            else:
                fin = cb.step()
            logs[i].append(state(cb, fin))
            done[i].extend(fin)
            step += 1
            if clock is not None:
                clock.t += tick
            assert step < 400, "scheduler failed to converge"
    assert logs[0] == logs[1]
    jout = {r.rid: r.out for r in done[0]}
    tout = {r.rid: r.out for r in done[1]}
    assert tout == jout
    assert all(len(r.out) == r.max_new for r in done[1] if r.error is None
               and not r.cancelled)
    assert len(tcb.free_pages) + len(tcb.page_refs) == tcb.total_pages - 1
    if jcb.prefix is not None:
        assert (tcb.prefix.hits, tcb.prefix.tokens_shared) == (
            jcb.prefix.hits, jcb.prefix.tokens_shared)
    if faults:
        assert tcb.faults.stats() == jcb.faults.stats()
    return tcb, sorted(done[1], key=lambda r: r.rid)


def queue(cfg, n, *, lo=3, hi=24, max_new=5, seed=0, prefix=None):
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        p = rs.randint(0, cfg.vocab_size, size=rs.randint(lo, hi + 1))
        if prefix is not None and i % 2 == 0:
            p = np.concatenate([prefix, p])[:CB_KW["max_prompt"]]
        out.append((p.astype(np.int64), max_new, "standard"))
    return out


# ---------------------------------------------------------------------------
# Tokens and scheduling logs against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["uniform", "ragged", "per-token"])
def test_tokens_match_jax(tiny, case):
    lo = 12 if case == "uniform" else 3
    reqs = queue(TINY, 6, lo=lo, hi=12 if case == "uniform" else 20)
    prefill = "per-token" if case == "per-token" else "chunked"
    run_both(tiny, reqs, prefill=prefill)


def test_tokens_match_jax_prefix_cache_cow(tiny):
    """A shared 14-token prefix (3.5 pages): later requests map its pages
    and copy the partial tail page before their first write."""
    rs = np.random.RandomState(5)
    sys_p = rs.randint(0, TINY.vocab_size, size=14)
    reqs = queue(TINY, 6, lo=2, hi=8, prefix=sys_p, seed=4)
    reqs.append((np.concatenate([sys_p, reqs[0][0][14:]]), 5, "standard"))
    cb, _ = run_both(tiny, reqs, prefix_cache=True)
    assert cb.prefix.hits >= 2 and cb.cow_copies >= 1


def test_tokens_match_jax_int8_pool(tiny):
    rs = np.random.RandomState(6)
    sys_p = rs.randint(0, TINY.vocab_size, size=10)
    reqs = queue(TINY, 5, prefix=sys_p, hi=12, seed=6)
    cb, _ = run_both(tiny, reqs, precision="fp32_kvint8", prefix_cache=True)
    assert cb.kv.quantized and cb.prefix.hits >= 1


def test_tokens_match_jax_preemption(tiny):
    """A pool too small for the running batch requests and a late
    interactive one: the arrival spills a batch slot (priority preemption),
    a forced preemption spills another mid-decode, and both restore, at the
    same steps in both packages and with the same tokens."""
    rs = np.random.RandomState(7)

    def reqs(*spec):
        return [(rs.randint(0, TINY.vocab_size, size=n).astype(np.int64), m,
                 p) for n, m, p in spec]
    cb, done = run_both(
        tiny, reqs((12, 20, "batch"), (8, 16, "batch")),
        late={2: reqs((8, 8, "interactive"))}, num_slots=3,
        total_pages=16, preempt_at={4: 0})
    assert cb.preemptions >= 2 and cb.restores == cb.preemptions
    assert sum(r.preempt_count for r in done) == cb.preemptions


def test_tokens_match_jax_alloc_exhaust(tiny):
    """Under an ``alloc_exhaust`` schedule (p 0.3) the same allocations are
    refused in both packages, so admission unwinds, copy-on-write relief and
    self-preemption happen at the same steps: equal scheduling logs and
    tokens, and equal injector counts."""
    sys_p = np.random.RandomState(11).randint(0, TINY.vocab_size, size=8)
    cb, _ = run_both(tiny, queue(TINY, 6, hi=12, seed=10, prefix=sys_p),
                     num_slots=2, prefix_cache=True, total_pages=24,
                     faults={"alloc_exhaust": {"p": 0.3}})
    assert cb.faults.fired["alloc_exhaust"] > 0


def test_tokens_match_jax_sampled(tiny):
    """temperature 0.8 with top-k 8: JAX's categorical noise fed in."""
    run_both(tiny, queue(TINY, 4, seed=8), temperature=0.8, top_k=8,
             sampled=True)


def test_tokens_match_jax_reduced_stablelm():
    run_both(models(REDUCED), queue(REDUCED, 4, seed=9), num_slots=2)


# ---------------------------------------------------------------------------
# SLO deadlines, admission shedding and recovery against JAX (the
# behaviours of tests/test_preempt.py)
# ---------------------------------------------------------------------------

def _reqs(seed, *spec):
    """[(prompt, max_new, priority, slo)] from (prompt length, max_new,
    priority, slo) specs."""
    rs = np.random.RandomState(seed)
    return [(rs.randint(0, TINY.vocab_size, size=n).astype(np.int64), m, p,
             slo) for n, m, p, slo in spec]


def _pool_whole(cb):
    return (len(cb.free_pages) == cb.total_pages - 1 and not cb.page_refs
            and not cb.active.any())


def test_ttft_deadline_drops_queued_request(tiny, clock):
    """A queued request whose TTFT deadline passes while it waits is
    dropped before admission: a deadline error, no output, no pages."""
    a, b = _reqs(2, (8, 10, "standard", None),
                 (8, 4, "standard", {"ttft_slo_s": 0.001}))
    cb, done = run_both(tiny, [a], late={1: [b]}, num_slots=1, clock=clock,
                        tick=0.01)
    fin = {r.rid: r for r in done}
    assert fin[0].error is None and len(fin[0].out) == 10
    assert fin[1].deadline_blown and "ttft" in fin[1].error
    assert fin[1].out == [] and fin[1].pages == []
    assert cb.deadline_cancels == 1 and _pool_whole(cb)


def test_tpot_deadline_retires_active_with_partial_output(tiny, clock):
    """An active request behind its TPOT pace is retired with the tokens it
    already has; its slot and pages are recycled."""
    reqs = _reqs(3, (8, 12, "standard", {"tpot_slo_s": 1e-9}))
    cb, done = run_both(tiny, reqs, num_slots=1, clock=clock, tick=0.01)
    (req,) = done
    assert req.deadline_blown and "tpot" in req.error
    assert 2 <= len(req.out) < 12
    assert cb.deadline_cancels == 1 and _pool_whole(cb)


def test_queue_depth_shed_is_class_aware(tiny, clock):
    """``max_queue`` sheds by the backlog at or above the submit's priority:
    a standard submit is refused behind one queued standard request, an
    interactive one is admitted first; the shed carries a positive
    ``retry_after``."""
    reqs = _reqs(4, (6, 3, "standard", None), (6, 3, "standard", None),
                 (6, 3, "interactive", None))
    cb, done = run_both(tiny, reqs, num_slots=1, max_queue=1, clock=clock,
                        tick=0.01)
    assert cb.shed_count == 1 and cb.retry_after_hint() > 0
    first, second = sorted(done, key=lambda r: r.first_token_t)
    assert (first.rid, first.priority, second.priority) == (1, 2, 1)
    assert all(r.error is None for r in done) and _pool_whole(cb)


def test_pool_pressure_sheds_batch_only(tiny, clock):
    """``shed_below_pages`` refuses batch work while the free pool is thin;
    standard and interactive work is admitted. An unknown class raises in
    both packages."""
    reqs = _reqs(5, (4, 2, "batch", None), (4, 2, "standard", None),
                 (4, 2, "interactive", None))
    cb, done = run_both(tiny, reqs, num_slots=1, shed_below_pages=10_000,
                        clock=clock)
    assert cb.shed_count == 1 and len(done) == 2
    for side in (JS, TS):
        with pytest.raises(ValueError):
            side.ContinuousBatcher(*tiny[2 * (side is TS):][:2], num_slots=1,
                                   **CB_KW).submit(np.arange(4), 2,
                                                   priority="vip")


def test_slo_mixed_traffic_matches_jax(tiny, clock):
    """Mixed classes with TTFT and TPOT SLOs, arrivals over time and a
    queue-depth limit on a tight pool: the same sheds, deadline cancels,
    preemptions and tokens at the same steps."""
    rs = np.random.RandomState(14)
    late = {}
    for i in range(10):
        prio = ["batch", "standard", "interactive"][i % 3]
        slo = {"ttft_slo_s": 0.03} if prio == "interactive" else {}
        if i % 4 == 1:
            slo["tpot_slo_s"] = 0.003
        late.setdefault(i // 2, []).append(
            (rs.randint(0, TINY.vocab_size, size=rs.randint(3, 16)),
             int(rs.randint(3, 12)), prio, slo))
    cb, done = run_both(tiny, late.pop(0), late=late, num_slots=2,
                        max_queue=2, total_pages=14, prefix_cache=True,
                        clock=clock, tick=0.01)
    assert cb.shed_count >= 1 and cb.deadline_cancels >= 1
    assert any(r.error is None for r in done)


@pytest.mark.parametrize("op", ["recover", "abort_all", "extract_all"])
def test_recovery_matches_jax(tiny, op):
    """Mid-run, with slots active and requests queued: ``recover`` spills
    every active slot back to the queue and the run finishes with the same
    tokens; ``abort_all`` errors out everything and ``extract_all`` pops it
    unharmed. Equal results and logs in both packages; the pool ends
    whole."""
    def call(cb):
        if op == "recover":
            cb.recover()
            return ("recovered", cb.preemptions)
        reqs = cb.abort_all("stop") if op == "abort_all" else (
            cb.extract_all())
        return tuple(sorted((r.rid, tuple(r.out), r.error,
                             r.spilled is not None, r.pages == [])
                            for r in reqs))

    cb, done = run_both(tiny, queue(TINY, 6, seed=12, max_new=8),
                        num_slots=2, ops={3: call})
    assert _pool_whole(cb)
    if op == "recover":
        assert cb.preemptions >= 1 and cb.restores == cb.preemptions
        assert len(done) == 6
    else:
        assert len(done) < 6 and not cb.queue


# ---------------------------------------------------------------------------
# The host scheduler alone: seeded traces through both batchers
# ---------------------------------------------------------------------------

T_PSZ, T_CHUNK, T_PROMPT, T_NEW = 4, 4, 16, 6


def _fake_dispatch(cb, jax_side):
    """Numpy semantics of the two dispatches, asserting on the host that
    every write lands in a page the writing slot owns alone."""
    def writable(slot, pos):
        phys = int(cb.table[slot, pos // T_PSZ])
        assert phys != 0 and cb.page_refs.get(phys, 0) == 1
        assert cb.slot_req[slot].pages[pos // T_PSZ] == phys

    def chunk(params, kv, table, lengths, prompt_buf, plens, *cond):
        lengths, plens = np.array(lengths), np.array(plens)
        adv = np.clip(plens - lengths, 0, T_CHUNK)
        for s in range(lengths.shape[0]):
            for p in range(int(lengths[s]), int(lengths[s] + adv[s])):
                writable(s, p)
        return kv, lengths + adv

    def segment(lengths, plens, stop_at, active, n):
        lengths = np.array(lengths)
        plens, stop_at = np.array(plens), np.array(stop_at)
        active = np.array(active)
        emitted = np.full((lengths.shape[0], n), -1, np.int64)
        for t in range(n):
            act = active & (lengths < stop_at)
            for s in np.nonzero(act)[0]:
                writable(int(s), int(lengths[s]))
                if lengths[s] >= plens[s]:
                    emitted[s, t] = 1
            lengths = lengths + act.astype(lengths.dtype)
        return lengths, emitted

    if jax_side:
        def serve(params, kv, table, lengths, prompt_buf, plens, stop_at,
                  active, rng, cond_lengths, n):
            lengths, emitted = segment(lengths, plens, stop_at, active, n)
            return kv, lengths, rng, emitted
    else:
        def serve(params, kv, table, lengths, prompt_buf, plens, stop_at,
                  active, z, noise=None):
            return (kv, *segment(lengths, plens, stop_at, active,
                                 z.shape[0]))
    shell = object.__new__(type(cb.eng))
    shell.__dict__.update(dispatches=0, prefill_steps=0, temperature=0.0,
                          pol=None, dbm=cb.eng.dbm, _prefill_chunk1=chunk,
                          _serve=serve)
    cb.eng = shell


def check_invariants(cb):
    """Pages are conserved and refcounts decompose into slot maps plus the
    prefix trie's holds; queued requests hold no pages."""
    free, refs = list(cb.free_pages), dict(cb.page_refs)
    assert 0 not in free and 0 not in refs and len(set(free)) == len(free)
    assert set(free) | set(refs) == set(range(1, cb.total_pages))
    assert not set(free) & set(refs)
    held = {}
    if cb.prefix is not None:
        def walk(node):
            for child in node.children.values():
                held[child.page] = held.get(child.page, 0) + 1
                walk(child)
            for page, _ in node.tails:
                held[page] = held.get(page, 0) + 1
        for root in cb.prefix.roots.values():
            assert root.children or root.tails
            walk(root)
    for req in cb.slot_req:
        for p in req.pages if req is not None else ():
            held[p] = held.get(p, 0) + 1
    assert refs == held
    assert all(not r.pages for r in cb.queue)
    assert cb.restores <= cb.preemptions


def run_trace(pair, seed, clock):
    """A seeded trace through both batchers in lockstep: submission waves
    (some with TTFT / TPOT SLOs, under random shed limits; the clock
    advances 10 ms a step) and random cancels, preemptions, pauses and
    resumes; equal logs after every step."""
    jdbm, jparams, tdbm, tparams = pair
    rs = np.random.RandomState(seed)
    num_slots = int(rs.randint(1, 4))
    pps = TKVC.pages_for(T_PROMPT + T_NEW, T_PSZ)
    total = 1 + int(rs.randint(pps + 2, num_slots * pps + 4))
    kw = dict(num_slots=num_slots, page_size=T_PSZ, max_prompt=T_PROMPT,
              max_len=T_PROMPT + T_NEW, seg_len=3, chunk_size=T_CHUNK,
              precision="fp32", prefix_cache=bool(rs.rand() < 0.8),
              total_pages=total,
              max_queue=None if rs.rand() < 0.5 else int(rs.randint(1, 5)),
              shed_below_pages=(0 if rs.rand() < 0.6
                                else int(rs.randint(1, total))))
    clock.t = 0.0
    cbs = (JS.ContinuousBatcher(jdbm, jparams, **kw),
           TS.ContinuousBatcher(tdbm, tparams, **kw))
    for side, cb in enumerate(cbs):
        _fake_dispatch(cb, jax_side=side == 0)
    prefixes = [rs.randint(0, 32, size=int(rs.randint(4, 13)))
                for _ in range(3)]
    rng, rids, logs = jax.random.PRNGKey(seed), [], ([], [])
    for _ in range(int(rs.randint(1, 4))):               # submission waves
        for _ in range(int(rs.randint(1, 5))):
            p = np.concatenate([prefixes[rs.randint(3)],
                                rs.randint(0, 32, size=rs.randint(0, 5))])
            p, n = p[:T_PROMPT], int(rs.randint(1, T_NEW + 1))
            prio = ["batch", "standard", "interactive"][rs.randint(3)]
            slo = {}
            if rs.rand() < 0.3:
                slo["ttft_slo_s"] = float(rs.choice([0.02, 0.05, 0.2]))
            if rs.rand() < 0.3:
                slo["tpot_slo_s"] = float(rs.choice([0.002, 0.005, 0.02]))
            got = [submit(cb, side == 0, p, n, prio, slo)
                   for side, cb in enumerate(cbs)]
            assert got[0] == got[1], (seed, got)
            if not isinstance(got[0], tuple):
                rids.append(got[0])
        while cbs[0].has_work() or cbs[1].has_work():
            acts = [(op, rids[rs.randint(len(rids))])
                    for op, pr in (("cancel", 0.2), ("preempt", 0.2),
                                   ("pause", 0.1), ("resume", 0.3))
                    if rs.rand() < pr and rids]
            for side, cb in enumerate(cbs):
                for op, rid in acts:
                    getattr(cb, op)(rid)
                try:
                    if side == 0:
                        rng, fin = cb.step(rng)
                    else:
                        fin = cb.step()
                except RuntimeError as e:        # pool too small to admit
                    assert "page pool" in str(e)
                    cb.queue.clear()
                    fin = [("pool error",)]
                logs[side].append(fin if fin and fin[0] == ("pool error",)
                                  else state(cb, fin))
                check_invariants(cb)
            assert logs[0][-1] == logs[1][-1], (seed, len(logs[0]))
            assert len(logs[0]) < 400, "scheduler failed to converge"
            clock.t += 0.01
    return cbs


def test_scheduler_traces_match_jax(tiny, clock):
    preempted = shed = blown = 0
    for seed in range(50):
        jcb, tcb = run_trace(tiny, seed, clock)
        assert tcb.cancelled_count == jcb.cancelled_count
        assert tcb.retry_after_hint() == jcb.retry_after_hint()
        preempted += tcb.preemptions
        shed += tcb.shed_count
        blown += tcb.deadline_cancels
    assert preempted > 0 and shed > 0 and blown > 0


# ---------------------------------------------------------------------------
# SpilledSlot across the packages
# ---------------------------------------------------------------------------

DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16),
          "int8": (jnp.int8, torch.int8)}


def _jax_pool(name, n_pages=9, seed=0):
    rs = np.random.RandomState(seed)
    shape = (3, n_pages, PSZ, 2, 16)
    jdt = DTYPES[name][0]
    if name == "int8":
        k, v = (rs.randint(-127, 128, size=shape).astype(np.int8)
                for _ in range(2))
        ks, vs = (rs.rand(3, n_pages, 1, 1, 1).astype(np.float32)
                  for _ in range(2))
        return JKVC.PagedKV(jnp.asarray(k), jnp.asarray(v), jnp.asarray(ks),
                            jnp.asarray(vs))
    return JKVC.PagedKV(*(jnp.asarray(rs.randn(*shape), jnp.float32)
                          .astype(jdt) for _ in range(2)))


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _tensors(pkv):
    return [t for t in (pkv.k, pkv.v, pkv.k_scale, pkv.v_scale)
            if t is not None]


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_spilled_slot_bytes_cross_packages(name):
    """JAX spill → bytes → port restore into other pages, and the port's
    spill → bytes → JAX restore: the pages arrive bit for bit."""
    src = _jax_pool(name)
    raw = JKVC.spill_slot(src, 1, [3, 5, 7]).to_bytes()
    snap = TKVC.SpilledSlot.from_bytes(raw)
    tdt = DTYPES[name][1]
    dst = TKVC.init_paged_kv(9, PSZ, TKVC.A.AttnDims(4, 2, 16, 1e4), tdt,
                             n_units=3, device="cpu")
    TKVC.restore_slot(dst, 1, [2, 4, 8], snap)
    for j, t in zip(_tensors(src), _tensors(dst)):
        np.testing.assert_array_equal(t[:, [2, 4, 8]].float().numpy(),
                                      _np(j)[:, [3, 5, 7]])
    back = TKVC.spill_slot(dst, 1, [2, 4, 8]).to_bytes()
    jsnap = JKVC.SpilledSlot.from_bytes(back)
    jdst = JKVC.restore_slot(_jax_pool(name, seed=1), 1, [1, 6, 5], jsnap)
    for j, t in zip(_tensors(jdst), _tensors(src)):
        np.testing.assert_array_equal(_np(j)[:, [1, 6, 5]],
                                      _np(t)[:, [3, 5, 7]])
    with pytest.raises(ValueError, match="dtype mismatch"):
        other = "int8" if name != "int8" else "fp32"
        TKVC.restore_slot(TKVC.init_paged_kv(
            9, PSZ, TKVC.A.AttnDims(4, 2, 16, 1e4), DTYPES[other][1],
            n_units=3, device="cpu"), 0, [1, 2, 3], snap)


def test_copy_pages_in_place_and_bytes_by_dtype():
    pool = TKVC.init_paged_kv(6, PSZ, TKVC.A.AttnDims(4, 2, 16, 1e4),
                              torch.int8, n_units=2, device="cpu")
    for t in _tensors(pool):
        t.copy_(torch.arange(t.numel()).reshape(t.shape).to(t.dtype))
    ptrs = TKVC.pool_ptrs(pool)
    TKVC.copy_pool_pages(pool, 4, 1)
    assert TKVC.pool_ptrs(pool) == ptrs
    for t in _tensors(pool):
        assert torch.equal(t[:, 1], t[:, 4])
    by = TKVC.cache_bytes_by_dtype(pool)
    assert by == {"int8": 2 * 2 * 6 * PSZ * 2 * 16, "float32": 2 * 2 * 6 * 4}
    jpool = JKVC.PagedKV(*(jnp.zeros(t.shape, jnp.int8)
                           for t in (pool.k, pool.v)),
                         *(jnp.zeros(t.shape, jnp.float32)
                           for t in (pool.k_scale, pool.v_scale)))
    assert JKVC.cache_bytes_by_dtype(jpool) == by


def test_reset_slots_restores_init_rows():
    cur = {"h": torch.ones(2, 3, 4), "c": torch.ones(2, 3)}
    init = {"h": torch.full((2, 3, 4), -1e30), "c": torch.zeros(2, 3)}
    ptr = cur["h"].data_ptr()
    TKVC.reset_slots(cur, init, torch.tensor([True, False, True]), 1)
    assert cur["h"].data_ptr() == ptr
    assert torch.all(cur["h"][:, [0, 2]] == -1e30)
    assert torch.all(cur["h"][:, 1] == 1) and torch.all(cur["c"][:, 1] == 1)
    assert torch.all(cur["c"][:, [0, 2]] == 0)


# ---------------------------------------------------------------------------
# Small behaviours (the JAX tests of tests/test_decode.py and
# tests/test_prefill.py on the port)
# ---------------------------------------------------------------------------

def _cb(pair, **kw):
    return TS.ContinuousBatcher(pair[2], pair[3], **{
        **dict(num_slots=2, max_prompt=8, max_len=16, seg_len=4,
               page_size=4, precision="fp32"), **kw})


def _ints(rs, n):
    return rs.randint(0, TINY.vocab_size, size=n)


def test_continuous_completes_and_reclaims_pages(tiny):
    cb = _cb(tiny)
    rs = np.random.RandomState(0)
    rids = [cb.submit(_ints(rs, rs.randint(3, 9)), max_new=6)
            for _ in range(5)]
    done = cb.run()
    assert [r.rid for r in done] == rids
    assert all(len(r.out) == 6 for r in done)
    assert all(0 <= t < TINY.vocab_size for r in done for t in r.out)
    assert len(cb.free_pages) == cb.total_pages - 1 and not cb.page_refs
    assert cb.decode_dispatches * 2 <= cb.steps


def test_single_request_matches_static_engine(tiny):
    """A lone request on one slot draws like the static engine, so its
    tokens equal ``generate``'s with the same z."""
    prompt = _ints(np.random.RandomState(2), 7)
    cb = _cb(tiny, num_slots=1, chunk_size=4)
    zs = []

    def draws(n):
        z = tiny[2].db.sigma_max * torch.randn(
            (n, 1, 1, TINY.d_model), generator=torch.Generator()
            .manual_seed(len(zs)))
        zs.append(z)
        return z, None
    cb.draw_segment = draws
    cb.submit(prompt, 6)
    out = cb.run()[0].out
    z0 = torch.cat(zs)[:6]
    ref = TS.generate(tiny[2], tiny[3], prompt[None], 6, precision="fp32",
                      chunk_size=4, z0=z0)[0, 7:]
    assert out == ref.tolist()


def test_static_per_token_prefill_matches_jax(tiny):
    """The static engine's per-token prefill (``prefill_scan``): tokens
    equal to JAX's ``generate(prefill="per-token")`` on a ragged batch."""
    jdbm, jparams, tdbm, tparams = tiny
    rs = np.random.RandomState(12)
    prompts = rs.randint(0, TINY.vocab_size, size=(3, 9)).astype(np.int32)
    plens = np.array([9, 4, 6], np.int32)
    out_j = JS.generate(jdbm, jparams, jnp.asarray(prompts), 4,
                        rng=jax.random.PRNGKey(7), prompt_lengths=plens,
                        precision="fp32", prefill="per-token")
    rng, zs = jax.random.PRNGKey(7), []
    for _ in range(4):
        rng, r = jax.random.split(rng)
        zs.append(np.asarray(tdbm.db.sigma_max * jax.random.normal(
            jax.random.split(r)[0], (3, 1, TINY.d_model))))
    eng = TS.get_engine(tdbm, precision="fp32", prefill="per-token")
    steps = eng.prefill_steps
    out_t = TS.generate(tdbm, tparams, prompts, 4, prompt_lengths=plens,
                        precision="fp32", prefill="per-token",
                        z0=torch.from_numpy(np.stack(zs)))
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))
    assert eng.prefill_steps - steps == 9


def test_continuous_rejects_oversized_and_bad_requests(tiny):
    cb = _cb(tiny, num_slots=1, total_pages=2)
    cb.submit(np.arange(8) % TINY.vocab_size, max_new=8)   # needs 4 pages
    with pytest.raises(RuntimeError, match="page pool too small"):
        cb.run()
    with pytest.raises(ValueError, match="empty prompt"):
        cb.submit([], 2)
    with pytest.raises(ValueError, match="max_prompt"):
        cb.submit(np.zeros(9, np.int64), 2)
    with pytest.raises(ValueError, match="priority"):
        cb.submit([1], 2, priority="urgent")


@pytest.mark.parametrize("what", ["aux", "slo", "faults", "shed", "shared",
                                  "recover"])
def test_unported_options_raise(tiny, what):
    """Conditioned requests are refused by the dense family ("no aux", as
    JAX refuses them; the VLM takes them). SLOs, shedding, recovery,
    shared pools and the page handoff of
    ``extract_all(detach=True)`` are ported: each is accepted and works (an
    ``engine_crash`` raised by ``step`` is recovered from; two batchers on
    one ``SharedPagePool`` hold the same pool tensors and free list, and a
    detached slot's pages travel with its request until it is dropped)."""
    if what == "faults":
        from repro_torch.launch.faults import InjectedFault, make_injector
        cb = _cb(tiny, faults=make_injector({"engine_crash": {"at": [2]}}))
        cb.submit([1, 2, 3], 6)
        cb.step()
        with pytest.raises(InjectedFault, match="engine_crash"):
            cb.step()
        cb.recover()
        assert cb.preemptions == 1
        assert len(cb.run()[0].out) == 6 and cb.restores == 1
        return
    if what == "slo":
        cb = _cb(tiny)
        rid = cb.submit([1], 2, ttft_slo_s=1.0, tpot_slo_s=0.5)
        req = cb.queue[0]
        assert req.rid == rid and req.tpot_deadline_s == 0.5
        assert req.ttft_deadline == pytest.approx(req.submit_t + 1.0)
        assert cb.run()[0].error is None
        return
    if what == "shed":
        cb = _cb(tiny, max_queue=1)
        cb.submit([1], 2)
        with pytest.raises(TS.AdmissionError):
            cb.submit([1], 2)
        assert cb.shed_count == 1
        return
    if what == "recover":
        cb = _cb(tiny)
        cb.submit([1, 2], 12)
        cb.step()
        (req,) = cb.extract_all(detach=True)
        assert req.error is None and not cb.active.any()
        assert req.handoff_pages and req.spilled.n_pages == 0
        assert sorted(cb.page_refs) == sorted(req.handoff_pages)
        cb._drop_payload(req)
        cb.submit([1, 2], 12)
        cb.step()
        (req,) = cb.extract_all()
        assert req.error is None and not cb.active.any()
        assert len(cb.free_pages) == cb.total_pages - 1
        return
    if what == "shared":
        pool = TS.SharedPagePool(9)
        a, b = (_cb(tiny, shared_pool=pool) for _ in range(2))
        assert a.kv is b.kv is pool.kv and a.free_pages is pool.free_pages
        assert a.total_pages == b.total_pages == 9
        with pytest.raises(ValueError, match="same model"):
            _cb(tiny, shared_pool=pool, page_size=2)
        return
    # conditioned requests are ported (tests/test_torch_vlm.py); the dense
    # family takes none, as in JAX
    with pytest.raises(ValueError, match="no aux"):
        _cb(tiny).submit([1], 2, aux_inputs={
            "image_embs": np.zeros((4, TINY.d_model), np.float32)})


def test_cancel_queued_and_active(tiny):
    cb = _cb(tiny, num_slots=1)
    rs = np.random.RandomState(21)
    rids = [cb.submit(_ints(rs, 5), max_new=4) for _ in range(3)]
    assert cb.cancel(rids[1])
    done = {r.rid: r for r in cb.run()}
    assert done[rids[1]].cancelled and done[rids[1]].out == []
    assert len(done[rids[0]].out) == 4 and len(done[rids[2]].out) == 4
    assert cb.cancelled_count == 1 and not cb.cancel(rids[1])
    cb = _cb(tiny)
    a = cb.submit(_ints(rs, 6), max_new=8)
    b = cb.submit(_ints(rs, 6), max_new=8)
    assert not cb.step() and int(cb.active.sum()) == 2
    assert cb.cancel(a)
    fin = cb.step()
    assert fin[0].rid == a and fin[0].cancelled and not fin[0].pages
    assert 0 < len(fin[0].out) < 8
    rest = {r.rid: r for r in fin[1:] + cb.run()}
    assert list(rest) == [b] and len(rest[b].out) == 8
    assert len(cb.free_pages) == cb.total_pages - 1 and not cb.page_refs


def test_pause_holds_slot_and_resume_finishes(tiny):
    cb = _cb(tiny, num_slots=1)
    rid = cb.submit(_ints(np.random.RandomState(3), 6), max_new=8)
    cb.step()
    n = len(cb.slot_req[0].out)
    cb.pause(rid)
    cb.step()
    assert len(cb.slot_req[0].out) == n and cb.active[0]
    cb.resume(rid)
    assert len(cb.run()[0].out) == 8


def _prefix_cb(pair, **kw):
    return _cb(pair, **{**dict(num_slots=1, max_prompt=24, max_len=32,
                               chunk_size=8, prefix_cache=True), **kw})


def test_cancel_respects_prefix_refcounts(tiny):
    rs = np.random.RandomState(23)
    sys_p, u1, u2 = _ints(rs, 16), _ints(rs, 4), _ints(rs, 4)
    cb = _prefix_cb(tiny)
    cb.submit(np.concatenate([sys_p, u1]), max_new=4)
    cb.run()
    retained = set(cb.page_refs)
    rid = cb.submit(np.concatenate([sys_p, u2]), max_new=8)
    cb.step()
    req = cb.slot_req[0]
    assert req.shared_tokens == 16
    assert any(cb.page_refs.get(p, 0) > 1 for p in req.pages)
    assert cb.cancel(rid)
    assert cb.step()[0].cancelled
    assert all(v == 1 for v in cb.page_refs.values())
    assert retained <= set(cb.page_refs)
    assert len(cb.free_pages) + len(cb.page_refs) == cb.total_pages - 1
    cb.submit(np.concatenate([sys_p, u2]), max_new=4)
    done = cb.run()[0]
    assert done.shared_tokens >= 16 and len(done.out) == 4


@pytest.mark.parametrize("prefix_cache", [False, True])
def test_recycled_slot_does_not_leak(tiny, prefix_cache):
    """A recycled slot's second request is independent of its first
    occupant, cancelled mid-generation or finished."""
    rs = np.random.RandomState(24)
    p1, p2 = _ints(rs, 8), _ints(rs, 8)

    def serve(first):
        cb = _cb(tiny, num_slots=1, max_prompt=12, max_len=20, chunk_size=4,
                 prefix_cache=prefix_cache,
                 generator=torch.Generator().manual_seed(9))
        rid = cb.submit(first, max_new=8)
        cb.step()
        cb.step()
        assert len(cb.slot_req[0].out) == 4
        cb.cancel(rid)
        assert cb.step()[0].cancelled
        cb.submit(p2, max_new=5)
        out = cb.run()
        assert out[0].shared_tokens == 0
        assert len(cb.free_pages) + len(cb.page_refs) == cb.total_pages - 1
        return out[0].out

    assert serve(p1) == serve((p1 + 7) % TINY.vocab_size)


def test_prefix_second_request_prefills_suffix_only(tiny):
    rs = np.random.RandomState(4)
    sys_p, u1, u2 = _ints(rs, 16), _ints(rs, 6), _ints(rs, 6)
    cb = _prefix_cb(tiny, num_slots=2)
    cb.submit(np.concatenate([sys_p, u1]), max_new=5)
    cb.run()
    chunks = cb.ingest_dispatches
    cb.generator.manual_seed(4)
    cb.submit(np.concatenate([sys_p, u2]), max_new=5)
    req = cb.run()[0]
    assert req.shared_tokens == 16 and cb.prefix.hits == 1
    assert cb.ingest_dispatches - chunks == 1
    ref = _cb(tiny, num_slots=2, max_prompt=24, max_len=32, chunk_size=8,
              generator=torch.Generator().manual_seed(4))
    ref.submit(np.concatenate([sys_p, u2]), max_new=5)
    assert req.out == ref.run()[0].out


@pytest.mark.parametrize("precision", ["fp32", "fp32_kvint8"])
def test_prefix_cow_partial_tail(tiny, precision):
    """The same full prompt again maps every page and copies the partial
    tail before writing: the same draws give the same tokens, and the
    retained original still serves a diverging third request."""
    rs = np.random.RandomState(5)
    sys_p, u1 = _ints(rs, 18), _ints(rs, 4)
    cb = _prefix_cb(tiny, precision=precision)
    cb.submit(np.concatenate([sys_p, u1]), max_new=4)
    cb.generator.manual_seed(6)
    first = cb.run()[0].out
    cows = cb.cow_copies
    cb.generator.manual_seed(6)
    cb.submit(np.concatenate([sys_p, u1]), max_new=4)
    again = cb.run()[0]
    assert again.shared_tokens == 22 and cb.cow_copies > cows
    assert again.out == first
    cb.submit(np.concatenate([sys_p, (u1 + 3) % TINY.vocab_size]), 4)
    assert cb.run()[0].shared_tokens >= 16


def test_eviction_never_frees_matched_pages(tiny):
    rs = np.random.RandomState(13)
    sys_p, other, u2 = _ints(rs, 16), _ints(rs, 20), _ints(rs, 4)
    cb = _prefix_cb(tiny, max_len=28, total_pages=1 + 10)
    cb.submit(sys_p, max_new=4)
    cb.run()
    cb.submit(other, max_new=4)
    cb.run()
    assert len(cb.free_pages) == 1
    cb.generator.manual_seed(2)
    cb.submit(np.concatenate([sys_p, u2]), max_new=4)
    done = cb.run()[0]
    assert done.shared_tokens == 16
    ref = _cb(tiny, num_slots=1, max_prompt=24, max_len=28, chunk_size=8,
              generator=torch.Generator().manual_seed(2))
    ref.submit(np.concatenate([sys_p, u2]), max_new=4)
    assert done.out == ref.run()[0].out


def test_preempt_round_trip_is_exact(tiny):
    """Force-preempting mid-prefill and mid-decode changes no token: the
    snapshot restores into other pages and draws nothing."""
    prompt = (np.arange(1, 9) * 3) % TINY.vocab_size

    def serve(at):
        cb = _cb(tiny, num_slots=1, max_prompt=12, max_len=24, seg_len=3,
                 chunk_size=4, generator=torch.Generator().manual_seed(11))
        rid, step = cb.submit(prompt, 8), 0
        out = []
        while cb.has_work():
            if step == at:
                assert cb.preempt(rid)
            out.extend(cb.step())
            step += 1
        assert cb.restores == cb.preemptions == (at is not None)
        assert len(cb.free_pages) == cb.total_pages - 1
        return out[0].out

    base = serve(None)
    assert serve(1) == base and serve(3) == base


def test_kv_stats_and_kv_carries_all_state(tiny):
    cb = _cb(tiny, precision="fp32_kvint8")
    st = cb.kv_stats()
    assert st["kv_dtype"] == "int8" and st["kv_quantized"]
    assert st["kv_bytes"] == sum(st["kv_bytes_by_dtype"].values())
    assert tiny[2].model.kv_carries_all_state
    assert tiny[2].model.paged_state_axes == {}
    assert tiny[2].model.reset_paged_slots(cb.kv, None) is cb.kv


def test_graphs_need_the_card(tiny):
    with pytest.raises(ValueError, match="CUDA graphs"):
        _cb(tiny, graphs=True)


@pytest.mark.parametrize("argv", [
    ["--scheduler", "continuous", "--requests", "3", "--num-slots", "2",
     "--ragged", "--prefix-cache"],
    ["--scheduler", "continuous", "--requests", "2", "--prefill",
     "per-token"],
    ["--batch", "2", "--prefill", "per-token"]])
def test_serve_cli_on_cpu(capsys, argv):
    TS.main(["--device", "cpu", "--prompt-len", "8", "--max-new", "3",
             *argv])
    out = capsys.readouterr().out
    assert "legal-transition rate:" in out
    if "continuous" in argv:
        assert "[continuous]" in out and "served" in out
    if "--prefix-cache" in argv:
        assert "prefix cache:" in out
