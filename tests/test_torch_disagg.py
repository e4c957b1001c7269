"""PyTorch port: disaggregated prefill/decode serving against the JAX
package on the CPU.

``repro_torch.launch.router.DisaggRouter`` (its workers' dispatches run
eagerly on CPU tensors) against ``repro.launch.router.DisaggRouter`` on
bridged params of the dense ``TINY`` model and ``CB_KW`` of
``tests/test_disagg.py``, fp32. As there, parity runs one request at a time
with decode0's draws pinned: JAX's decode0 gets ``PRNGKey(seed)``, the
port's decode0 the same draws through ``draw_segment`` (``JaxDraws``), and
a failover hands the dead worker's draws to its idle successor in both.
Every dense case of ``tests/test_disagg.py`` runs through both routers,
each held bit-equal to JAX's uninterrupted unified run: migration in
``copy`` and ``pages`` modes, failover mid-decode in both, a dropped handoff
(re-prefill), a stalled one (timeout, then retry), a decode wipe-out that
degrades and re-splits, and ``/v1/health`` over the router read by both
packages' clients. Each router ends with its pool whole. ``SpilledSlot``
bytes restore across pools between the packages both ways (and refuse a
KV dtype mismatch), the server CLI serves ``--disagg`` in both handoff
modes, and a shared-pool fleet survives concurrent submits and cancels.

Every wait is bounded (``WAIT_S``) and fails instead of hanging.
"""
import argparse
import asyncio
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch
from test_torch_continuous import JaxDraws
from test_torch_serve import models

from repro import configs as JC
from repro.launch import faults as JF
from repro.launch import router as JR
from repro.launch import serve as JS
from repro.launch import server as JSV
from repro.nn import cache as JKVC
from repro_torch.launch import faults as TF
from repro_torch.launch import router as TR
from repro_torch.launch import serve as TS
from repro_torch.launch import server as TSV
from repro_torch.nn import cache as TKVC

torch.set_num_threads(1)

TINY = JC.ModelConfig(name="tiny-disagg", family="dense", n_layers=4,
                      d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
                      vocab_size=32)
CB_KW = dict(num_slots=2, max_prompt=12, max_len=24, seg_len=3, page_size=4,
             chunk_size=4, precision="fp32")
SEED = 11
WAIT_S = 30.0
HOST = "127.0.0.1"


@pytest.fixture(scope="module")
def pair():
    return models(TINY, blocks=2)


def mk_reqs(seed=7):
    rs = np.random.RandomState(seed)
    return [(rs.randint(0, TINY.vocab_size, size=n), 8) for n in (9, 6)]


def jax_draws(pair, seed, num_slots=CB_KW["num_slots"]):
    return JaxDraws(seed, num_slots, TINY, pair[2].db.sigma_max)


@pytest.fixture(scope="module")
def base(pair):
    """JAX's ground truth: each request alone on one unified batcher, one
    key carried across the sequence."""
    return jax_unified(pair, mk_reqs(), SEED)


def jax_unified(pair, reqs, seed, **kw):
    cb = JS.ContinuousBatcher(pair[0], pair[1], **{**CB_KW, **kw})
    rng = jax.random.PRNGKey(seed)
    outs = []
    for prompt, max_new in reqs:
        cb.submit(np.asarray(prompt, np.int32), max_new)
        fin = []
        while cb.has_work():
            rng, f = cb.step(rng, strict=False)
            fin.extend(f)
        assert len(fin) == 1 and fin[0].error is None, fin
        outs.append(list(fin[0].out))
    return outs


def wait_for(cond, what: str, timeout: float = WAIT_S) -> None:
    t0 = time.time()
    while not cond():
        if time.time() - t0 > timeout:
            raise AssertionError(f"{what} did not happen in {timeout} s")
        time.sleep(0.005)


def pool_whole(router) -> None:
    """No page leaked anywhere (every non-trash page free or mapped) and
    no payload stranded in the handoff queue."""
    if router.pool is not None:
        free, refs, tot = (len(router.pool.free_pages),
                           len(router.pool.page_refs),
                           router.pool.total_pages)
        assert free + refs == tot - 1, ("shared pool leak", free, refs, tot)
    else:
        for w in router.workers:
            free, refs, tot = (len(w.cb.free_pages), len(w.cb.page_refs),
                               w.cb.total_pages)
            assert free + refs == tot - 1, (w.name, free, refs, tot)
    assert not router._handoffs, "payload stranded in the handoff queue"


def run_router(side, pair, reqs, *, handoff, seed=SEED, die_at=None,
               faults=None, **router_kw):
    """The requests one at a time through a started router of package
    ``side`` (1 prefill worker, 1 decode worker or 2 with ``die_at``, which
    kills decode0 on its ``die_at``-th step); decode0 draws what JAX draws
    from key ``seed``. Returns (tokens, stats)."""
    n_decode = 2 if die_at is not None else 1
    if side == "jax":
        router = JR.DisaggRouter(
            pair[0], pair[1], n_prefill=1, n_decode=n_decode,
            handoff=handoff, faults=faults and JF.FaultInjector(faults, 0),
            **{**CB_KW, **router_kw})
        router.decode_workers[0].runner.rng = jax.random.PRNGKey(seed)
        injector = JF.FaultInjector
    else:
        router = TR.DisaggRouter(
            pair[2], pair[3], n_prefill=1, n_decode=n_decode,
            handoff=handoff, faults=faults and TF.FaultInjector(faults, 0),
            **{**CB_KW, **router_kw})
        router.decode_workers[0].cb.draw_segment = jax_draws(pair, seed)
        injector = TF.FaultInjector
    done = {}
    router.finish_cb = lambda r: done.setdefault(r.rid, r)
    if die_at is not None:
        router.decode_workers[0].cb.faults = injector(
            {"worker_die": {"at": [die_at]}}, seed=0)
    router.start()
    outs = []
    try:
        for prompt, max_new in reqs:
            rid = router.submit(
                np.asarray(prompt, np.int32 if side == "jax" else np.int64),
                max_new)
            wait_for(lambda: rid in done, f"{side} router request {rid}")
            r = done[rid]
            assert r.error is None, r.error
            outs.append(list(r.out))
    finally:
        router.stop(WAIT_S)
    pool_whole(router)
    return outs, router.stats()


def both(pair, base, reqs=None, **kw):
    """The same run through both routers: each bit-equal to JAX's unified
    run. Returns (JAX's stats, the port's stats)."""
    reqs = reqs or mk_reqs()
    got = {side: run_router(side, pair, reqs, **kw) for side in ("jax",
                                                                 "port")}
    for side, (outs, _) in got.items():
        assert outs == base, (side, outs, base)
    js, ps = got["jax"][1], got["port"][1]
    assert set(ps) == set(js) and {k for w in ps["workers"] for k in w} == {
        k for w in js["workers"] for k in w}
    return js, ps


# ---------------------------------------------------------------------------
# Migration and failover parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("handoff", ["copy", "pages"])
def test_migration_parity(pair, base, handoff):
    """A request migrated prefill -> decode (byte copy or page handles)
    emits the tokens of an uninterrupted unified run, in both packages."""
    for stats in both(pair, base, handoff=handoff):
        assert stats["migrations"] >= 2, stats
        assert stats["failovers"] == 0 and stats["re_prefills"] == 0, stats
        assert stats["mode"] == "split"


@pytest.mark.parametrize("handoff", ["copy", "pages"])
def test_failover_parity_mid_decode(pair, base, handoff):
    """decode0 dies on its 2nd engine step (one segment delivered); the
    survivor adopts the dead worker's draws, and the request migrated again
    (pages) or re-prefilled (copy) finishes bit-identically."""
    js, ps = both(pair, base, handoff=handoff, die_at=2)
    for stats in (js, ps):
        assert stats["failovers"] >= 1, stats
    assert ps["failovers"] == js["failovers"]
    assert ps["re_prefills"] == js["re_prefills"]


# ---------------------------------------------------------------------------
# Handoff fault seams
# ---------------------------------------------------------------------------

def test_handoff_drop_falls_back_to_reprefill(pair, base):
    """A payload lost in transit re-prefills from the original prompt (no
    decode step had drawn), so parity holds."""
    for stats in both(pair, base, handoff="copy",
                      faults={"handoff_drop": {"at": [1]}}):
        assert stats["handoff_drops"] == 1, stats
        assert stats["re_prefills"] >= 1, stats


def test_handoff_stall_times_out_then_retries(pair, base):
    """A send stalled past the handoff timeout keeps its payload; the
    backoff retry delivers the same payload (no re-prefill)."""
    for stats in both(pair, base, handoff="copy",
                      handoff_timeout_s=0.05, handoff_backoff_s=0.01,
                      faults={"handoff_stall": {"at": [1], "sleep": 0.2}}):
        assert stats["handoff_retries"] >= 1, stats
        assert stats["re_prefills"] == 0, stats


@pytest.mark.parametrize("side", ["jax", "port"])
def test_decode_wipeout_degrades_then_resplits(pair, side):
    """Killing the only decode worker degrades the router to unified mode
    (the prefill worker decodes itself); once the dead worker restarts the
    router re-splits and later requests migrate again, in both packages."""
    mod, ip = (JR, 0) if side == "jax" else (TR, 2)
    router = mod.DisaggRouter(pair[ip], pair[ip + 1], n_prefill=1,
                              n_decode=1, handoff="copy",
                              restart_dead_after_s=0.3, **CB_KW)
    injector = JF.FaultInjector if side == "jax" else TF.FaultInjector
    done = {}
    router.finish_cb = lambda r: done.setdefault(r.rid, r)
    router.decode_workers[0].cb.faults = injector(
        {"worker_die": {"at": [1]}}, seed=0)
    router.start()
    prompt = np.arange(1, 9) % TINY.vocab_size
    try:
        rid = router.submit(prompt, 8)
        wait_for(lambda: rid in done, "the degraded request")
        assert done[rid].error is None and len(done[rid].out) == 8
        assert router.degradations >= 1, router.stats()
        wait_for(lambda: router.mode == "split", "the re-split")
        assert router.resplits >= 1
        m0 = router.migrations
        rid = router.submit(prompt, 6)
        wait_for(lambda: rid in done, "the request after the re-split")
        assert done[rid].error is None and len(done[rid].out) == 6
        assert router.migrations > m0, "a re-split router migrates again"
    finally:
        router.stop(WAIT_S)
    pool_whole(router)


# ---------------------------------------------------------------------------
# /v1/health over the router
# ---------------------------------------------------------------------------

def test_router_health_endpoint(pair):
    """The HTTP frontend drives a router as it drives a batcher: both
    packages' clients stream from the port's server the tokens JAX's server
    streams over JAX's router under the same draws, and ``/v1/health``
    reports the worker list and the router's counters with JAX's keys."""
    prompt = (np.arange(2, 9) * 3) % TINY.vocab_size

    async def main(side):
        if side == "jax":
            router = JR.DisaggRouter(pair[0], pair[1], n_prefill=1,
                                     n_decode=1, handoff="copy", **CB_KW)
            router.decode_workers[0].runner.rng = jax.random.PRNGKey(7)
            server = JSV.InferenceServer(router)
        else:
            router = TR.DisaggRouter(pair[2], pair[3], n_prefill=1,
                                     n_decode=1, handoff="copy", **CB_KW)
            router.decode_workers[0].cb.draw_segment = jax_draws(pair, 7)
            server = TSV.InferenceServer(router)
        await server.start()
        try:
            ids = []
            for api in (JSV, TSV):
                r = await api.stream_generate(HOST, server.port, prompt, 6)
                assert r["status"] == 200 and r["final"]["ids"] == r["ids"]
                ids.append(r["ids"])
            healths = [await api.request_json(HOST, server.port, "GET",
                                              "/v1/health")
                       for api in (JSV, TSV)]
        finally:
            await server.aclose()
        pool_whole(router)
        return ids, healths

    (jids, (jh, _)), (pids, port_h) = (asyncio.run(main(s))
                                       for s in ("jax", "port"))
    # the two requests run one after the other on decode0's one stream
    assert pids == jids and len(pids[0]) == 6
    assert port_h[0][0] == port_h[1][0] == 200
    assert set(port_h[0][1]) == set(port_h[1][1])
    code, health = port_h[1]
    assert code == jh[0] == 200 and set(health) == set(jh[1])
    assert health["router"] is True and health["mode"] == "split"
    assert health["served"] == 2 and health["engine_alive"] is True
    for key in ("migrations", "failovers", "handoff_retries",
                "handoff_drops", "re_prefills", "degradations", "resplits"):
        assert isinstance(health[key], int), key
        assert health[key] == jh[1][key], key
    assert health["migrations"] >= 2
    workers = {w["name"]: w for w in health["workers"]}
    assert set(workers) == {"prefill0", "decode0"}
    assert {k for w in workers.values() for k in w} == {
        k for w in jh[1]["workers"] for k in w}
    assert workers["prefill0"]["role"] == "prefill"
    assert workers["decode0"]["role"] == "decode"
    for w in workers.values():
        assert w["alive"] is True and w["heartbeat_age_s"] >= 0.0
        assert w["free_pages"] <= w["total_pages"]
    assert workers["prefill0"]["migrated_out"] >= 2


# ---------------------------------------------------------------------------
# SpilledSlot bytes across pools, between the packages
# ---------------------------------------------------------------------------

def _spill_jax(pair, prompt, kv_dtype, seed):
    """2 prefill chunks + 1 decode segment on JAX's batcher, then spill:
    (the request, its wire bytes, the key the run goes on from)."""
    src = JS.ContinuousBatcher(pair[0], pair[1], **dict(
        CB_KW, num_slots=1, kv_dtype=kv_dtype))
    src.submit(np.asarray(prompt, np.int32), 8)
    rng = jax.random.PRNGKey(seed)
    for _ in range(3):
        rng, f = src.step(rng, strict=False)
        assert not f
    with src._pool_lock:
        req = src._spill_slot(0)
    assert len(src.free_pages) == src.total_pages - 1, "pages leaked"
    return req, req.spilled.to_bytes(), rng


def _spill_port(pair, prompt, kv_dtype, seed):
    src = TS.ContinuousBatcher(pair[2], pair[3], **dict(
        CB_KW, num_slots=1, kv_dtype=kv_dtype))
    src.draw_segment = jax_draws(pair, seed, 1)
    src.submit(prompt, 8)
    for _ in range(3):
        assert not src.step(strict=False)
    with src._pool_lock:
        req = src._spill_slot(0)
    assert len(src.free_pages) == src.total_pages - 1, "pages leaked"
    return req, req.spilled.to_bytes(), src.draw_segment.rng


def _restore_port(pair, req, raw, rng, kv_dtype, total_pages):
    """The payload into a bigger port pool with a rotated free list, so it
    lands in other physical pages; run to the end under the same draws."""
    dst = TS.ContinuousBatcher(pair[2], pair[3], **dict(
        CB_KW, num_slots=1, kv_dtype=kv_dtype, total_pages=total_pages))
    dst.free_pages = dst.free_pages[5:] + dst.free_pages[:5]
    dst.draw_segment = jax_draws(pair, 0, 1)
    dst.draw_segment.rng = rng
    moved = TS.Request(req.rid, np.asarray(req.prompt, np.int64),
                       req.max_new)
    moved.out = list(req.out)
    moved.spilled = TKVC.SpilledSlot.from_bytes(raw)
    moved.spill_meta = dict(length=req.spill_meta["length"])
    dst.submit_request(moved)

    def run():
        fin = []
        for _ in range(64):
            if not dst.has_work():
                break
            fin.extend(dst.step(strict=False))
        return fin
    return dst, run


def _restore_jax(pair, req, raw, rng, kv_dtype, total_pages):
    dst = JS.ContinuousBatcher(pair[0], pair[1], **dict(
        CB_KW, num_slots=1, kv_dtype=kv_dtype, total_pages=total_pages))
    dst.free_pages = dst.free_pages[5:] + dst.free_pages[:5]
    moved = JS.Request(req.rid, np.asarray(req.prompt, np.int32),
                       req.max_new)
    moved.out = list(req.out)
    moved.spilled = JKVC.SpilledSlot.from_bytes(raw)
    moved.spill_meta = dict(length=req.spill_meta["length"], cond_length=0)
    dst.submit_request(moved)

    def run():
        nonlocal rng
        fin = []
        for _ in range(64):
            if not dst.has_work():
                break
            rng, f = dst.step(rng, strict=False)
            fin.extend(f)
        return fin
    return dst, run


SPILL = {"jax": _spill_jax, "port": _spill_port}
# one slot's worst case at CB_KW's max_len and page size, plus the trash page
KVC_PAGES = 1 + TKVC.pages_for(CB_KW["max_len"], CB_KW["page_size"])
RESTORE = {"jax": _restore_jax, "port": _restore_port}


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("src,dst", [("jax", "port"), ("port", "jax")])
def test_spilled_slot_crosses_pools_between_packages(pair, src, dst,
                                                     kv_dtype):
    """One package spills a dense slot mid-decode (its used pages' content,
    int8 with their fp32 scales); the other restores the wire bytes into a
    different pool's pages and finishes: the tokens equal JAX's
    uninterrupted run, and the pool ends whole."""
    prompt = (np.arange(1, 9) * 5 % TINY.vocab_size).astype(np.int64)
    want = jax_unified(pair, [(prompt, 8)], SEED, num_slots=1,
                       kv_dtype=kv_dtype)[0]
    req, raw, rng = SPILL[src](pair, prompt, kv_dtype, SEED)
    assert 0 < len(req.out) < 8, req.out
    pool, run = RESTORE[dst](pair, req, raw, rng, kv_dtype, KVC_PAGES + 6)
    fin = run()
    assert len(fin) == 1 and fin[0].error is None
    assert pool.restores == 1
    assert list(fin[0].out) == want, (src, dst, fin[0].out, want)
    assert len(pool.free_pages) == pool.total_pages - 1 and not pool.page_refs


@pytest.mark.parametrize("src", ["jax", "port"])
def test_spilled_slot_cross_dtype_restore_refused(pair, src):
    """An int8 pool's snapshot does not restore into a pool of another KV
    dtype: the restoring step fails loudly with the remedy (one
    ``--kv-dtype`` everywhere, or a re-prefill), after the wire round
    trip, whichever package spilled it."""
    prompt = (np.arange(1, 9) * 5 % TINY.vocab_size).astype(np.int64)
    req, raw, rng = SPILL[src](pair, prompt, "int8", SEED)
    _, run = _restore_port(pair, req, raw, rng, None, KVC_PAGES)
    with pytest.raises(ValueError, match="cache-state dtype mismatch") as ei:
        run()
    assert "--kv-dtype" in str(ei.value) and "re-prefill" in str(ei.value)


# ---------------------------------------------------------------------------
# The command line, and the fleet under concurrent clients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("handoff", ["copy", "pages"])
def test_server_cli_serves_disagg_on_cpu(capsys, handoff):
    """``--disagg`` builds a router over ``--prefill-workers`` +
    ``--decode-workers`` workers; the CLI's loop prints the fleet's shape,
    serves a request and drains when cancelled."""
    ap = argparse.ArgumentParser()
    TSV.add_server_args(ap)
    args = ap.parse_args(["--device", "cpu", "--prompt-len", "8",
                          "--max-new", "4", "--num-slots", "2", "--disagg",
                          "--handoff", handoff, "--decode-workers", "2",
                          "--prefix-cache"])
    args.host, args.port = HOST, 0

    async def main():
        task = asyncio.ensure_future(TSV._serve_forever(args))
        t0, out = time.time(), ""
        while "serving on" not in out:
            assert time.time() - t0 < WAIT_S, "the server never started"
            out += capsys.readouterr().out
            await asyncio.sleep(0.005)
        port = int(out.split("serving on http://")[1].split()[0]
                   .rsplit(":", 1)[1])
        r = await TSV.stream_generate(HOST, port, [1, 2, 3], 4)
        _, health = await TSV.request_json(HOST, port, "GET", "/v1/health")
        task.cancel()
        await asyncio.gather(task, return_exceptions=True)
        return out, r, health

    out, r, health = asyncio.run(main())
    assert f"disagg 1p+2d, handoff={handoff}" in out
    assert r["status"] == 200 and len(r["ids"]) == 4
    assert health["migrations"] == 1 and health["handoff"] == handoff
    assert "drained; bye" in capsys.readouterr().out


def test_shared_pool_fleet_under_concurrent_submits_and_cancels(pair):
    """Eight client threads submit and cancel at once against a
    page-handoff fleet (1 prefill, 3 decode workers on one shared pool),
    the interpreter switching threads every microsecond: every request
    finishes exactly once, served in full or cancelled, and the shared pool
    ends whole, so no update of the pool, the queues or the router's state
    was lost."""
    router = TR.DisaggRouter(pair[2], pair[3], n_prefill=1, n_decode=3,
                             handoff="pages", **CB_KW)
    done, lock = [], threading.Lock()

    def finish(r):
        with lock:
            done.append(r)

    router.finish_cb = finish
    rids, rlock = [], threading.Lock()

    def client(seed):
        rs = np.random.RandomState(seed)
        for _ in range(4):
            rid = router.submit(rs.randint(0, TINY.vocab_size, size=6), 6)
            with rlock:
                rids.append(rid)
                pick = int(rs.choice(rids))
            if rs.rand() < 0.3:
                router.cancel(pick)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        router.start()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT_S)
        wait_for(lambda: len(done) >= 32, "32 finished requests")
    finally:
        sys.setswitchinterval(old)
        router.stop(WAIT_S)
    assert not any(t.is_alive() for t in threads)
    assert sorted(r.rid for r in done) == sorted(rids) == list(range(32))
    for r in done:
        assert r.error is None
        assert r.cancelled or len(r.out) == 6, (r.rid, r.out)
    assert router.migrations >= sum(not r.cancelled for r in done)
    pool_whole(router)


@pytest.mark.parametrize("handoff", ["copy", "pages"])
def test_dropping_a_served_router_frees_its_workers_without_gc(pair,
                                                               handoff):
    """A router that served over HTTP, lost a decode worker and restarted
    it holds no reference cycle: once it and its server are dropped, its
    batchers (their pools and, on the card, their graphs) are freed with
    the garbage collector off."""
    import gc
    import weakref

    def serve():
        router = TR.DisaggRouter(pair[2], pair[3], n_prefill=1, n_decode=2,
                                 handoff=handoff, restart_dead_after_s=0.05,
                                 **CB_KW)
        router.decode_workers[0].cb.faults = TF.FaultInjector(
            {"worker_die": {"at": [1]}})
        refs = [weakref.ref(w.cb) for w in router.workers]

        async def main():
            server = TSV.InferenceServer(router)
            await server.start()
            try:
                rets = await asyncio.gather(*[
                    TSV.stream_generate(HOST, server.port, [1, 2, 3, 4, 5],
                                        6) for _ in range(4)])
                t0 = time.time()
                while router.decode_workers[0].restarts < 1:
                    assert time.time() - t0 < WAIT_S, "no restart"
                    await asyncio.sleep(0.005)
                return rets
            finally:
                await server.aclose()

        rets = asyncio.run(main())
        assert all(len(r["ids"]) == 6 for r in rets)
        assert router.failovers >= 1
        return refs

    gc.collect()
    gc.disable()
    try:
        refs = serve()
        assert [r() for r in refs] == [None] * len(refs)
    finally:
        gc.enable()
