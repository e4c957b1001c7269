"""PyTorch port: the HTTP/SSE serving frontend against the JAX package on
the CPU.

``repro_torch.launch.server`` (its ``EngineRunner`` stepping a
``ContinuousBatcher`` whose dispatches run eagerly on CPU tensors) against
``repro.launch.server`` on bridged params of the dense ``TINY`` model of
``tests/test_server.py``, fp32. JAX's engine thread draws each segment's z
inside its scan from the key it threads; the port's batcher is handed the
same draws through ``draw_segment`` (``JaxDraws``), so under one key a
sequence of requests on a one-slot server streams the same greedy tokens
from both servers and from the port's direct ``step()`` loop.

Each package's client talks to the other's server (SSE and JSON), so the
wire format holds both ways; validation messages, status codes and the
``/v1/health`` payload are compared between the servers. The rest ports
the behaviours of ``tests/test_server.py``: cancel frees pages, a closed
connection cancels, backpressure pauses without corrupting the output,
drain completes in-flight work and answers 503, a shed is a 429 with
``Retry-After``, and the supervisor restarts after an injected
``engine_crash`` and gives up past ``max_restarts``. ``--ckpt-dir`` serves a
JAX-saved block directory through both serving CLIs' code paths.
"""
import argparse
import asyncio

import jax
import numpy as np
import pytest
import torch
from test_torch_continuous import JaxDraws
from test_torch_serve import models

from repro import configs as JC
from repro.launch import faults as JF
from repro.launch import serve as JS
from repro.launch import server as JSV
from repro_torch.launch import faults as TF
from repro_torch.launch import serve as TS
from repro_torch.launch import server as TSV

torch.set_num_threads(1)

TINY = JC.ModelConfig(name="tiny-server", family="dense", n_layers=4,
                      d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
                      vocab_size=32)
CB_KW = dict(max_prompt=12, max_len=24, seg_len=3, page_size=4,
             chunk_size=4, precision="fp32")
HOST = "127.0.0.1"
CLIENTS = {"jax": JSV, "port": TSV}
# a 50 ms engine stall per segment, so that requests are still in flight
# when a test's cancel or drain lands, however fast the host
STALL = {"token_stall": {"every": 1, "sleep": 0.05}}


@pytest.fixture(scope="module")
def pair():
    return models(TINY, blocks=2)


def make_prompts(seed, n, lo=3, hi=10):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, TINY.vocab_size, size=rs.randint(lo, hi))
            for _ in range(n)]


def port_batcher(pair, seed, *, num_slots=1, faults=None, **kw):
    """The port's batcher, drawing what JAX's engine draws from key
    ``seed``."""
    cb = TS.ContinuousBatcher(
        pair[2], pair[3], num_slots=num_slots,
        faults=faults and TF.FaultInjector(faults, seed=1),
        **{**CB_KW, **kw})
    cb.draw_segment = JaxDraws(seed, num_slots, TINY, pair[2].db.sigma_max)
    return cb


async def serve(side, pair, seed, *, num_slots=1, faults=None, queue_cap=256,
                max_restarts=3, **kw):
    """A started server of package ``side`` over a fresh batcher: (batcher,
    server)."""
    if side == "port":
        cb = port_batcher(pair, seed, num_slots=num_slots, faults=faults,
                          **kw)
        server = TSV.InferenceServer(cb, queue_cap=queue_cap,
                                     max_restarts=max_restarts)
    else:
        cb = JS.ContinuousBatcher(
            pair[0], pair[1], num_slots=num_slots,
            faults=faults and JF.FaultInjector(faults, seed=1),
            **{**CB_KW, **kw})
        server = JSV.InferenceServer(cb, queue_cap=queue_cap,
                                     rng=jax.random.PRNGKey(seed),
                                     max_restarts=max_restarts)
    await server.start()
    return cb, server


def direct_step_loop(pair, prompts, max_new, seed):
    """The same requests through the port's batcher, one at a time."""
    cb = port_batcher(pair, seed)
    outs = []
    for p in prompts:
        rid = cb.submit(p, max_new)
        fin = []
        while cb.has_work():
            fin.extend(cb.step())
        outs.append(next(r.out for r in fin if r.rid == rid))
    return outs


def pool_whole(cb):
    return (len(cb.free_pages) == cb.total_pages - 1 and not cb.page_refs
            and not cb.active.any())


# ---------------------------------------------------------------------------
# Tokens: the port's server, JAX's server, the direct step loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("server,client", [("port", "port"),
                                           ("port", "jax"),
                                           ("jax", "port")])
def test_sse_tokens_match_jax_and_direct_step_loop(pair, server, client):
    """Ragged requests streamed one at a time reassemble to the tokens of
    the port's direct ``step()`` loop under the same draws, whichever
    package serves and whichever package's client reads."""
    prompts = make_prompts(1, 3)

    async def main():
        cb, srv = await serve(server, pair, 11)
        try:
            out = []
            for p in prompts:
                r = await CLIENTS[client].stream_generate(HOST, srv.port, p,
                                                          6)
                assert r["status"] == 200 and r["final"]["ids"] == r["ids"]
                assert r["final"]["cancelled"] is False
                out.append(r["ids"])
            return out
        finally:
            await srv.aclose()

    got = asyncio.run(main())
    assert got == direct_step_loop(pair, prompts, 6, 11)


@pytest.mark.parametrize("server,client", [("port", "jax"),
                                           ("jax", "port")])
def test_nonstreaming_response_matches_sse(pair, server, client):
    """``"stream": false`` answers one JSON body whose ids equal the SSE
    stream's under the same key (two fresh servers)."""
    prompt = [int(t) for t in make_prompts(2, 1)[0]]
    api = CLIENTS[client]

    async def once(stream):
        cb, srv = await serve(server, pair, 13)
        try:
            if stream:
                r = await api.stream_generate(HOST, srv.port, prompt, 6)
                return r["ids"]
            code, obj = await api.request_json(
                HOST, srv.port, "POST", "/v1/generate",
                {"prompt": prompt, "max_new": 6, "stream": False})
            assert code == 200 and obj["cancelled"] is False
            assert obj["n"] == 6 and obj["preempted"] == 0
            return obj["ids"]
        finally:
            await srv.aclose()

    assert asyncio.run(once(True)) == asyncio.run(once(False))
    assert asyncio.run(once(True)) == direct_step_loop(pair, [prompt], 6,
                                                       13)[0]


# ---------------------------------------------------------------------------
# Validation, health
# ---------------------------------------------------------------------------

BAD = [
    {"prompt": [], "max_new": 4},                 # empty
    {"prompt": [1, "a"], "max_new": 4},           # non-int
    {"prompt": [1, 99], "max_new": 4},            # out of vocab
    {"prompt": [1] * 13, "max_new": 4},           # > max_prompt
    {"prompt": [1, 2], "max_new": 0},             # bad max_new
    {"prompt": [1, 2], "max_new": 23},            # > max_len
    {"prompt": [1, 2], "max_new": 4, "temperature": 0.9},
    {"prompt": [1, 2], "max_new": 4, "top_k": 5},
    {"prompt": [1, 2], "max_new": 4, "aux": "nope"},
    {"prompt": [1, 2], "max_new": 2, "priority": "vip"},
    {"prompt": [1, 2], "max_new": 2, "priority": 1.5},
    {"prompt": [1, 2], "max_new": 2, "priority": True},
    {"prompt": [1, 2], "max_new": 2, "ttft_slo_ms": -5},
    {"prompt": [1, 2], "max_new": 2, "tpot_slo_ms": "fast"},
    [1, 2, 3],                                    # not an object
]


def test_validation_and_health_match_jax(pair):
    """Every malformed request gets JAX's status code and message from the
    port's server; unknown routes 404, a bad cancel id 400; engine-static
    sampler values equal to the engine's are accepted and SLO fields are
    echoed; ``/v1/health`` has JAX's keys and, on a fresh server, its
    values."""
    async def main():
        servers = [await serve(side, pair, 3, max_queue=8,
                               shed_below_pages=1) for side in ("jax",
                                                                "port")]
        try:
            answers = {}
            for (_, srv), side in zip(servers, ("jax", "port")):
                api = CLIENTS["port" if side == "jax" else "jax"]
                got = [await api.request_json(HOST, srv.port, "POST",
                                              "/v1/generate", p)
                       for p in BAD]
                got.append(await api.request_json(HOST, srv.port, "GET",
                                                  "/v1/nope"))
                got.append(await api.request_json(HOST, srv.port, "POST",
                                                  "/v1/cancel/bogus"))
                got.append(await api.request_json(HOST, srv.port, "POST",
                                                  "/v1/cancel/999"))
                got.append(await api.request_json(HOST, srv.port, "GET",
                                                  "/v1/health"))
                code, obj = await api.request_json(
                    HOST, srv.port, "POST", "/v1/generate",
                    {"prompt": [1, 2], "max_new": 2, "stream": False,
                     "temperature": 0.0, "top_k": 0,
                     "priority": "interactive", "ttft_slo_ms": 60_000,
                     "tpot_slo_ms": 60_000})
                obj.pop("ttft_ms")
                got.append((code, obj))
                answers[side] = got
            return answers
        finally:
            for _, srv in servers:
                await srv.aclose()

    answers = asyncio.run(main())
    assert answers["port"] == answers["jax"]
    port = answers["port"]
    for code, obj in port[:len(BAD)]:
        assert code == 400 and "error" in obj
    assert [c for c, _ in port[len(BAD):len(BAD) + 3]] == [404, 400, 200]
    assert port[len(BAD) + 2][1]["cancelled"] is False
    health = port[-2][1]
    assert health["engine_alive"] is True and health["max_queue"] == 8
    code, obj = port[-1]
    assert code == 200 and obj["n"] == 2 and "deadline_blown" not in obj


# ---------------------------------------------------------------------------
# Cancellation, backpressure
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("how", ["cancel", "disconnect"])
def test_cancel_and_disconnect_free_pages(pair, how):
    """``POST /v1/cancel`` mid-stream ends the stream early with
    ``cancelled: true``; a closed connection cancels too. Every page
    returns to the pool."""
    prompt = make_prompts(3, 1)[0]

    async def main():
        cb, srv = await serve("port", pair, 5, num_slots=2, faults=STALL)
        try:
            kw = ({"cancel_after": 2} if how == "cancel"
                  else {"abort_after": 2})
            r = await JSV.stream_generate(HOST, srv.port, prompt, 18, **kw)
            for _ in range(400):
                _, health = await TSV.request_json(HOST, srv.port, "GET",
                                                   "/v1/health")
                if health["cancelled"] == 1 and not health["active_slots"]:
                    break
                await asyncio.sleep(0.005)
            return cb, r, health
        finally:
            await srv.aclose()

    cb, r, health = asyncio.run(main())
    assert 2 <= len(r["ids"]) < 18
    if how == "cancel":
        assert r["final"]["cancelled"] is True
        assert r["final"]["ids"] == r["ids"]
    else:
        assert r["aborted"] and r["final"] is None
    assert health["cancelled"] == 1 and health["active_slots"] == 0
    assert pool_whole(cb)


def test_slow_consumer_backpressure_pauses_without_corruption(pair):
    """A consumer behind the engine trips the bounded bridge: the slot
    pauses until the consumer drains (paused steps dispatch and draw
    nothing), and the tokens still equal the direct step loop's. The cap
    is one segment's tokens, so the first segment's push engages the pause
    whatever the relative speeds of engine and consumer."""
    prompt = make_prompts(4, 1)[0]
    max_new = 15
    cap = CB_KW["seg_len"]

    async def main():
        cb = port_batcher(pair, 17)
        runner = TSV.EngineRunner(cb)
        runner.start()
        pauses = []

        def on_pause(r):
            pauses.append(r)
            cb.pause(r)

        rid = cb.submit(prompt, max_new)
        stream = TSV.TokenStream(
            asyncio.get_running_loop(), rid, cap=cap, on_pause=on_pause,
            on_resume=lambda r: (cb.resume(r), runner.wake()))
        runner.attach(rid, stream)
        ids, done = [], False
        while not done:
            toks, done = await stream.next_batch()
            ids.extend(toks)
            await asyncio.sleep(0.1)        # slow consumer
        runner.stop(timeout=10)
        assert not runner._thread.is_alive()
        return ids, pauses, stream.pauses

    ids, pauses, n_pauses = asyncio.run(main())
    assert len(ids) == max_new and pauses and n_pauses >= 1
    assert ids == direct_step_loop(pair, [prompt], max_new, 17)[0]


def test_concurrent_ragged_clients_complete(pair):
    """More ragged clients than slots, all at once: every request completes
    with its full budget, ids are unique, the pool is whole."""
    prompts = make_prompts(5, 5)
    news = [4, 7, 3, 6, 5]

    async def main():
        cb, srv = await serve("port", pair, 0, num_slots=2)
        try:
            rets = await asyncio.gather(*[
                TSV.stream_generate(HOST, srv.port, p, n)
                for p, n in zip(prompts, news)])
            return cb, rets, srv.stats()
        finally:
            await srv.aclose()

    cb, rets, stats = asyncio.run(main())
    assert [r["status"] for r in rets] == [200] * 5
    assert [len(r["ids"]) for r in rets] == news
    assert len({r["request_id"] for r in rets}) == 5
    assert stats["served"] == 5 and stats["active_slots"] == 0
    assert pool_whole(cb)


# ---------------------------------------------------------------------------
# Drain, admission control
# ---------------------------------------------------------------------------

async def _poll(srv, want):
    for _ in range(400):
        _, h = await TSV.request_json(HOST, srv.port, "GET", "/v1/health")
        if want(h):
            return
        await asyncio.sleep(0.005)
    raise AssertionError("the server never reached the wanted state")


@pytest.mark.parametrize("case", ["in flight", "mid prefill"])
def test_drain_completes_in_flight_and_rejects_new(pair, case):
    """``drain()`` lets in-flight streams finish in full (also a max-length
    prompt still in its chunked prefill), then answers 503 with
    ``Retry-After``; no page leaks."""
    if case == "in flight":
        prompts, slots = make_prompts(6, 2), 2
    else:
        prompts, slots = [np.arange(12) % TINY.vocab_size], 1

    async def main():
        cb, srv = await serve("port", pair, 0, num_slots=slots, faults=STALL)
        tasks = [asyncio.ensure_future(
            TSV.stream_generate(HOST, srv.port, p, 10)) for p in prompts]
        await _poll(srv, lambda h: h["active_slots"] + h["queued"]
                    >= len(prompts))
        await srv.drain()
        rets = await asyncio.gather(*tasks)
        code, obj, hdrs = await JSV.request_json(
            HOST, srv.port, "POST", "/v1/generate",
            {"prompt": [1, 2], "max_new": 2}, return_headers=True)
        await srv.aclose()
        return cb, rets, code, obj, hdrs, srv.stats()

    cb, rets, code, obj, hdrs, stats = asyncio.run(main())
    for r in rets:
        assert r["status"] == 200 and len(r["ids"]) == 10
        assert r["final"]["cancelled"] is False
    assert code == 503 and "drain" in obj["error"]
    assert float(hdrs["retry-after"]) > 0
    assert stats["draining"] and stats["served"] == len(prompts)
    assert pool_whole(cb)


def test_admission_shed_429_with_retry_after(pair):
    """Queue-depth overload sheds a standard request with 429 and
    ``Retry-After`` while an interactive one is still admitted (the backlog
    is class-aware); the shed shows in ``/v1/health``."""
    prompts = make_prompts(7, 2)
    # stall the engine, not the consumer, so both requests are still in
    # the engine when the shed probe lands
    stall = {"token_stall": {"every": 1, "sleep": 0.1}}

    async def main():
        cb, srv = await serve("port", pair, 0, max_queue=1, faults=stall)
        tasks = [asyncio.ensure_future(
            TSV.stream_generate(HOST, srv.port, prompts[0], 10))]
        await _poll(srv, lambda h: h["active_slots"] >= 1
                    and h["queued"] == 0)
        tasks.append(asyncio.ensure_future(
            TSV.stream_generate(HOST, srv.port, prompts[1], 10)))
        await _poll(srv, lambda h: h["queued"] >= 1)
        code, obj, hdrs = await JSV.request_json(
            HOST, srv.port, "POST", "/v1/generate",
            {"prompt": [1, 2, 3], "max_new": 2, "stream": False},
            return_headers=True)
        shed = await TSV.stream_generate(HOST, srv.port, [1, 2, 3], 2)
        hi = await TSV.stream_generate(HOST, srv.port, [1, 2, 3], 2,
                                       priority="interactive")
        rets = await asyncio.gather(*tasks)
        _, health = await TSV.request_json(HOST, srv.port, "GET",
                                           "/v1/health")
        await srv.aclose()
        return cb, code, obj, hdrs, shed, hi, rets, health

    cb, code, obj, hdrs, shed, hi, rets, health = asyncio.run(main())
    assert code == 429 and "error" in obj
    assert float(hdrs["retry-after"]) > 0
    assert obj["retry_after_s"] == float(hdrs["retry-after"])
    assert shed["status"] == 429 and shed["retry_after"] > 0
    assert hi["status"] == 200 and len(hi["ids"]) == 2
    assert all(r["status"] == 200 for r in rets)
    assert health["shed"] == 2 and pool_whole(cb)


# ---------------------------------------------------------------------------
# Supervision
# ---------------------------------------------------------------------------

def test_supervised_restart_matches_jax(pair):
    """An injected ``engine_crash`` mid-request: the supervisor spills the
    slot, restarts, and the request finishes with the tokens of an
    uninterrupted run, as on JAX's server (same counters)."""
    prompt = make_prompts(8, 1)[0]
    crash = {"engine_crash": {"at": [4]}}

    async def main(side):
        cb, srv = await serve(side, pair, 19, faults=crash)
        try:
            r = await TSV.stream_generate(HOST, srv.port, prompt, 10)
            _, h = await JSV.request_json(HOST, srv.port, "GET",
                                          "/v1/health")
            return r, h, pool_whole(cb)
        finally:
            await srv.aclose()

    (rp, hp, whole), (rj, hj, _) = (asyncio.run(main(s))
                                    for s in ("port", "jax"))
    assert rp["status"] == 200 and rp["ids"] == rj["ids"]
    assert rp["ids"] == direct_step_loop(pair, [prompt], 10, 19)[0]
    for k in ("engine_crashes", "engine_restarts", "preemptions",
              "restores"):
        assert hp[k] == hj[k] == 1, k
    assert rp["final"]["preempted"] == 1 and hp["engine_alive"] and whole


def test_supervisor_gives_up_past_max_restarts(pair):
    """A crash at every step: past ``max_restarts`` every stream ends with
    JAX's ``error`` event, the engine reports dead, a new request gets 503
    ``engine failed``, and the pool is whole."""
    crash = {"engine_crash": {"every": 1}}

    async def main(side):
        cb, srv = await serve(side, pair, 0, faults=crash, max_restarts=2)
        try:
            r = await TSV.stream_generate(HOST, srv.port, [1, 2, 3], 4)
            await asyncio.sleep(0.05)
            _, h = await TSV.request_json(HOST, srv.port, "GET",
                                          "/v1/health")
            after = await JSV.stream_generate(HOST, srv.port, [1, 2], 2)
            return r, h, after, pool_whole(cb)
        finally:
            await srv.aclose()

    port, jax_side = (asyncio.run(main(s)) for s in ("port", "jax"))
    (r, h, after, whole) = port
    assert r["final"] == jax_side[0]["final"]
    assert "engine failed after 3 crashes" in r["final"]["error"]
    assert h["engine_alive"] is False and h["engine_crashes"] == 3
    assert h["engine_restarts"] == 2 and whole
    assert after["status"] == 503 and after["final"]["error"] == (
        "engine failed")


def test_threads_submit_and_cancel_while_the_engine_steps(pair):
    """Eight threads submit and cancel at once while the engine thread
    steps, with the interpreter switching threads every microsecond: every
    request finishes exactly once (served or cancelled) and the pool ends
    whole, so no update of the shared queue or sets was lost."""
    import sys
    import threading
    cb = port_batcher(pair, 0, num_slots=3)
    runner = TSV.EngineRunner(cb)
    done = []
    finish = runner._finish
    runner._finish = lambda req: (done.append(req.rid), finish(req))
    rids = []

    def client(seed):
        rs = np.random.RandomState(seed)
        for _ in range(5):
            rid = cb.submit(rs.randint(0, TINY.vocab_size, size=6), 4)
            rids.append(rid)
            runner.wake()
            if rs.rand() < 0.4:
                runner.cancel(int(rs.choice(rids)))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        runner.start()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        runner.stop(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads + [runner._thread])
    assert sorted(done) == sorted(rids) == list(range(40))
    assert runner.served == 40 and pool_whole(cb)


def test_fatal_fault_ends_the_engine_thread(pair):
    """An exception of ``fatal_types`` (an injected ``worker_die``) ends
    the engine thread at once, as in JAX: no recovery and no abort; the
    request stays in its slot, and ``extract_all`` pops it with its
    partial output for a router to fail over."""
    cb = port_batcher(pair, 0, faults={"worker_die": {"at": [3]}})
    runner = TSV.EngineRunner(cb, fatal_types=(TF.WorkerDied,))
    rid = cb.submit([1, 2, 3], 12)
    runner.start()
    runner._thread.join(30)
    assert not runner._thread.is_alive() and runner.died
    assert (runner.crashes, runner.restarts, runner.gave_up) == (1, 0, False)
    assert cb.preemptions == 0 and cb.active.any()
    (req,) = cb.extract_all()
    assert req.rid == rid and req.error is None and len(req.out) == 6
    assert pool_whole(cb)


# ---------------------------------------------------------------------------
# The command lines: saved blocks, refusals
# ---------------------------------------------------------------------------

def _server_args(argv):
    ap = argparse.ArgumentParser()
    TSV.add_server_args(ap)
    return ap.parse_args(argv)


def test_ckpt_dir_serves_jax_saved_blocks(pair, tmp_path):
    """Blocks saved by JAX (``block_XX.npz``) load through ``--ckpt-dir``
    into both serving CLIs' models: the port's serve CLI (``load_model``,
    then ``generate``) and its server CLI (``build_batcher_from_args``,
    then HTTP) give the greedy fp32 tokens of JAX's serve CLI path
    (``load_blocks``, then ``generate``) under the same key."""
    from repro.checkpoint import load_blocks, save_block
    from repro.core import DiffusionBlocksModel as JDBM
    from test_torch_serve import models as make
    cfg = JC.reduced(JC.get_config("stablelm-1.6b"))
    jdbm, trained, _, _ = make(cfg, blocks=2, seed=4)
    for b, (start, size) in enumerate(jdbm.ranges):
        save_block(str(tmp_path), trained, b, start, size)
    argv = ["--device", "cpu", "--ckpt-dir", str(tmp_path), "--blocks", "2",
            "--prompt-len", "12", "--max-new", "6", "--num-slots", "1",
            "--seg-len", "3", "--page-size", "4", "--chunk-size", "4",
            "--precision", "fp32"]
    prompt = np.random.RandomState(9).randint(0, cfg.vocab_size, size=9)

    jdbm = JDBM(cfg, JC.DBConfig(num_blocks=2, overlap_gamma=0.1))
    jparams = load_blocks(str(tmp_path), jdbm.init(jax.random.PRNGKey(0)),
                          jdbm.ranges)
    want = np.asarray(JS.generate(
        jdbm, jparams, prompt[None].astype(np.int32), 6,
        rng=jax.random.PRNGKey(7), precision="fp32", page_size=4,
        chunk_size=4))[0, 9:].tolist()

    args = _server_args(argv)
    _, dbm, params, _ = TS.load_model(args, torch.device("cpu"))
    z, _ = JaxDraws(7, 1, cfg, dbm.db.sigma_max)(6)
    got = TS.generate(dbm, params, prompt[None], 6, precision="fp32",
                      page_size=4, chunk_size=4, z0=z)[0, 9:].tolist()
    assert got == want

    _, _, cb, _ = TSV.build_batcher_from_args(args)
    cb.draw_segment = JaxDraws(7, 1, cfg, dbm.db.sigma_max)

    async def main():
        srv = TSV.InferenceServer(cb)
        await srv.start()
        try:
            return await TSV.stream_generate(HOST, srv.port, prompt, 6)
        finally:
            await srv.aclose()

    assert asyncio.run(main())["ids"] == want


@pytest.mark.parametrize("flags,item", [(["--disagg", "--conditioned"],
                                         "A6"),
                                        (["--conditioned"], "A6")])
def test_server_cli_refuses_what_is_not_ported(flags, item):
    """``--conditioned`` (ROADMAP ``item``, now ported): the dense default
    arch takes no aux inputs and exits, as JAX's CLI does; the VLM
    registers ``--cond-pool`` images and serves a request naming one,
    unified and with ``--disagg``."""
    with pytest.raises(SystemExit, match="takes no aux inputs"):
        TSV.build_batcher_from_args(_server_args(["--device", "cpu",
                                                  *flags]))
    args = _server_args(["--device", "cpu", "--arch",
                         "llama-3.2-vision-11b", "--blocks", "1",
                         "--prompt-len", "8", "--max-new", "3",
                         "--num-slots", "2", "--seg-len", "2",
                         "--page-size", "4", "--cond-pool", "2", *flags])
    _, _, cb, registry = TSV.build_batcher_from_args(args)
    assert sorted(registry) == ["cond0", "cond1"]
    assert getattr(cb, "is_router", False) == ("--disagg" in flags)

    async def main():
        srv = TSV.InferenceServer(cb, aux_registry=registry)
        await srv.start()
        try:
            return await asyncio.wait_for(TSV.stream_generate(
                HOST, srv.port, [1, 2, 3, 4, 5], 3, aux="cond1"), 60)
        finally:
            await srv.aclose()

    got = asyncio.run(main())
    assert got["status"] == 200 and len(got["ids"]) == 3, got


def test_server_cli_serves_on_cpu(capsys):
    """``_serve_forever`` (the CLI's loop) serves a request on the CPU and
    drains when cancelled."""
    args = _server_args(["--device", "cpu", "--prompt-len", "8",
                         "--max-new", "4", "--num-slots", "2",
                         "--prefix-cache"])
    args.host, args.port = HOST, 0

    async def main():
        task = asyncio.ensure_future(TSV._serve_forever(args))
        for _ in range(2000):
            out = capsys.readouterr().out
            if "serving on" in out:
                break
            await asyncio.sleep(0.005)
        port = int(out.split("serving on http://")[1].split()[0]
                   .rsplit(":", 1)[1])
        r = await TSV.stream_generate(HOST, port, [1, 2, 3], 4)
        task.cancel()
        await asyncio.gather(task, return_exceptions=True)
        return r

    r = asyncio.run(main())
    assert r["status"] == 200 and len(r["ids"]) == 4
    assert "drained; bye" in capsys.readouterr().out
