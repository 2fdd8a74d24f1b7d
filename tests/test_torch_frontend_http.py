"""The port's HTTP front end (`repro_torch.frontend.http`) on the CPU: an
in-process `FrontendServer` on a free port, driven by a raw asyncio client.

- the reference's cases (`tests/test_frontend_http.py`) on the port: JSON
  generate and the SSE stream against `Engine.stream` (contiguous indices,
  ``finished`` on the last token, one ``end`` event last), the /metrics
  tenant-label contract, input validation and routing, the ``end`` event
  of a request refused at submit, drain refusing new work;
- the tokens over HTTP equal the JAX engine's for the same weights;
- a client that closes its SSE connection mid-stream cancels its request:
  its blocks go back to the pool, the other requests end normally, and
  the pool ends empty; /metrics then has every front-end family;
- shutdown with drain sheds the queued requests and lets the live row
  decode to the end; the reference serves its queued requests to the end
  first (ROADMAP C.8), shown on both packages;
- `EngineLoop.start` warms the engine up before its thread exists.
"""
import asyncio
import json
import queue as pyqueue
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.api import CompressionConfig as JCompression
from repro.api import Engine as JEngine
from repro.api import EngineConfig as JEngineConfig
from repro.api import PlannerConfig as JPlanner
from repro.api import Request as JRequest
from repro.api import SchedulerConfig as JScheduler
from repro.frontend import FrontendConfig as JFrontendConfig
from repro.frontend import FrontendServer as JFrontendServer
from repro_torch import interop
from repro_torch.api import (CompressionConfig, Engine, EngineConfig, PlannerConfig, Request,
                             SchedulerConfig)
from repro_torch.frontend import FrontendConfig, FrontendServer
from repro_torch.frontend.bridge import EngineLoop

torch.set_num_threads(2)

ARCH = "minitron-8b"
PROMPT = [5, 17, 42, 99, 7, 123, 56, 201, 11, 88]
GEN = 6
FAMILIES = ("slo_attained_total", "slo_missed_total", "goodput_tokens_total",
            "frontend_ttft_steps_bucket", "frontend_itl_seconds_bucket",
            "frontend_admission_total", "frontend_rejections_total")


def configs(rows=2, backend="slot", max_seq_len=48):
    """(JAX config, port config): the reference's `_cfg` in both packages."""
    comp = dict(policy="ada_snapkv", budget=12, alpha_max=2.0, obs_window=8, sink=2,
                decode_margin=8)
    j = JEngineConfig.smoke(
        ARCH, n_shards=4, max_seq_len=max_seq_len, compression=JCompression(**comp),
        planner=JPlanner(mode="fairkv_dp", extra_copies=4, batch_cap=rows),
        scheduler=JScheduler(max_rows=rows, enable_replan=False), cache_backend=backend)
    t = EngineConfig.smoke(
        ARCH, device="cpu", n_shards=4, max_seq_len=max_seq_len,
        compression=CompressionConfig(**comp),
        planner=PlannerConfig(mode="fairkv_dp", extra_copies=4, batch_cap=rows),
        scheduler=SchedulerConfig(max_rows=rows, enable_replan=False), cache_backend=backend)
    return j, t


@pytest.fixture(scope="module")
def params():
    jparams = JEngine.build(configs()[0]).params
    return jparams, interop.to_torch(jax.tree.map(np.asarray, jparams))


def _engine(params, **kw):
    return Engine.build(configs(**kw)[1], params=params[1])


def _slow_ticks(sched, seconds):
    """Stretch every scheduler tick by ``seconds`` (a test's window to act
    while requests are live)."""
    step = sched.step

    def slow():
        time.sleep(seconds)
        return step()

    sched.step = slow


# ---------------------------------------------------------------------------
# raw asyncio HTTP client
# ---------------------------------------------------------------------------


async def _request(host, port, method, path, payload=None, raw_body=None):
    """One HTTP/1.1 exchange; (status, headers, body bytes)."""
    reader, writer = await asyncio.open_connection(host, port)
    body = (raw_body if raw_body is not None
            else b"" if payload is None else json.dumps(payload).encode())
    writer.write((f"{method} {path} HTTP/1.1\r\nHost: t\r\n"
                  f"Content-Type: application/json\r\n"
                  f"Content-Length: {len(body)}\r\n\r\n").encode() + body)
    await writer.drain()
    status = int((await reader.readline()).split()[1])
    headers = {}
    while True:
        h = await reader.readline()
        if h in (b"\r\n", b"\n", b""):
            break
        k, _, v = h.decode("latin-1").partition(":")
        headers[k.strip().lower()] = v.strip()
    data = await reader.read()
    writer.close()
    try:
        await writer.wait_closed()
    except ConnectionError:
        pass
    return status, headers, data


def _parse_sse(raw: bytes):
    events = []
    for block in raw.decode().strip().split("\n\n"):
        lines = block.split("\n")
        assert lines[0].startswith("event: ") and lines[1].startswith("data: "), lines
        events.append((lines[0][len("event: "):], json.loads(lines[1][len("data: "):])))
    return events


async def _sse_events(host, port, payload, close_after=None):
    """Open an SSE stream and read its events; with ``close_after`` close
    the connection after that many token events.  Returns the events."""
    reader, writer = await asyncio.open_connection(host, port)
    body = json.dumps(payload).encode()
    writer.write((f"POST /v1/stream HTTP/1.1\r\nHost: t\r\nContent-Length: {len(body)}"
                  f"\r\n\r\n").encode() + body)
    await writer.drain()
    assert int((await reader.readline()).split()[1]) == 200
    while (await reader.readline()) not in (b"\r\n", b""):
        pass
    events = []
    while True:
        block = await reader.readuntil(b"\n\n")
        lines = block.decode().strip().split("\n")
        events.append((lines[0][len("event: "):], json.loads(lines[1][len("data: "):])))
        n_tok = sum(k == "token" for k, _ in events)
        if events[-1][0] == "end" or (close_after is not None and n_tok >= close_after):
            break
    writer.close()
    try:
        await writer.wait_closed()
    except ConnectionError:
        pass
    return events


async def _until(cond, timeout=30.0):
    """Poll ``cond`` (a read of the engine's state) until it holds; fails
    after ``timeout`` seconds instead of hanging."""
    async def poll():
        while not cond():
            await asyncio.sleep(0.002)
    await asyncio.wait_for(poll(), timeout)


async def _with_server(engine, body, **cfg_kw):
    cfg_kw.setdefault("port", 0)
    server = FrontendServer(engine, FrontendConfig(**cfg_kw))
    await server.start()
    try:
        return await body(server)
    finally:
        await server.shutdown(drain=True)


# ---------------------------------------------------------------------------
# the reference's cases, on the port
# ---------------------------------------------------------------------------


def test_http_generate_then_stream_matches_engine_stream(params):
    ref_eng = _engine(params)
    ref_events = list(ref_eng.stream([Request(
        req_id=0, prompt=np.asarray(PROMPT, np.int32), max_new_tokens=GEN)]))
    ref_tokens = [e.token for e in ref_events]
    assert [e.index for e in ref_events] == list(range(len(ref_tokens)))
    assert [e.finished for e in ref_events] == [False] * (len(ref_events) - 1) + [True]

    async def body(server):
        payload = {"prompt": PROMPT, "max_new_tokens": GEN, "tenant": "acme", "priority": 0}
        status, _, data = await asyncio.wait_for(
            _request(server.host, server.port, "POST", "/v1/generate", payload), timeout=120)
        assert status == 200
        out = json.loads(data)
        assert out["state"] == "finished" and out["tokens"] == ref_tokens
        assert out["tenant"] == "acme" and out["priority"] == 0
        status, headers, raw = await asyncio.wait_for(
            _request(server.host, server.port, "POST", "/v1/stream", payload), timeout=120)
        assert status == 200
        assert headers["content-type"].startswith("text/event-stream")
        events = _parse_sse(raw)
        assert [k for k, _ in events] == ["token"] * len(ref_tokens) + ["end"]
        tokens = [ev for k, ev in events if k == "token"]
        assert [ev["token"] for ev in tokens] == ref_tokens
        assert [ev["index"] for ev in tokens] == list(range(len(ref_tokens)))
        assert [ev["finished"] for ev in tokens] == [False] * (len(tokens) - 1) + [True]
        end = events[-1][1]
        assert end["state"] == "finished" and end["tokens"] == ref_tokens
        status, _, prom = await asyncio.wait_for(
            _request(server.host, server.port, "GET", "/metrics"), timeout=30)
        assert status == 200
        text = prom.decode()
        for family in ("slo_attained_total", "goodput_tokens_total",
                       "frontend_ttft_steps_bucket", "frontend_admission_total"):
            assert f"{family}{{" in text, family
        assert 'tenant="acme"' in text
        status, _, health = await _request(server.host, server.port, "GET", "/healthz")
        assert status == 200 and json.loads(health)["status"] == "ok"

    asyncio.run(_with_server(_engine(params), body))


def test_http_validation_and_routing(params):
    async def body(server):
        h, p = server.host, server.port
        status, _, data = await _request(h, p, "POST", "/v1/generate", raw_body=b"{not json")
        assert status == 400 and b"invalid JSON" in data
        status, _, data = await _request(h, p, "POST", "/v1/generate", {"prompt": []})
        assert status == 400 and b"prompt" in data
        status, _, _ = await _request(h, p, "POST", "/v1/generate", {"prompt": [1, -2]})
        assert status == 400
        status, _, data = await _request(h, p, "POST", "/v1/generate",
                                         {"prompt": [1, 2, 3], "max_new_tokens": 0})
        assert status == 400 and b"max_new_tokens" in data
        status, _, data = await _request(h, p, "POST", "/v1/generate", {"prompt": [1] * 9})
        assert status == 400 and b"too long" in data
        # the port's own check (ROADMAP C.8): an id past the vocabulary
        status, _, data = await _request(h, p, "POST", "/v1/generate", {"prompt": [1, 256]})
        assert status == 400 and b"out of range" in data
        status, _, _ = await _request(h, p, "GET", "/nope")
        assert status == 404
        status, _, _ = await _request(h, p, "GET", "/v1/generate")
        assert status == 405

    asyncio.run(_with_server(_engine(params), body, max_prompt_tokens=8))


def test_engine_loop_emits_end_for_terminal_at_submit(params):
    loop = EngineLoop(_engine(params)).start()
    try:
        assert loop.drain(timeout=30.0)
        out = pyqueue.SimpleQueue()
        loop.submit(PROMPT, max_new_tokens=2, deliver=out.put)
        ev = out.get(timeout=10.0)
        assert ev["type"] == "end"
        assert ev["state"] == "cancelled" and ev["reason"] == "draining"
        assert ev["tokens"] == [] and ev["n_generated"] == 0
    finally:
        loop.stop()
    assert not loop._thread.is_alive()


def test_http_drain_refuses_new_work(params):
    async def body(server):
        loop = asyncio.get_running_loop()
        assert await loop.run_in_executor(None, server.engine_loop.drain, 30.0)
        status, _, data = await _request(server.host, server.port, "POST", "/v1/generate",
                                         {"prompt": PROMPT, "max_new_tokens": 2})
        assert status == 503 and b"draining" in data
        status, _, health = await _request(server.host, server.port, "GET", "/healthz")
        assert status == 200 and json.loads(health)["status"] == "draining"

    asyncio.run(_with_server(_engine(params), body))


# ---------------------------------------------------------------------------
# the port against the reference, and the port's own guarantees
# ---------------------------------------------------------------------------


def test_http_tokens_match_reference_engine(params):
    """Three prompts, one at a time over SSE, three tenants: each gives the
    JAX engine's `Engine.stream` tokens for the same weights."""
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, 250, size=n).tolist() for n in (9, 14, 20)]
    jeng = JEngine.build(configs()[0], params=params[0])
    ref = [[e.token for e in jeng.stream([JRequest(
        req_id=i, prompt=np.asarray(p, np.int32), max_new_tokens=GEN)])]
        for i, p in enumerate(prompts)]

    async def body(server):
        got = []
        for p, tenant in zip(prompts, ("a", "b", "c")):
            events = await asyncio.wait_for(_sse_events(
                server.host, server.port,
                {"prompt": p, "max_new_tokens": GEN, "tenant": tenant}), timeout=120)
            got.append([ev["token"] for k, ev in events if k == "token"])
            assert events[-1][1]["tokens"] == got[-1]
        return got

    assert asyncio.run(_with_server(_engine(params), body)) == ref


def test_client_disconnect_cancels_and_frees_blocks(params):
    """Paged pools, two rows.  Five concurrent SSE clients over three
    tenants, one of which closes after its third token: that request is
    cancelled (fewer tokens than asked) and every other one finishes with
    all its tokens.  Then three more, and a drain while one of them is
    still queued: the queued one is shed (``draining``), the live ones
    finish, a request sent after the drain began gets 503.  The pool ends
    empty and /metrics has every front-end family."""
    eng = _engine(params, backend="paged", max_seq_len=96)
    rng = np.random.default_rng(9)
    asks = [dict(prompt=rng.integers(1, 250, size=12 + 2 * i).tolist(),
                 max_new_tokens=40 if i == 0 else 8, tenant="abc"[i % 3], priority=i % 3)
            for i in range(8)]
    for a in asks[5:]:
        a["max_new_tokens"] = 16

    async def body(server):
        fe = server.engine_loop.fe
        _slow_ticks(fe.sched, 0.02)
        first = [asyncio.create_task(_sse_events(server.host, server.port, a,
                                                 close_after=3 if i == 0 else None))
                 for i, a in enumerate(asks[:5])]
        results = await asyncio.wait_for(asyncio.gather(*first), timeout=120)
        second = [asyncio.create_task(_sse_events(server.host, server.port, a))
                  for a in asks[5:]]
        await _until(lambda: len(fe.sched.active) == 2 and len(fe.queue) == 1)
        drained = asyncio.get_running_loop().run_in_executor(
            None, server.engine_loop.drain, 60.0)
        await _until(lambda: server.engine_loop.draining)
        status, _, _ = await _request(server.host, server.port, "POST", "/v1/generate",
                                      {"prompt": PROMPT, "max_new_tokens": 2})
        assert status == 503
        assert await drained
        results += await asyncio.wait_for(asyncio.gather(*second), timeout=120)
        _, _, prom = await _request(server.host, server.port, "GET", "/metrics")
        return results, prom.decode()

    server = FrontendServer(eng, FrontendConfig(port=0))

    async def run():
        await server.start()
        try:
            return await body(server)
        finally:
            await server.shutdown(drain=True)

    results, prom = asyncio.run(run())
    cut = results[0]
    assert [k for k, _ in cut] == ["token"] * 3
    rid = cut[0][1]["req_id"]
    for events, a in zip(results[1:5], asks[1:5]):
        assert events[-1][1]["state"] == "finished"
        assert len([k for k, _ in events if k == "token"]) == a["max_new_tokens"]
    ends = sorted((ev[-1][1]["state"], ev[-1][1]["reason"]) for ev in results[5:])
    assert ends == [("cancelled", "draining"), ("finished", ""), ("finished", "")]
    fe = server.engine_loop.fe
    victim = next(r for r in fe.finished if r.req_id == rid)
    assert victim.cancelled and victim.n_generated < 40
    assert fe.sched.n_cancellations == 1
    pool = fe.sched.backend.pool
    pool.check_invariants()
    assert pool.blocks_in_use() == 0
    for fam in FAMILIES:
        assert f"{fam}{{" in prom, fam
    for ln in prom.splitlines():
        if not ln.startswith("#"):
            float(ln.rsplit(" ", 1)[1])


async def _shutdown_with_queue(server, asks):
    """Two JSON requests on one row: the second waits in the queue while the
    first decodes; shutdown(drain=True) starts once the first streams."""
    live = asyncio.create_task(_sse_events(server.host, server.port, asks[0]))
    await asyncio.sleep(0)
    queued = asyncio.create_task(_request(server.host, server.port, "POST", "/v1/generate",
                                          asks[1]))
    fe = server.engine_loop.fe
    await _until(lambda: fe.sched.active and len(fe.queue) == 1)
    await asyncio.wait_for(server.shutdown(drain=True), timeout=120)
    return await live, await queued


@pytest.mark.parametrize("package", ["port", "reference"])
def test_shutdown_sheds_queued_requests(params, package):
    """ROADMAP C.8: the port's shutdown drains before it waits for open
    connections, so the queued request is shed with 503 ``draining`` and
    the live row decodes to the end.  The reference waits for every
    connection first (``Server.wait_closed`` since Python 3.12.1), so it
    serves the queued request to the end before its drain begins."""
    rng = np.random.default_rng(12)
    asks = [dict(prompt=rng.integers(1, 250, size=11).tolist(), max_new_tokens=12,
                 tenant="a"),
            dict(prompt=rng.integers(1, 250, size=13).tolist(), max_new_tokens=4,
                 tenant="b")]
    jcfg, tcfg = configs(rows=1)
    if package == "port":
        eng = Engine.build(tcfg, params=params[1])
        server = FrontendServer(eng, FrontendConfig(port=0))
    else:
        eng = JEngine.build(jcfg, params=params[0])
        server = JFrontendServer(eng, JFrontendConfig(port=0))

    async def run():
        await server.start()
        _slow_ticks(server.engine_loop.fe.sched, 0.02)
        return await _shutdown_with_queue(server, asks)

    live, (status, _, data) = asyncio.run(run())
    assert live[-1][1]["state"] == "finished" and len(live) == 13
    out = json.loads(data)
    if package == "port":
        assert status == 503 and out["reason"] == "draining" and out["tokens"] == []
    else:
        assert status == 200 and out["state"] == "finished" and len(out["tokens"]) == 4
    assert not server.engine_loop._thread.is_alive()


def test_engine_loop_warms_up_before_its_thread(params):
    """`EngineLoop.start` runs `Engine.warmup` in the caller's thread while
    no loop thread exists (a CUDA-graph capture must see no other thread's
    CUDA calls), and the loop drives the engine's own scheduler."""
    eng = _engine(params)
    loop = EngineLoop(eng)
    seen = []
    warmup = eng.warmup

    def spy():
        seen.append((threading.current_thread() is threading.main_thread(), loop._thread))
        warmup()

    eng.warmup = spy
    loop.start()
    try:
        assert seen == [(True, None)]
        assert loop.fe.sched is eng.scheduler
        out = pyqueue.SimpleQueue()
        loop.submit(PROMPT, max_new_tokens=3, deliver=out.put)
        events = [out.get(timeout=30.0) for _ in range(4)]
        assert [e["type"] for e in events] == ["token"] * 3 + ["end"]
    finally:
        loop.stop()


@pytest.mark.parametrize("package", ["port", "reference"])
def test_prompt_ids_past_the_vocabulary(params, package):
    """ROADMAP C.8: a prompt id at or past the vocabulary (256 at smoke
    size).  The reference serves it (JAX clamps the embedding gather, so
    the id reads another token's row); in the port the lookup would raise
    in the engine thread and end the loop, so the door refuses it with
    400 and the server keeps serving."""
    jcfg, tcfg = configs()
    if package == "port":
        server = FrontendServer(Engine.build(tcfg, params=params[1]), FrontendConfig(port=0))
    else:
        server = JFrontendServer(JEngine.build(jcfg, params=params[0]),
                                 JFrontendConfig(port=0))

    async def run():
        await server.start()
        try:
            bad = await _request(server.host, server.port, "POST", "/v1/generate",
                                 {"prompt": [3, 256, 7], "max_new_tokens": 2})
            good = await _request(server.host, server.port, "POST", "/v1/generate",
                                  {"prompt": [3, 255, 7], "max_new_tokens": 2})
            return bad, good
        finally:
            await server.shutdown(drain=True)

    (bad_status, _, bad), (good_status, _, _) = asyncio.run(asyncio.wait_for(run(), 120))
    assert good_status == 200 and server.engine_loop.error is None
    if package == "port":
        assert bad_status == 400 and b"out of range" in bad
    else:
        assert bad_status == 200 and json.loads(bad)["state"] == "finished"
