"""Asyncio HTTP front end (port of ``repro.frontend.http``: the same
routes, status codes, JSON bodies and SSE events) — stdlib only.

A deliberately small HTTP/1.1 server over ``asyncio.start_server`` (no
web-framework dependency; the repo's environment pins against new
packages), serving four routes:

- ``POST /v1/generate`` — JSON in, JSON out (blocks until the request is
  terminal);
- ``POST /v1/stream``   — Server-Sent Events: one ``token`` event per
  generated token (the `StreamEvent` fields), then one ``end`` event;
- ``GET /metrics``      — Prometheus text from the engine's metrics registry
  (per-tenant goodput/latency families included);
- ``GET /healthz``      — liveness + draining state.

Request body for the generate/stream routes::

    {"prompt": [1, 2, 3],          # token ids (models are token-level)
     "max_new_tokens": 16,         # optional
     "eos_id": null,               # optional
     "tenant": "acme",             # optional (default "default")
     "priority": 1,                # optional class index (0 most urgent)
     "deadline_s": 2.5}            # optional wall-clock budget

Every handler is a thin adapter over `EngineLoop`: submissions land on the
engine thread's inbox, progress comes back through an `asyncio.Queue` fed
via ``loop.call_soon_threadsafe`` — the event loop never blocks on the
engine (even ``/metrics`` rendering runs through an executor, since it
waits for the engine thread to service the ask between decode ticks).
A client disconnect mid-stream cancels the request, releasing its batch
row and pool blocks immediately.  The handlers never touch torch: prompts
stay Python lists here and become numpy ``int32`` in `EngineLoop.submit`,
and every answer that reads the engine comes from the engine thread.
"""
from __future__ import annotations

import asyncio
import json
from typing import Optional, Tuple

from repro_torch.frontend.bridge import EngineLoop
from repro_torch.frontend.config import FrontendConfig

_MAX_BODY = 8 * 1024 * 1024
# terminal reasons → HTTP status for the non-streaming route
_REJECT_STATUS = {
    "draining": 503,
    "tenant_backlog_full": 429,
    "engine_full": 429,
    "slo_blown": 429,
    "deadline_exceeded": 429,
    "cancelled": 499,  # nginx's client-closed-request; best available fit
}


def _status_line(code: int) -> str:
    names = {200: "OK", 400: "Bad Request", 404: "Not Found",
             405: "Method Not Allowed", 408: "Request Timeout",
             413: "Payload Too Large", 422: "Unprocessable Entity",
             429: "Too Many Requests", 499: "Client Closed Request",
             500: "Internal Server Error", 503: "Service Unavailable"}
    return f"HTTP/1.1 {code} {names.get(code, 'Unknown')}\r\n"


class FrontendServer:
    """One engine behind one listening socket; see module docstring."""

    def __init__(self, engine, cfg: Optional[FrontendConfig] = None):
        self.engine_loop = EngineLoop(engine, cfg)
        self.cfg = self.engine_loop.cfg
        # prompt ids are checked against it at the door: the embedding
        # lookup of an id past the vocabulary raises in the engine thread
        # (ROADMAP C.8)
        self.vocab_size = engine.cfg.model.vocab_size
        self._server: Optional[asyncio.AbstractServer] = None
        self.host = self.cfg.host
        self.port = self.cfg.port  # rebound to the real port on start

    # ---- lifecycle ---------------------------------------------------------

    async def start(self) -> None:
        """Warm the engine up and start its loop thread (`EngineLoop.start`),
        then listen; ``port`` 0 binds a free port (read it back from
        ``self.port``)."""
        self.engine_loop.start()
        self._server = await asyncio.start_server(
            self._handle, self.cfg.host, self.cfg.port)
        sock = self._server.sockets[0]
        self.host, self.port = sock.getsockname()[:2]

    async def serve_forever(self) -> None:
        assert self._server is not None, "call start() first"
        async with self._server:
            await self._server.serve_forever()

    async def shutdown(self, drain: bool = True) -> None:
        """Graceful stop: close the listener, drain the engine (finish live
        decodes, shed the queue), stop the loop thread.

        The drain starts before the wait for open connections: since Python
        3.12.1 ``Server.wait_closed`` waits until every connection has
        closed, so waiting first would serve each queued request to its end
        instead of shedding it (the reference's order, ROADMAP C.8)."""
        if self._server is not None:
            self._server.close()
        if drain:
            loop = asyncio.get_running_loop()
            await loop.run_in_executor(
                None, self.engine_loop.drain, self.cfg.drain_timeout_s)
        if self._server is not None:
            await self._server.wait_closed()
        self.engine_loop.stop()

    # ---- HTTP plumbing -----------------------------------------------------

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            parsed = await self._read_request(reader)
            if parsed is None:
                return
            method, path, body = parsed
            await self._route(method, path, body, writer)
        except (ConnectionError, asyncio.IncompleteReadError):
            pass  # client went away; request-level cancel already handled
        except Exception as e:  # a handler bug must not kill the server
            try:
                self._send_json(writer, 500, {"error": repr(e)})
            except ConnectionError:
                pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except ConnectionError:
                pass

    async def _read_request(
            self, reader: asyncio.StreamReader
    ) -> Optional[Tuple[str, str, bytes]]:
        line = await reader.readline()
        if not line:
            return None
        parts = line.decode("latin-1").split()
        if len(parts) < 2:
            return None
        method, path = parts[0].upper(), parts[1]
        headers = {}
        while True:
            h = await reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            k, _, v = h.decode("latin-1").partition(":")
            headers[k.strip().lower()] = v.strip()
        n = int(headers.get("content-length", "0") or 0)
        if n > _MAX_BODY:
            raise ValueError("body too large")
        body = await reader.readexactly(n) if n else b""
        return method, path, body

    def _send(self, writer: asyncio.StreamWriter, code: int, body: bytes,
              ctype: str) -> None:
        writer.write(
            (_status_line(code)
             + f"Content-Type: {ctype}\r\n"
             + f"Content-Length: {len(body)}\r\n"
             + "Connection: close\r\n\r\n").encode("latin-1") + body)

    def _send_json(self, writer, code: int, payload: dict) -> None:
        self._send(writer, code, json.dumps(payload).encode(),
                   "application/json")

    # ---- routing -----------------------------------------------------------

    async def _route(self, method: str, path: str, body: bytes,
                     writer: asyncio.StreamWriter) -> None:
        if path == "/healthz" and method == "GET":
            err = self.engine_loop.error
            self._send_json(writer, 200 if err is None else 500, {
                "status": ("error" if err is not None else
                           "draining" if self.engine_loop.draining else "ok"),
                "error": repr(err) if err is not None else None})
        elif path == "/metrics" and method == "GET":
            loop = asyncio.get_running_loop()
            text = await loop.run_in_executor(
                None, self.engine_loop.prometheus)
            self._send(writer, 200, text.encode(),
                       "text/plain; version=0.0.4")
        elif path == "/v1/generate" and method == "POST":
            await self._generate(body, writer, stream=False)
        elif path == "/v1/stream" and method == "POST":
            await self._generate(body, writer, stream=True)
        elif path in ("/healthz", "/metrics", "/v1/generate", "/v1/stream"):
            self._send_json(writer, 405, {"error": f"{method} not allowed"})
        else:
            self._send_json(writer, 404, {"error": f"no route {path}"})

    # ---- generate / stream -------------------------------------------------

    def _parse_generate(self, body: bytes) -> dict:
        try:
            payload = json.loads(body.decode() or "{}")
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            raise ValueError(f"invalid JSON body: {e}") from e
        prompt = payload.get("prompt")
        if (not isinstance(prompt, list) or not prompt
                or not all(isinstance(t, int) and t >= 0 for t in prompt)):
            raise ValueError(
                "'prompt' must be a non-empty list of token ids")
        if max(prompt) >= self.vocab_size:
            raise ValueError(
                f"token id {max(prompt)} out of range for the model's "
                f"vocabulary of {self.vocab_size}")
        if self.cfg.max_prompt_tokens and (
                len(prompt) > self.cfg.max_prompt_tokens):
            raise ValueError(
                f"prompt too long ({len(prompt)} tokens > "
                f"{self.cfg.max_prompt_tokens})")
        mnt = int(payload.get("max_new_tokens", 16))
        if mnt < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if self.cfg.max_new_tokens_cap:
            mnt = min(mnt, self.cfg.max_new_tokens_cap)
        eos = payload.get("eos_id")
        deadline = payload.get("deadline_s")
        return {
            "prompt": prompt, "max_new_tokens": mnt,
            "eos_id": None if eos is None else int(eos),
            "tenant": str(payload.get("tenant", "default")) or "default",
            "priority": int(payload.get("priority", 1)),
            "deadline_s": None if deadline is None else float(deadline)}

    async def _generate(self, body: bytes, writer: asyncio.StreamWriter,
                        stream: bool) -> None:
        try:
            kw = self._parse_generate(body)
        except ValueError as e:
            self._send_json(writer, 400, {"error": str(e)})
            return
        if self.engine_loop.error is not None:  # nothing would ever answer
            self._send_json(writer, 500, {"error": repr(self.engine_loop.error)})
            return
        if self.engine_loop.draining:
            self._send_json(writer, 503, {"error": "draining"})
            return
        loop = asyncio.get_running_loop()
        events: "asyncio.Queue[dict]" = asyncio.Queue()
        req = self.engine_loop.submit(
            kw.pop("prompt"), **kw,
            deliver=lambda ev: loop.call_soon_threadsafe(
                events.put_nowait, ev))
        try:
            if stream:
                await self._pump_sse(req, events, writer)
            else:
                await self._pump_json(req, events, writer)
        except (asyncio.CancelledError, ConnectionError):
            # client went away mid-request: release the row/blocks now
            self.engine_loop.cancel(req.req_id)
            raise

    async def _pump_json(self, req, events: "asyncio.Queue",
                         writer: asyncio.StreamWriter) -> None:
        while True:
            ev = await events.get()
            if ev["type"] != "end":
                continue
            if ev["state"] == "finished":
                code = 200
            elif ev["state"] == "error":
                code = 500
            else:
                code = _REJECT_STATUS.get(ev["reason"], 422)
            self._send_json(writer, code, {
                "req_id": ev["req_id"], "state": ev["state"],
                "reason": ev["reason"], "tokens": ev["tokens"],
                "n_generated": ev["n_generated"],
                "degraded_from": ev["degraded_from"],
                "tenant": req.tenant, "priority": req.priority})
            return

    async def _pump_sse(self, req, events: "asyncio.Queue",
                        writer: asyncio.StreamWriter) -> None:
        writer.write(
            (_status_line(200)
             + "Content-Type: text/event-stream\r\n"
             + "Cache-Control: no-cache\r\n"
             + "Connection: close\r\n\r\n").encode("latin-1"))
        await writer.drain()
        while True:
            ev = await events.get()
            writer.write(
                (f"event: {ev['type']}\n"
                 f"data: {json.dumps(ev)}\n\n").encode())
            # drain() surfaces a torn connection so the except-path in
            # _generate cancels the request instead of decoding to a ghost
            await writer.drain()
            if ev["type"] == "end":
                return


async def serve_http(engine, cfg: Optional[FrontendConfig] = None,
                     install_signals: bool = True) -> FrontendServer:
    """Start the server (returned running; caller owns `serve_forever` /
    `shutdown`).  With ``install_signals``, SIGINT/SIGTERM trigger a
    graceful drain-and-stop instead of killing mid-decode."""
    server = FrontendServer(engine, cfg)
    await server.start()
    if install_signals:
        import signal

        loop = asyncio.get_running_loop()

        def _graceful() -> None:
            asyncio.ensure_future(server.shutdown(drain=True))

        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                loop.add_signal_handler(sig, _graceful)
            except (NotImplementedError, RuntimeError):
                pass  # platform without loop signal support
    return server
