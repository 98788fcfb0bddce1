"""Multi-tenant asyncio network front end (DESIGN.md Sec. 14) of the port.

One asyncio HTTP/1.1 server multiplexing per-tenant
``IdealemSession``/``StreamCoalescer``/``DecompressionService`` machinery
(``repro_torch.serve.tenancy``) behind typed admission control, with the
wire speaking exactly the ``repro_torch.api`` request/response types the
in-process ``handle()`` calls take -- same validation, same JSON, one
schema.  Routes, status codes, the JSON-lines protocol and the
``repro_frontend_*`` metric families (in the port's registry,
``repro_torch.obs``) are the reference package's, so either package's
client talks to either package's server.

Every tenant's codecs and services run on the front end's ``device``
(default the card; constructing the server raises without a GPU), and
decode services default to ``decode_backend="cuda"`` (the reference's
default is ``"auto"``).  Handlers call the sessions, coalescers and decode
services synchronously, as the reference's do: a direct ``cuda`` feed
ends in a device-to-host copy of its decisions inside the handler.

Protocol: HTTP/1.1 with JSON-lines bodies.  Every request body is one
JSON document per line; every response body is one JSON document per
line, 1:1 with the request lines.  A single-line request behaves like
plain JSON-over-HTTP (status = that document's outcome); a multi-line
``/v1/feed`` body is the streaming ingest form -- each line an
independent ``CompressRequest``, failures carried per line as protocol
error documents while the neighbours proceed.  The tenant is the
``x-tenant`` header.  Routes:

  POST /v1/open     {"stream_id", "config"?: CodecConfig, "coalesce"?: bool}
  POST /v1/feed     CompressRequest            (JSON-lines batchable)
  POST /v1/close    {"stream_id"}           -> final FeedResult
  POST /v1/collect  {"stream_id"}           -> FeedResult (buffered segs)
  POST /v1/attach   {"store_id", "container": b64, "seed"?: int}
  POST /v1/detach   {"store_id"}
  POST /v1/decode   DecodeRangeRequest      -> RangeResult (batched mux)
  GET  /v1/stats    GET /v1/control    GET /metrics    GET /healthz

Admission: quota exhaustion and rate limits answer 429, global
backpressure answers 503 (``Retry-After`` set when known) -- the typed
``repro_torch.errors`` classes carry the mapping, and every rejection
counts in ``repro_frontend_rejections_total{code=...}``.  Backpressure
*feeds* the ``FlushPolicy``: staged coalescer blocks are the policy's
flush pressure, and when the global staged total crosses the server
budget the front end force-flushes the fattest tenants before rejecting
anybody.

Decode requests batch through a per-tenant mux: each wire request stages
into the tenant's ``DecompressionService`` (plan -> gather -> reconstruct
-> emit pipeline, histograms and all) and awaits its answer as an asyncio
future; the policy or the deadline tick cuts the batch.  A request whose
dispatch fails (a store that fails to parse, a ``decode_backend="auto"``
probe that finds a device backend inexact: the port has no host fallback)
gets its exception on its future and answers with its error document.
The control loop (``repro_torch.serve.control``) ticks on the same timer
and broadcasts adapted policies to every tenant.

Byte identity: a direct stream's segments are produced by the tenant's
own ``IdealemSession`` fed exactly the wire chunks, so concatenated
front-end segments equal a direct session's output byte-for-byte -- the
load generator (``python -m repro_torch.launch.loadgen``) and the
golden-corpus integration test pin this.
"""
from __future__ import annotations

import asyncio
import json
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from .. import api, obs
from ..errors import (ApiError, NotFoundError, OverloadedError, ReproError,
                      error_from_payload, error_payload)

from .control import ControlLoop
from .engine import FlushPolicy
from .tenancy import TenantQuota, TenantRegistry

__all__ = ["ServeFrontend", "FrontendClient"]

_MAX_LINE = 16 << 10          # request line / single header cap
_MAX_HEADERS = 64

# ---------------------------------------------------------------- telemetry
_M_REQS = {}


def _m_requests(route: str):
    m = _M_REQS.get(route)
    if m is None:
        m = _M_REQS[route] = obs.registry().counter(
            "repro_frontend_requests_total", "front-end requests by route",
            labels={"route": route})
    return m


_M_LATENCY = {}


def _m_latency(route: str):
    m = _M_LATENCY.get(route)
    if m is None:
        m = _M_LATENCY[route] = obs.registry().histogram(
            "repro_frontend_request_seconds",
            "front-end request wall time by route", labels={"route": route})
    return m


_M_REJECT = {}


def _m_reject(code: str):
    m = _M_REJECT.get(code)
    if m is None:
        m = _M_REJECT[code] = obs.registry().counter(
            "repro_frontend_rejections_total",
            "typed admission/backpressure rejections by protocol code",
            labels={"code": code})
    return m


_M_CONNS = obs.registry().gauge(
    "repro_frontend_open_connections", "live front-end connections")
_M_TENANTS = obs.registry().gauge(
    "repro_frontend_tenants", "tenants the front end has state for")
_M_STAGED = obs.registry().gauge(
    "repro_frontend_staged_blocks",
    "blocks staged across every tenant's coalescer cohorts")
_M_BYTES = {
    d: obs.registry().counter(
        f"repro_frontend_bytes_{d}_total", f"front-end HTTP body bytes {d}")
    for d in ("in", "out")
}
_M_FORCE_FLUSH = obs.registry().counter(
    "repro_frontend_backpressure_flushes_total",
    "cohort flushes forced by global backpressure before rejecting")


class _DecodeMux:
    """Per-tenant bridge between wire decode requests and the batched
    ``DecompressionService``: stage, await the batch, resolve futures."""

    def __init__(self, tenant, loop: asyncio.AbstractEventLoop):
        self.tenant = tenant
        self.loop = loop
        self.futures: Dict[str, asyncio.Future] = {}
        self._seq = 0

    def submit(self, req: api.DecodeRangeRequest) -> asyncio.Future:
        rid = req.request_id
        if not rid:
            self._seq += 1
            rid = f"{self.tenant.id}:{self._seq}"
            req = api.DecodeRangeRequest(req.store_id, req.start_block,
                                         req.stop_block, req.channel, rid)
        if rid in self.futures:
            raise ApiError(f"request_id {rid!r} already pending")
        fut = self.loop.create_future()
        self.futures[rid] = fut
        svc = self.tenant.decomp
        try:
            answers = svc.submit(rid, req.store_id, req.start_block,
                                 req.stop_block, channel=req.channel)
        except Exception:
            self.futures.pop(rid, None)
            raise
        self._settle(svc, answers)
        return fut

    def poll(self) -> None:
        if self.tenant._decomp is None:
            return
        svc = self.tenant.decomp
        self._settle(svc, svc.poll())

    def drain(self) -> None:
        if self.tenant._decomp is None:
            return
        svc = self.tenant.decomp
        self._settle(svc, svc.flush())
        self._settle(svc, svc.drain())

    def _settle(self, svc, answers: Optional[Dict[str, np.ndarray]]) -> None:
        for rid, arr in (answers or {}).items():
            fut = self.futures.pop(rid, None)
            if fut is not None and not fut.done():
                fut.set_result(arr)
        if svc.last_errors:
            for rid in list(svc.last_errors):
                fut = self.futures.pop(rid, None)
                if fut is not None:
                    if not fut.done():
                        fut.set_exception(svc.last_errors.pop(rid))
                    else:
                        svc.last_errors.pop(rid)


class ServeFrontend:
    """The asyncio server; see the module docstring.

    ``clock`` is injectable (deadline flushes and token buckets measure
    with it) and the background timer can be disabled
    (``tick_interval_s=None``) so tests drive :meth:`tick` manually.
    ``device`` is where every tenant's codecs and services run (default
    ``"cuda"``, raising here without a GPU).
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 policy: Optional[FlushPolicy] = None,
                 default_quota: Optional[TenantQuota] = None,
                 quotas: Optional[Dict[str, TenantQuota]] = None,
                 default_config: Optional[api.CodecConfig] = None,
                 control: Optional[ControlLoop] = None,
                 run_control: bool = True,
                 clock: Optional[Callable[[], float]] = None,
                 decode_backend: str = "cuda",
                 device=None,
                 max_staged_blocks_total: Optional[int] = None,
                 tick_interval_s: Optional[float] = 0.005,
                 control_interval_s: float = 0.25,
                 request_timeout_s: float = 30.0,
                 max_body_bytes: int = 64 << 20):
        self.host = host
        self._want_port = port
        self.policy = policy if policy is not None else FlushPolicy(
            max_batch_blocks=1024, max_batch_streams=64, max_age_s=0.01)
        self.default_config = default_config or api.CodecConfig()
        self.tenants = TenantRegistry(
            default_quota=default_quota, quotas=quotas, clock=clock,
            policy=self.policy, decode_backend=decode_backend,
            device=device)
        self.device = self.tenants.device
        self.control = control if control is not None else (
            ControlLoop(policy=self.policy) if run_control else None)
        self._clock = clock if clock is not None else time.monotonic
        self.max_staged_blocks_total = (
            max_staged_blocks_total if max_staged_blocks_total is not None
            else self.policy.max_batch_blocks * 8)
        self.tick_interval_s = tick_interval_s
        self.control_interval_s = control_interval_s
        self.request_timeout_s = request_timeout_s
        self.max_body_bytes = max_body_bytes
        self._server: Optional[asyncio.AbstractServer] = None
        self._ticker_task: Optional[asyncio.Task] = None
        self._muxes: Dict[str, _DecodeMux] = {}
        self._last_control = self._clock()
        self._closed = False

    # -------------------------------------------------------------- lifecycle
    @property
    def port(self) -> int:
        assert self._server is not None, "frontend not started"
        return self._server.sockets[0].getsockname()[1]

    async def start(self) -> "ServeFrontend":
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self._want_port)
        if self.tick_interval_s is not None:
            self._ticker_task = asyncio.get_running_loop().create_task(
                self._ticker())
        return self

    async def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._ticker_task is not None:
            self._ticker_task.cancel()
            try:
                await self._ticker_task
            except asyncio.CancelledError:
                pass
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        for mux in self._muxes.values():
            mux.drain()
        self.tenants.close()

    async def __aenter__(self) -> "ServeFrontend":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.close()

    # ------------------------------------------------------------------ tick
    async def _ticker(self) -> None:
        while True:
            await asyncio.sleep(self.tick_interval_s)
            try:
                self.tick()
            except Exception:  # pragma: no cover - keep the loop alive
                pass

    def tick(self) -> None:
        """One maintenance step: deadline-flush cohorts (the policy's
        ``max_age_s`` trigger), deliver completed decode batches, and --
        on its slower cadence -- run the control loop and broadcast any
        policy change to every tenant."""
        self.tenants.poll_flushes()
        for mux in self._muxes.values():
            mux.poll()
        _M_STAGED.set(self.tenants.staged_blocks)
        _M_TENANTS.set(len(self.tenants.tenants))
        if self.control is not None and (
                self._clock() - self._last_control
                >= self.control_interval_s):
            self._last_control = self._clock()
            decision = self.control.tick()
            if decision.changed:
                self.policy = decision.policy
                self.tenants.set_policy(decision.policy)

    # ------------------------------------------------------------ connection
    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        _M_CONNS.inc()
        try:
            while True:
                try:
                    req = await self._read_request(reader)
                except (asyncio.IncompleteReadError, ConnectionError):
                    break
                if req is None:
                    break
                method, path, headers, body = req
                t0 = time.perf_counter()
                status, ctype, payload, extra = await self._dispatch(
                    method, path, headers, body)
                route = f"{method} {path.split('?')[0]}"
                _m_requests(route).inc()
                _m_latency(route).observe(time.perf_counter() - t0)
                keep = headers.get("connection", "keep-alive") != "close"
                head = [f"HTTP/1.1 {status} {_REASONS.get(status, 'OK')}",
                        f"content-type: {ctype}",
                        f"content-length: {len(payload)}",
                        f"connection: {'keep-alive' if keep else 'close'}"]
                head += [f"{k}: {v}" for k, v in extra]
                writer.write(("\r\n".join(head) + "\r\n\r\n").encode()
                             + payload)
                _M_BYTES["out"].inc(len(payload))
                await writer.drain()
                if not keep:
                    break
        finally:
            _M_CONNS.dec()
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):  # pragma: no cover
                pass

    async def _read_request(self, reader: asyncio.StreamReader):
        line = await reader.readline()
        if not line:
            return None
        if len(line) > _MAX_LINE:
            raise ConnectionError("request line too long")
        try:
            method, path, _version = line.decode("ascii").split()
        except ValueError:
            raise ConnectionError("malformed request line")
        headers: Dict[str, str] = {}
        for _ in range(_MAX_HEADERS):
            h = await reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            if len(h) > _MAX_LINE:
                raise ConnectionError("header too long")
            k, _, v = h.decode("latin-1").partition(":")
            headers[k.strip().lower()] = v.strip()
        else:
            raise ConnectionError("too many headers")
        length = int(headers.get("content-length", "0") or "0")
        if length > self.max_body_bytes:
            raise ConnectionError("body too large")
        body = await reader.readexactly(length) if length else b""
        _M_BYTES["in"].inc(len(body))
        return method.upper(), path, headers, body

    # -------------------------------------------------------------- dispatch
    async def _dispatch(self, method: str, path: str,
                        headers: Dict[str, str], body: bytes
                        ) -> Tuple[int, str, bytes, list]:
        try:
            if method == "GET":
                return self._dispatch_get(path)
            if method != "POST":
                raise ApiError(f"unsupported method {method}")
            if path not in _POST_ROUTES:
                raise NotFoundError(f"no route {path!r}")
            tenant_id = headers.get("x-tenant")
            if not tenant_id:
                raise ApiError("missing x-tenant header")
            lines = [ln for ln in body.split(b"\n") if ln.strip()]
            if not lines:
                raise ApiError("empty request body")
            if len(lines) > 1 and path != "/v1/feed":
                raise ApiError("JSON-lines batching is /v1/feed only")
            docs = []
            for ln in lines:
                try:
                    docs.append(json.loads(ln))
                except ValueError as exc:
                    raise ApiError(f"bad JSON: {exc}") from None
            outs = []
            status = 200
            for doc in docs:
                try:
                    outs.append(await self._apply(path, tenant_id, doc))
                except Exception as exc:  # noqa: BLE001 - typed below
                    st, payload = self._error(exc)
                    if len(docs) == 1:
                        status = st
                    outs.append(payload)
            payload = ("\n".join(json.dumps(o) for o in outs) + "\n").encode()
            extra = []
            if status in (429, 503) and len(outs) == 1:
                retry = outs[0].get("error", {}).get("retry_after_s")
                extra.append(("retry-after",
                              f"{max(retry or 0.05, 0.001):.3f}"))
            return status, "application/json", payload, extra
        except ReproError as exc:
            st, payload = self._error(exc)
            return (st, "application/json",
                    (json.dumps(payload) + "\n").encode(), [])
        except Exception as exc:  # pragma: no cover - defensive
            return (500, "application/json",
                    (json.dumps(error_payload(exc)) + "\n").encode(), [])

    def _dispatch_get(self, path: str) -> Tuple[int, str, bytes, list]:
        if path == "/healthz":
            return 200, "application/json", b'{"ok": true}\n', []
        if path == "/metrics":
            return (200, "text/plain; version=0.0.4",
                    obs.to_prometheus().encode(), [])
        if path == "/v1/stats":
            doc = {
                "tenants": {
                    t.id: {
                        "streams": sorted(t.streams),
                        "stores": sorted(t.store_ids),
                        "staged_blocks": t.staged_blocks,
                    } for t in self.tenants.tenants.values()},
                "staged_blocks_total": self.tenants.staged_blocks,
                "max_staged_blocks_total": self.max_staged_blocks_total,
            }
            return (200, "application/json",
                    (json.dumps(doc) + "\n").encode(), [])
        if path == "/v1/control":
            doc = {"policy": self.policy.as_dict(),
                   "control": (None if self.control is None
                               else self.control.status())}
            return (200, "application/json",
                    (json.dumps(doc) + "\n").encode(), [])
        raise NotFoundError(f"no route {path!r}")

    def _error(self, exc: Exception) -> Tuple[int, dict]:
        if isinstance(exc, ReproError):
            status = exc.http_status
        elif isinstance(exc, KeyError):
            status = 404
        elif isinstance(exc, (ValueError, IndexError, TypeError)):
            status = 400
        else:
            status = 500
        payload = error_payload(exc)
        if not isinstance(exc, ReproError):
            # preserve the typed 4xx split for non-Repro exceptions
            payload["error"]["code"] = ("not_found" if status == 404 else
                                        "bad_request" if status == 400 else
                                        "internal")
        code = payload["error"]["code"]
        if status in (429, 503) or code in ("quota_exceeded", "rate_limited",
                                            "overloaded"):
            _m_reject(code).inc()
        return status, payload

    # ---------------------------------------------------------------- routes
    async def _apply(self, path: str, tenant_id: str, doc: object) -> dict:
        tenant = self.tenants.get(tenant_id)
        if path == "/v1/open":
            if not isinstance(doc, dict):
                raise ApiError("open: expected object")
            extra = set(doc) - {"stream_id", "config", "coalesce"}
            if extra:
                raise ApiError(f"open: unknown field(s) {sorted(extra)}")
            sid = doc.get("stream_id")
            if not isinstance(sid, str) or not sid:
                raise ApiError("open: stream_id must be a non-empty string")
            cfg = (self.default_config if doc.get("config") is None
                   else api.CodecConfig.from_json(doc["config"]))
            tenant.open_stream(sid, cfg, coalesce=bool(doc.get("coalesce",
                                                               False)))
            return {"stream_id": sid, "coalesce": bool(doc.get("coalesce",
                                                               False)),
                    "config": cfg.to_json()}
        if path == "/v1/feed":
            req = api.CompressRequest.from_json(doc)
            self._admit_global(tenant)
            return tenant.feed(req).to_json()
        if path == "/v1/close":
            sid = self._stream_id(doc, "close")
            return tenant.close_stream(sid).to_json()
        if path == "/v1/collect":
            sid = self._stream_id(doc, "collect")
            st = tenant.stream(sid)
            return api.FeedResult(stream_id=sid,
                                  segment=st.collect()).to_json()
        if path == "/v1/attach":
            if not isinstance(doc, dict):
                raise ApiError("attach: expected object")
            extra = set(doc) - {"store_id", "container", "seed"}
            if extra:
                raise ApiError(f"attach: unknown field(s) {sorted(extra)}")
            store_id = doc.get("store_id")
            if not isinstance(store_id, str) or not store_id:
                raise ApiError("attach: store_id must be a non-empty string")
            blob = api.decode_bytes(doc.get("container"), "attach.container")
            tenant.attach_store(store_id, blob, seed=int(doc.get("seed", 0)))
            return {"store_id": store_id, "bytes": len(blob)}
        if path == "/v1/detach":
            store_id = doc.get("store_id") if isinstance(doc, dict) else None
            if not isinstance(store_id, str):
                raise ApiError("detach: store_id must be a string")
            tenant.detach_store(store_id)
            return {"store_id": store_id, "detached": True}
        if path == "/v1/decode":
            req = api.DecodeRangeRequest.from_json(doc)
            mux = self._mux(tenant)
            fut = mux.submit(req)
            try:
                values = await asyncio.wait_for(fut, self.request_timeout_s)
            except asyncio.TimeoutError:
                mux.futures.pop(req.request_id, None)
                raise OverloadedError(
                    "decode batch did not complete within "
                    f"{self.request_timeout_s}s") from None
            return api.RangeResult(
                request_id=req.request_id or "", values=values).to_json()
        raise NotFoundError(f"no route {path!r}")  # pragma: no cover

    @staticmethod
    def _stream_id(doc: object, what: str) -> str:
        sid = doc.get("stream_id") if isinstance(doc, dict) else None
        if not isinstance(sid, str) or not sid:
            raise ApiError(f"{what}: stream_id must be a non-empty string")
        return sid

    def _mux(self, tenant) -> _DecodeMux:
        mux = self._muxes.get(tenant.id)
        if mux is None:
            mux = self._muxes[tenant.id] = _DecodeMux(
                tenant, asyncio.get_running_loop())
        return mux

    def _admit_global(self, tenant) -> None:
        """Global backpressure ahead of per-tenant quotas: when every
        tenant's staged blocks together cross the server budget, first
        force-flush (the backpressure -> FlushPolicy feedback), and only
        reject if the pipeline is still saturated."""
        staged = self.tenants.staged_blocks
        if staged < self.max_staged_blocks_total:
            return
        _M_FORCE_FLUSH.inc()
        for t in sorted(self.tenants.tenants.values(),
                        key=lambda t: -t.staged_blocks):
            if t.staged_blocks == 0:
                break
            t.flush_all()
            if self.tenants.staged_blocks \
                    < self.max_staged_blocks_total:
                return
        raise OverloadedError(
            f"{staged} blocks staged across tenants (budget "
            f"{self.max_staged_blocks_total}); flush could not relieve it",
            retry_after_s=self.policy.max_age_s)


_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            429: "Too Many Requests", 500: "Internal Server Error",
            503: "Service Unavailable"}
_POST_ROUTES = {"/v1/open", "/v1/feed", "/v1/close", "/v1/collect",
                "/v1/attach", "/v1/detach", "/v1/decode"}


class FrontendClient:
    """Minimal asyncio client for the front end's protocol -- what the
    tests and the load generator speak the wire with.  One instance = one
    keep-alive connection = one tenant."""

    def __init__(self, host: str, port: int, tenant: str):
        self.host, self.port, self.tenant = host, port, tenant
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None

    async def connect(self) -> "FrontendClient":
        self._reader, self._writer = await asyncio.open_connection(
            self.host, self.port)
        return self

    async def aclose(self) -> None:
        if self._writer is not None:
            self._writer.close()
            try:
                await self._writer.wait_closed()
            except (ConnectionError, OSError):
                pass
            self._reader = self._writer = None

    async def __aenter__(self) -> "FrontendClient":
        return await self.connect()

    async def __aexit__(self, *exc) -> None:
        await self.aclose()

    # ------------------------------------------------------------ transport
    async def request_raw(self, method: str, path: str, body: bytes = b"",
                          ctype: str = "application/json"
                          ) -> Tuple[int, Dict[str, str], bytes]:
        if self._writer is None:
            await self.connect()
        head = (f"{method} {path} HTTP/1.1\r\n"
                f"host: {self.host}:{self.port}\r\n"
                f"x-tenant: {self.tenant}\r\n"
                f"content-type: {ctype}\r\n"
                f"content-length: {len(body)}\r\n\r\n")
        self._writer.write(head.encode() + body)
        await self._writer.drain()
        status_line = await self._reader.readline()
        if not status_line:
            raise ConnectionError("server closed the connection")
        status = int(status_line.split()[1])
        headers: Dict[str, str] = {}
        while True:
            h = await self._reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            k, _, v = h.decode("latin-1").partition(":")
            headers[k.strip().lower()] = v.strip()
        length = int(headers.get("content-length", "0"))
        payload = (await self._reader.readexactly(length)) if length else b""
        return status, headers, payload

    async def post(self, path: str, doc: dict) -> dict:
        """Single-document POST; typed errors re-raised client-side."""
        status, _h, payload = await self.request_raw(
            "POST", path, (json.dumps(doc) + "\n").encode())
        out = json.loads(payload.decode())
        if status != 200 or "error" in out:
            raise error_from_payload(out)
        return out

    async def post_lines(self, path: str, docs) -> list:
        """JSON-lines POST (/v1/feed): one request, one response doc per
        line; per-line protocol errors come back as error docs, not
        raises."""
        body = ("\n".join(json.dumps(d) for d in docs) + "\n").encode()
        _status, _h, payload = await self.request_raw("POST", path, body)
        return [json.loads(ln) for ln in payload.decode().splitlines()
                if ln.strip()]

    # ------------------------------------------------------------ verb sugar
    async def open(self, stream_id: str,
                   config: Optional[api.CodecConfig] = None,
                   coalesce: bool = False) -> dict:
        doc = {"stream_id": stream_id, "coalesce": coalesce}
        if config is not None:
            doc["config"] = config.to_json()
        return await self.post("/v1/open", doc)

    async def feed(self, stream_id: str, samples) -> api.FeedResult:
        req = api.CompressRequest(stream_id=stream_id,
                                  samples=np.asarray(samples))
        return api.FeedResult.from_json(
            await self.post("/v1/feed", req.to_json()))

    async def close_stream(self, stream_id: str) -> api.FeedResult:
        return api.FeedResult.from_json(
            await self.post("/v1/close", {"stream_id": stream_id}))

    async def collect(self, stream_id: str) -> api.FeedResult:
        return api.FeedResult.from_json(
            await self.post("/v1/collect", {"stream_id": stream_id}))

    async def attach(self, store_id: str, container: bytes,
                     seed: int = 0) -> dict:
        return await self.post("/v1/attach", {
            "store_id": store_id, "container": api.encode_bytes(container),
            "seed": seed})

    async def decode(self, store_id: str, start_block: int, stop_block: int,
                     channel: int = 0,
                     request_id: str = "") -> api.RangeResult:
        req = api.DecodeRangeRequest(store_id, start_block, stop_block,
                                     channel, request_id)
        return api.RangeResult.from_json(
            await self.post("/v1/decode", req.to_json()))

    async def metrics(self) -> str:
        status, _h, payload = await self.request_raw("GET", "/metrics")
        if status != 200:
            raise ConnectionError(f"/metrics -> {status}")
        return payload.decode()

    async def stats(self) -> dict:
        status, _h, payload = await self.request_raw("GET", "/v1/stats")
        return json.loads(payload.decode())

    async def control(self) -> dict:
        status, _h, payload = await self.request_raw("GET", "/v1/control")
        return json.loads(payload.decode())
