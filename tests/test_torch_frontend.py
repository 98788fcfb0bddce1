"""The port's serving front end (``repro_torch.serve.frontend``) on the CPU.

Each test of the reference's ``tests/test_serve_frontend.py`` runs here
against the port's server on ``device="cpu"`` (kernel wrappers run their
plain versions): concurrent multi-tenant traffic over the real asyncio
wire protocol -- byte identity on the golden corpus, typed
quota/rate/backpressure rejections, deadline flushes under an injected
clock, tenant isolation, error mapping, and the control loop's policy
broadcast.

Then the port is held against the reference over the wire: one scripted
request sequence runs against the reference's ``ServeFrontend`` (``numpy``,
and ``jax`` for the device arm) and the port's (``numpy``, and ``torch``):
status codes, ``Retry-After``, response documents and segment bytes must
be equal.  Each package's client must work against the other's server.
Tolerance: none (bytes and documents equal).
"""
import asyncio
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import GOLDEN_CASES, golden_codec_kwargs, golden_signal  # noqa: E402
from repro import api as jax_api  # noqa: E402
from repro import obs as jax_obs  # noqa: E402
from repro.core import IdealemCodec as JaxCodec  # noqa: E402
from repro.errors import NotFoundError as JaxNotFoundError  # noqa: E402
from repro.errors import QuotaExceededError as JaxQuotaExceededError  # noqa: E402
from repro.serve import FrontendClient as JaxFrontendClient  # noqa: E402
from repro.serve import ServeFrontend as JaxServeFrontend  # noqa: E402
from repro.serve import TenantQuota as JaxTenantQuota  # noqa: E402
from repro.store import pack as jax_pack  # noqa: E402
from repro_torch import api, obs  # noqa: E402
from repro_torch.core import IdealemCodec  # noqa: E402
from repro_torch.core import decode as decode_mod  # noqa: E402
from repro_torch.errors import (NotFoundError, OverloadedError,  # noqa: E402
                                QuotaExceededError, RateLimitedError,
                                ReproError)
from repro_torch.serve import (FlushPolicy, FrontendClient,  # noqa: E402
                               ServeFrontend, TenantQuota)
from repro_torch.serve.control import ControlConfig, ControlLoop  # noqa: E402
from repro_torch.store import pack  # noqa: E402

DEV = "cpu"


class FakeClock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def run(coro):
    return asyncio.run(coro)


def counter_total(name):
    """Sum a counter family across children from the port's registry."""
    parsed = obs.parse_prometheus(obs.to_prometheus())
    return sum(v for (n, _items), v in parsed.items() if n == name)


def frontend(**kw):
    return ServeFrontend(device=DEV, **kw)


# ----------------------------------------------------- golden byte identity
def test_concurrent_tenants_golden_byte_identity():
    """One tenant per golden-corpus case, all replaying concurrently over
    the wire on direct streams: every concatenated segment stream must be
    byte-identical to a direct ``IdealemSession`` fed the same chunks."""
    cases = list(GOLDEN_CASES)

    async def one_tenant(fe, name):
        kw = golden_codec_kwargs(name)
        cfg = api.CodecConfig(**kw)
        x = golden_signal(name).astype(np.float64)
        shadow = IdealemCodec(device=DEV, **kw).session()
        async with FrontendClient(fe.host, fe.port, f"g-{name}") as c:
            await c.open("s", cfg)
            segs, ref, i = [], [], 0
            rng = np.random.default_rng(cases.index(name))
            while i < len(x):
                step = int(rng.integers(5, 700))
                segs.append((await c.feed("s", x[i:i + step])).segment)
                ref.append(shadow.feed(x[i:i + step]))
                i += step
            segs.append((await c.close_stream("s")).segment)
            ref.append(shadow.finish())
            wire = b"".join(segs)
        assert wire == b"".join(ref), name
        # and the wire stream decodes to the same samples as the one-shot
        codec = IdealemCodec(device=DEV, **kw)
        np.testing.assert_array_equal(codec.decode(wire),
                                      codec.decode(codec.encode(x)))

    async def main():
        async with frontend(run_control=False) as fe:
            await asyncio.gather(*(one_tenant(fe, n) for n in cases))

    run(main())


# ------------------------------------------------------------- admission
def test_stream_quota_rejection_is_typed_and_counted():
    before = counter_total("repro_frontend_rejections_total")

    async def main():
        async with frontend(default_quota=TenantQuota(max_streams=1),
                            run_control=False) as fe:
            cfg = api.CodecConfig(backend="numpy")
            async with FrontendClient(fe.host, fe.port, "tq") as c:
                await c.open("a", cfg)
                with pytest.raises(QuotaExceededError):
                    await c.open("b", cfg)
                # raw status check: 429 + retry hint semantics
                status, _h, _p = await c.request_raw(
                    "POST", "/v1/open",
                    b'{"stream_id": "c"}\n')
                assert status == 429

    run(main())
    assert counter_total("repro_frontend_rejections_total") >= before + 2


def test_rate_limit_carries_retry_after():
    clock = FakeClock()

    async def main():
        async with frontend(
                clock=clock, tick_interval_s=None, run_control=False,
                default_quota=TenantQuota(max_bytes_per_s=800.0,
                                          burst_bytes=800.0)) as fe:
            cfg = api.CodecConfig(backend="numpy")
            async with FrontendClient(fe.host, fe.port, "rl") as c:
                await c.open("s", cfg)
                await c.feed("s", np.zeros(100))       # drains the bucket
                with pytest.raises(RateLimitedError) as ei:
                    await c.feed("s", np.zeros(100))
                assert ei.value.retry_after_s == pytest.approx(1.0)
                # a request that can NEVER fit the bucket is a quota error
                with pytest.raises(QuotaExceededError):
                    await c.feed("s", np.zeros(200))
                clock.advance(2.0)                     # bucket refills
                await c.feed("s", np.zeros(100))

    run(main())


def test_per_tenant_staged_block_quota():
    async def main():
        policy = FlushPolicy(max_batch_blocks=10**6,
                             max_batch_streams=10**6, max_age_s=None)
        async with frontend(
                policy=policy, run_control=False, tick_interval_s=None,
                max_staged_blocks_total=10**6,
                default_quota=TenantQuota(max_staged_blocks=4)) as fe:
            cfg = api.CodecConfig(block_size=32)
            async with FrontendClient(fe.host, fe.port, "sq") as c:
                await c.open("s", cfg, coalesce=True)
                await c.feed("s", np.zeros(4 * 32))    # stages 4 blocks
                with pytest.raises(QuotaExceededError):
                    await c.feed("s", np.zeros(32))    # the 5th

    run(main())


def api_feed_body(stream_id, arr):
    return (json.dumps(
        api.CompressRequest(stream_id, arr).to_json()) + "\n").encode()


def test_global_backpressure_force_flushes_then_503():
    async def main():
        hold = FlushPolicy(max_batch_blocks=10**6, max_batch_streams=10**6,
                           max_age_s=None)
        # budget of 4 blocks across ALL tenants
        async with frontend(policy=hold, run_control=False,
                            tick_interval_s=None,
                            max_staged_blocks_total=4) as fe:
            cfg = api.CodecConfig(block_size=32)
            async with FrontendClient(fe.host, fe.port, "bp-a") as a, \
                    FrontendClient(fe.host, fe.port, "bp-b") as b:
                await a.open("s", cfg, coalesce=True)
                await b.open("s", cfg, coalesce=True)
                await a.feed("s", np.zeros(4 * 32))    # saturates budget
                before = counter_total(
                    "repro_frontend_backpressure_flushes_total")
                # b's feed crosses the budget: the front end force-flushes
                # a's cohort (backpressure FEEDS the flush policy) and then
                # admits b
                r = await b.feed("s", np.ones(32))
                assert r.stream_id == "s"
                assert counter_total(
                    "repro_frontend_backpressure_flushes_total") == before + 1
                # a's flushed segment is buffered for its next collect
                got = (await a.collect("s")).segment
                assert got != b""
            # budget 0: relief is impossible -> typed 503
            fe.max_staged_blocks_total = 0
            async with FrontendClient(fe.host, fe.port, "bp-c") as c:
                await c.open("s", cfg, coalesce=True)
                with pytest.raises(OverloadedError):
                    await c.feed("s", np.zeros(32))
                status, _h, _p = await c.request_raw(
                    "POST", "/v1/feed", api_feed_body("s", np.zeros(32)))
                assert status == 503

    run(main())


# -------------------------------------------------------- deadline flushes
def test_deadline_flush_under_injected_clock():
    clock = FakeClock()

    async def main():
        policy = FlushPolicy(max_batch_blocks=10**6, max_batch_streams=10**6,
                             max_age_s=5.0)
        async with frontend(policy=policy, clock=clock,
                            tick_interval_s=None, run_control=False) as fe:
            cfg = api.CodecConfig(block_size=32)
            x = np.sin(np.linspace(0, 30, 8 * 32))
            async with FrontendClient(fe.host, fe.port, "dl") as c:
                await c.open("s", cfg, coalesce=True)
                r = await c.feed("s", x)
                assert r.segment == b""               # staged, not flushed
                fe.tick()                              # age 0: still held
                assert (await c.collect("s")).segment == b""
                clock.advance(6.0)                     # past max_age_s
                fe.tick()                              # deadline trips
                seg = (await c.collect("s")).segment
                assert seg != b""
                seg += (await c.close_stream("s")).segment
            codec = IdealemCodec.from_config(cfg, device=DEV)
            np.testing.assert_array_equal(
                codec.decode(seg), codec.decode(codec.encode(x)))

    run(main())


# ------------------------------------------------------------- decode path
def test_decode_roundtrip_and_tenant_isolation():
    async def main():
        async with frontend(run_control=False) as fe:
            kw = dict(mode="std", block_size=32, num_dict=15,
                      backend="numpy")
            codec = IdealemCodec(device=DEV, **kw)
            x = np.sin(np.linspace(0, 50, 64 * 32))
            stream = codec.encode(x)
            ref = codec.decode(stream, backend="numpy")
            async with FrontendClient(fe.host, fe.port, "iso-a") as a, \
                    FrontendClient(fe.host, fe.port, "iso-b") as b:
                await a.attach("st", pack(stream))
                rr = await a.decode("st", 3, 11)
                np.testing.assert_array_equal(
                    np.asarray(rr.values).ravel(), ref[3 * 32:11 * 32])
                # tenant b cannot see tenant a's store
                with pytest.raises((NotFoundError, ReproError, KeyError)):
                    await b.decode("st", 0, 1)
                status, _h, _p = await b.request_raw(
                    "POST", "/v1/decode",
                    b'{"store_id": "st", "start_block": 0,'
                    b' "stop_block": 1}\n')
                assert status == 404

    run(main())


# ---------------------------------------------------------- wire protocol
def test_json_lines_batched_feed():
    async def main():
        async with frontend(run_control=False) as fe:
            cfg = api.CodecConfig(backend="numpy", block_size=32)
            async with FrontendClient(fe.host, fe.port, "jl") as c:
                await c.open("s", cfg)
                x = np.sin(np.linspace(0, 9, 96))
                docs = [api.CompressRequest("s", x[:32]).to_json(),
                        api.CompressRequest("ghost", x[32:64]).to_json(),
                        api.CompressRequest("s", x[32:96]).to_json()]
                outs = await c.post_lines("/v1/feed", docs)
                assert len(outs) == 3
                assert outs[0]["stream_id"] == "s"
                assert outs[1]["error"]["code"] == "not_found"  # per line
                assert outs[2]["stream_id"] == "s"
                fin = await c.close_stream("s")
            wire = (b"".join(
                api.FeedResult.from_json(o).segment
                for o in (outs[0], outs[2])) + fin.segment)
            sess = IdealemCodec.from_config(cfg, device=DEV).session()
            direct = sess.feed(x[:32]) + sess.feed(x[32:96]) + sess.finish()
            assert wire == direct

    run(main())


def test_protocol_error_mapping():
    async def main():
        async with frontend(run_control=False) as fe:
            async with FrontendClient(fe.host, fe.port, "em") as c:
                for path, body, want in [
                        ("/v1/nope", b"{}\n", 404),
                        ("/v1/open", b"not json\n", 400),
                        ("/v1/open", b'{"stream_id": ""}\n', 400),
                        ("/v1/feed", b'{"stream_id": "missing", "samples":'
                         b' {"dtype": "<f8", "b64": ""}}\n', 404),
                        ("/v1/open", b'{"stream_id": "s", "bogus": 1}\n',
                         400)]:
                    status, _h, payload = await c.request_raw(
                        "POST", path, body)
                    assert status == want, (path, payload)
                # missing tenant header
                c.tenant = ""
                status, _h, payload = await c.request_raw(
                    "POST", "/v1/open", b'{"stream_id": "s"}\n')
                assert status == 400 and b"x-tenant" in payload
                c.tenant = "em"
                status, _h, payload = await c.request_raw("GET", "/healthz")
                assert status == 200

    run(main())


# ------------------------------------------------------------ control loop
def test_control_loop_broadcasts_policy_to_tenants():
    """Live decode traffic populates the port's stage histograms; a
    hair-trigger control loop must then move the FlushPolicy and the
    front end must broadcast it into every tenant's services."""

    async def main():
        policy = FlushPolicy(max_batch_blocks=1024, max_batch_streams=1,
                             max_age_s=0.4)
        loop = ControlLoop(policy=policy, config=ControlConfig(
            target_p99_s=1e-9, min_observations=1, min_age_s=0.2),
            on_reprobe=lambda: None)
        async with frontend(policy=policy, control=loop,
                            control_interval_s=0.0,
                            tick_interval_s=None) as fe:
            kw = dict(mode="std", block_size=32, num_dict=15,
                      backend="numpy")
            codec = IdealemCodec(device=DEV, **kw)
            x = np.sin(np.linspace(0, 50, 64 * 32))
            async with FrontendClient(fe.host, fe.port, "cl") as c:
                await c.attach("st", pack(codec.encode(x)))
                for k in range(4):     # flushes via max_batch_streams=1
                    await c.decode("st", k, k + 2, request_id=f"r{k}")
                fe.tick()
                assert fe.policy.max_batch_blocks == 512  # halved
                ctl = await c.control()
                assert ctl["policy"]["max_batch_blocks"] == 512
            tenant = fe.tenants.get("cl", create=False)
            assert tenant.policy.max_batch_blocks == 512
            assert tenant.decomp.policy.max_batch_blocks == 512

    run(main())


# --------------------------------------------------- the port's differences
def test_front_end_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeFrontend()
    fe = frontend()
    assert fe.device == torch.device("cpu")
    assert fe.tenants.get("t").decomp.backend == "cuda"  # the default
    assert fe.tenants.get("t").decomp.device == torch.device("cpu")


def test_coalesced_numpy_and_jax_backend_are_typed_400s():
    async def main():
        async with frontend(run_control=False) as fe:
            async with FrontendClient(fe.host, fe.port, "bk") as c:
                status, _h, payload = await c.request_raw(
                    "POST", "/v1/open", (json.dumps({
                        "stream_id": "s", "coalesce": True,
                        "config": {"backend": "numpy"}}) + "\n").encode())
                doc = json.loads(payload)
                assert status == 400 and doc["error"]["code"] == \
                    "bad_request" and "torch/cuda" in doc["error"]["message"]
                status, _h, payload = await c.request_raw(
                    "POST", "/v1/open", (json.dumps({
                        "stream_id": "s",
                        "config": {"backend": "jax"}}) + "\n").encode())
                assert status == 400 and b"backend" in payload

    run(main())


def test_auto_decode_without_an_exact_backend_fails_futures(monkeypatch):
    """``decode_backend="auto"`` raises where the reference falls back to
    the host; every request of the batch must answer with the error
    document (500 ``internal``) at once, none may hang to the timeout."""
    real = decode_mod._run_device

    def off_by_one_ulp(plan, backend, device):
        return np.nextafter(real(plan, backend, device), np.inf)

    monkeypatch.setattr(decode_mod, "_run_device", off_by_one_ulp)
    decode_mod.reset_autotune()

    async def main():
        policy = FlushPolicy(max_batch_streams=2, max_age_s=None)
        async with frontend(run_control=False, policy=policy,
                            decode_backend="auto",
                            request_timeout_s=30.0) as fe:
            codec = IdealemCodec(mode="delta", block_size=16, num_dict=8,
                                 backend="numpy", device=DEV)
            blob = codec.encode(np.cumsum(np.sin(np.arange(64 * 16))))
            async with FrontendClient(fe.host, fe.port, "au") as a, \
                    FrontendClient(fe.host, fe.port, "au") as b:
                await a.attach("st", pack(blob))
                body = [(json.dumps(api.DecodeRangeRequest(
                    "st", k, k + 3, request_id=f"r{k}").to_json())
                    + "\n").encode() for k in range(2)]
                t0 = asyncio.get_running_loop().time()
                outs = await asyncio.gather(
                    a.request_raw("POST", "/v1/decode", body[0]),
                    b.request_raw("POST", "/v1/decode", body[1]))
                took = asyncio.get_running_loop().time() - t0
        assert took < 10.0
        for status, _h, payload in outs:
            doc = json.loads(payload)
            assert status == 500 and doc["error"]["code"] == "internal"
            assert "not byte-exact" in doc["error"]["message"]

    try:
        run(main())
    finally:
        decode_mod.reset_autotune()


def test_service_quarantines_a_group_auto_cannot_route(monkeypatch):
    """The read service under the mux: when ``"auto"`` raises for a merged
    group, its requests go to ``last_errors`` and the flush returns."""
    from repro_torch.serve import DecompressionService
    real = decode_mod._run_device
    monkeypatch.setattr(decode_mod, "_run_device",
                        lambda p, b, d: np.nextafter(real(p, b, d), np.inf))
    decode_mod.reset_autotune()
    try:
        codec = IdealemCodec(mode="delta", block_size=16, num_dict=8,
                             backend="numpy", device=DEV)
        svc = DecompressionService(policy=FlushPolicy(max_batch_streams=2),
                                   backend="auto", device=DEV)
        svc.attach("st", pack(codec.encode(np.cumsum(np.ones(16 * 20)))))
        assert svc.submit("a", "st", 0, 3) is None
        assert svc.submit("b", "st", 4, 9) == {}
        assert set(svc.last_errors) == {"a", "b"}
        assert all("not byte-exact" in str(e)
                   for e in svc.last_errors.values())
        assert svc.stats["failed_requests"] == 2
        assert svc.close() == {}
    finally:
        decode_mod.reset_autotune()


# ------------------------------------------------ wire differential vs JAX
def _lines(payload):
    return [json.loads(ln) for ln in payload.decode().splitlines()
            if ln.strip()]


async def _script(host, port, cfg_json, packer):
    """The scripted request sequence; returns ``[(what, status,
    retry-after, documents)]`` and the direct stream's segment bytes."""
    x = np.sin(np.linspace(0, 40, 1000)) + np.repeat(
        np.arange(10.0), 100) * 0.3
    out, segs = [], []
    c = FrontendClient(host, port, "wd")
    await c.connect()
    try:
        async def req(what, method, path, docs=None, raw=None):
            body = raw if raw is not None else b"".join(
                (json.dumps(d) + "\n").encode() for d in docs or ())
            status, headers, payload = await c.request_raw(method, path, body)
            docs = _lines(payload) if path != "/metrics" else []
            out.append((what, status, headers.get("retry-after"), docs))
            return docs

        def feed(sid, lo, hi):
            return api.CompressRequest(sid, x[lo:hi]).to_json()

        await req("open", "POST", "/v1/open",
                  [{"stream_id": "s", "config": cfg_json}])
        await req("open second", "POST", "/v1/open",
                  [{"stream_id": "t", "config": cfg_json}])
        await req("quota", "POST", "/v1/open",
                  [{"stream_id": "u", "config": cfg_json}])
        docs = await req("multi-line feed", "POST", "/v1/feed",
                         [feed("s", 0, 77), feed("ghost", 0, 10),
                          feed("s", 77, 400), feed("t", 0, 5)])
        segs += [d["segment"] for d in docs if "segment" in d
                 and d["stream_id"] == "s"]
        docs = await req("feed", "POST", "/v1/feed", [feed("s", 400, 1000)])
        segs += [docs[0]["segment"]]
        docs = await req("collect", "POST", "/v1/collect",
                         [{"stream_id": "s"}])
        segs += [docs[0]["segment"]]
        docs = await req("close", "POST", "/v1/close", [{"stream_id": "s"}])
        segs += [docs[0]["segment"]]
        await req("unknown stream", "POST", "/v1/close",
                  [{"stream_id": "s"}])
        wire = b"".join(api.decode_bytes(s) for s in segs)
        await req("attach", "POST", "/v1/attach", [{
            "store_id": "st", "container": api.encode_bytes(packer(wire)),
            "seed": 3}])
        for k, (i, j) in enumerate([(0, 1), (2, 9), (5, 31)]):
            await req(f"decode {i}:{j}", "POST", "/v1/decode", [
                {"store_id": "st", "start_block": i, "stop_block": j,
                 "request_id": f"d{k}"}])
        await req("decode past the end", "POST", "/v1/decode", [
            {"store_id": "st", "start_block": 0, "stop_block": 10**6}])
        await req("detach", "POST", "/v1/detach", [{"store_id": "st"}])
        await req("unknown route", "POST", "/v1/nope", [{}])
        await req("malformed JSON", "POST", "/v1/open", raw=b"{not json\n")
        await req("JSON-lines off /v1/feed", "POST", "/v1/close",
                  [{"stream_id": "t"}, {"stream_id": "t"}])
        await req("stats", "GET", "/v1/stats")
        await req("control", "GET", "/v1/control")
        await req("healthz", "GET", "/healthz")
    finally:
        await c.aclose()
    return out, wire


# arm -> (reference codec backend, port codec backend)
ARMS = {"numpy": ("numpy", "numpy"), "device": ("jax", "torch")}


def _normalize(results, config_cls, rename):
    """Replace each open answer's config document by its full knob set with
    the reference's backend names mapped to the port's."""
    for _what, _st, _ra, docs in results:
        for d in docs:
            if isinstance(d, dict) and "config" in d:
                kw = config_cls.from_json(d["config"]).kwargs()
                for k in ("backend", "decode_backend"):
                    kw[k] = rename.get(kw[k], kw[k])
                d["config"] = kw
    return results


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_wire_differential_against_the_reference(arm):
    jb, tb = ARMS[arm]
    quota = dict(max_streams=2)

    async def serve(fe_cls, cfg_json, packer, **kw):
        async with fe_cls(run_control=False, **kw) as fe:
            return await _script(fe.host, fe.port, cfg_json, packer)

    jres, jwire = run(serve(
        JaxServeFrontend, {"backend": jb, "decode_backend": jb,
                           "block_size": 16, "num_dict": 8},
        jax_pack, default_quota=JaxTenantQuota(**quota),
        decode_backend=jb))
    tres, twire = run(serve(
        ServeFrontend, {"backend": tb, "decode_backend": tb,
                        "block_size": 16, "num_dict": 8},
        pack, default_quota=TenantQuota(**quota), decode_backend=tb,
        device=DEV))
    jres = _normalize(jres, jax_api.CodecConfig, {"jax": tb})
    tres = _normalize(tres, api.CodecConfig, {})
    assert [r[:3] for r in tres] == [r[:3] for r in jres]
    for j, t in zip(jres, tres):
        assert t == j, t[0]
    assert twire == jwire and len(twire) > 0
    # the script covered every outcome the protocol has
    assert {r[1] for r in tres} == {200, 400, 404, 429}
    # the segments decode like the one-shot encode of the same samples
    x = np.sin(np.linspace(0, 40, 1000)) + np.repeat(
        np.arange(10.0), 100) * 0.3
    codec = IdealemCodec(backend=tb, block_size=16, num_dict=8, device=DEV)
    np.testing.assert_array_equal(codec.decode(twire),
                                  codec.decode(codec.encode(x)))
    # the repro_frontend_* families: the reference's names, kinds, help
    # texts and buckets, in the port's registry
    snap, jsnap = obs.registry().snapshot(), jax_obs.registry().snapshot()
    fams = {n for n in jsnap if n.startswith("repro_frontend_")}
    assert fams == {n for n in snap if n.startswith("repro_frontend_")}
    for n in fams:
        assert (snap[n]["kind"], snap[n]["help"]) == \
            (jsnap[n]["kind"], jsnap[n]["help"]), n
    lat = "repro_frontend_request_seconds"
    feed_child = [v for v in snap[lat]["values"]
                  if v["labels"] == {"route": "POST /v1/feed"}]
    jfeed_child = [v for v in jsnap[lat]["values"]
                   if v["labels"] == {"route": "POST /v1/feed"}]
    assert sorted(feed_child[0]["buckets"]) == sorted(
        jfeed_child[0]["buckets"])


# ------------------------------------------------------------ cross clients
def _cross_signal():
    return np.sin(np.linspace(0, 25, 700)) + np.repeat(np.arange(7.0),
                                                       100) * 0.4


def test_port_client_against_reference_server():
    x = _cross_signal()
    cfg = api.CodecConfig(backend="numpy", block_size=16, num_dict=8)

    async def main():
        async with JaxServeFrontend(
                run_control=False, decode_backend="numpy",
                default_quota=JaxTenantQuota(max_streams=1)) as fe:
            async with FrontendClient(fe.host, fe.port, "xp") as c:
                opened = await c.open("s", cfg)
                with pytest.raises(QuotaExceededError):
                    await c.open("t", cfg)
                segs = [(await c.feed("s", x[i:i + 90])).segment
                        for i in range(0, len(x), 90)]
                segs.append((await c.close_stream("s")).segment)
                with pytest.raises(NotFoundError):
                    await c.collect("s")
                wire = b"".join(segs)
                await c.attach("st", pack(wire))
                rr = await c.decode("st", 4, 19, request_id="q")
            return opened, wire, rr

    opened, wire, rr = run(main())
    assert api.CodecConfig.from_json(opened["config"]) == cfg
    sess = IdealemCodec.from_config(cfg, device=DEV).session()
    want = b"".join([sess.feed(x[i:i + 90]) for i in range(0, len(x), 90)]
                    + [sess.finish()])
    assert wire == want
    jsess = JaxCodec(backend="numpy", block_size=16, num_dict=8).session()
    assert wire == b"".join([jsess.feed(x[i:i + 90])
                             for i in range(0, len(x), 90)]
                            + [jsess.finish()])
    y = IdealemCodec.from_config(cfg, device=DEV).decode(wire)
    assert rr.request_id == "q"
    assert rr.values.tobytes() == y[4 * 16:19 * 16].tobytes()


def test_reference_client_against_port_server():
    x = _cross_signal()
    jcfg = jax_api.CodecConfig(backend="numpy", block_size=16, num_dict=8)

    async def main():
        async with frontend(run_control=False,
                            default_quota=TenantQuota(max_streams=1)) as fe:
            async with JaxFrontendClient(fe.host, fe.port, "xr") as c:
                await c.open("s", jcfg)
                with pytest.raises(JaxQuotaExceededError):
                    await c.open("t", jcfg)
                segs = [(await c.feed("s", x[i:i + 90])).segment
                        for i in range(0, len(x), 90)]
                segs.append((await c.close_stream("s")).segment)
                with pytest.raises(JaxNotFoundError):
                    await c.collect("s")
                wire = b"".join(segs)
                await c.attach("st", jax_pack(wire))
                rr = await c.decode("st", 4, 19, request_id="q")
                metrics = await c.metrics()
            return wire, rr, metrics

    wire, rr, metrics = run(main())
    jsess = JaxCodec(backend="numpy", block_size=16, num_dict=8).session()
    assert wire == b"".join([jsess.feed(x[i:i + 90])
                             for i in range(0, len(x), 90)]
                            + [jsess.finish()])
    y = JaxCodec(backend="numpy", block_size=16, num_dict=8).decode(wire)
    assert rr.request_id == "q"
    assert rr.values.tobytes() == y[4 * 16:19 * 16].tobytes()
    # the port's exposition parses with the reference's parser
    parsed = jax_obs.parse_prometheus(metrics)
    assert any(name == "repro_frontend_requests_total"
               for name, _ in parsed)
