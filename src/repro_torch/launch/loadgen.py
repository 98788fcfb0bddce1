"""Closed-loop load generator for the port's serving front end.

    python -m repro_torch.launch.loadgen [--tenants 8] [--samples 8192]
        [--device cuda|cpu] [--smoke] [--json PATH]

Replays synthetic-but-shaped traces against a
:class:`repro_torch.serve.ServeFrontend` over the real wire protocol --
every tenant is its own keep-alive connection driving its own streams,
closed loop (a client issues the next chunk only after the previous
response lands, honouring ``Retry-After`` on 429/503).  The traces,
chunking, tenants, checks, report and exit codes are the reference
package's load generator's (``scripts/loadgen.py``).

Two trace families, matching the paper's target data:

* **power-grid**: a 60 Hz fundamental with 3rd/5th harmonics, slow
  amplitude modulation and measurement noise -- the periodic signals
  IDEALEM's dictionary loves.
* **bursty sensor**: a level random walk with Poisson-arriving activity
  bursts -- the quiet/loud alternation that exercises deadline flushes
  and the control loop's batch sizing.

The server and every stream run on ``--device`` (default ``cuda``): there
the direct and coalesced streams encode on ``backend="cuda"`` and decode
on ``decode_backend="cuda"``; with ``--device cpu`` they run ``torch`` on
the host.  The rate-limited tenant's stream runs ``numpy``; it sends its
chunks as the lines of one JSON-lines request (the reference's sends one
request a chunk, whose rejections depend on how fast the host answers).

Verification is end to end:

* every **direct** stream's concatenated wire segments must be
  **byte-identical** to a shadow ``IdealemSession`` of the port, on the
  same device and backend, fed exactly the same chunks (``byte_diffs`` in
  the report must be 0);
* every **coalesced** stream must be **decode-exact**: the decoded wire
  bytes equal the one-shot codec decode of the full trace (the coalescer's
  contract -- segment framing differs across flush cohorts, samples never);
* a decode phase packs each direct stream's bytes into a container,
  attaches it, and range-reads through the batched decode mux, comparing
  against the codec's own decode;
* finally the front end's ``/metrics`` is scraped, parsed with
  ``repro_torch.obs.parse_prometheus``, and the p99 SLOs asserted with
  ``repro_torch.obs.evaluate_slos`` -- the same math
  ``python -m repro_torch.launch.obs_tool slo`` runs.

Exit status: 0 all checks green, 1 any byte diff / SLO breach / missing
rejection observability, 2 usage.  ``--json PATH`` writes the full report;
``--smoke`` is the CI profile (small traces, same checks).
"""
from __future__ import annotations

import argparse
import asyncio
import json
import time

import numpy as np


# ------------------------------------------------------------------ traces
def power_grid_trace(n: int, seed: int) -> np.ndarray:
    """60 Hz + harmonics + drifting amplitude + noise, 1.92 kHz sampling."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 1920.0
    amp = 1.0 + 0.05 * np.sin(2 * np.pi * 0.3 * t + rng.uniform(0, 6.28))
    x = amp * (np.sin(2 * np.pi * 60 * t + rng.uniform(0, 6.28))
               + 0.08 * np.sin(2 * np.pi * 180 * t)
               + 0.03 * np.sin(2 * np.pi * 300 * t))
    return (x + rng.normal(0, 0.01, size=n)).astype(np.float64)


def bursty_sensor_trace(n: int, seed: int) -> np.ndarray:
    """Level random walk with Poisson-arriving activity bursts."""
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.normal(0, 0.02, size=n))
    i = 0
    while i < n:
        i += int(rng.exponential(n / 6)) + 1
        width = int(rng.integers(32, 256))
        burst = rng.normal(0, 1.0, size=width) * np.hanning(width) * 3.0
        end = min(n, i + width)
        x[i:end] += burst[:end - i]
    return x.astype(np.float64)


def arrival_chunks(trace: np.ndarray, kind: str, seed: int):
    """Cut a trace into per-request chunks: periodic traces arrive in a
    fixed cadence, bursty traces in ragged bursts."""
    rng = np.random.default_rng(seed)
    i = 0
    while i < len(trace):
        if kind == "grid":
            step = 256
        else:
            step = int(rng.integers(64, 512))
        yield trace[i:i + step]
        i += step


# ------------------------------------------------------------------ tenants
def tenant_oracle(idx: int, samples: int, cfg_direct, cfg_coal,
                  device) -> dict:
    """One tenant's traces, chunks and expected answers, computed before
    any traffic: the shadow session's segments of the direct stream, the
    one-shot decode of the coalesced stream's trace and the decode of the
    shadow bytes that the range reads are held to.  The client and the
    server share one event loop, so a check computed between requests
    would stall every tenant's requests for as long as its plain scan
    runs (the one-shot encode of a 4,096-sample trace held decodes for
    0.1-0.46 s under a loaded CPU) and the server's latency would carry
    the load generator's own work.  The reference's load generator
    computes these between requests, inside the traffic window."""
    from repro_torch.core import IdealemCodec
    grid = power_grid_trace(samples, seed=1000 + idx)
    sensor = bursty_sensor_trace(samples, seed=2000 + idx)
    direct_codec = IdealemCodec.from_config(cfg_direct, device=device)
    coal_codec = IdealemCodec.from_config(cfg_coal, device=device)
    g_chunks = list(arrival_chunks(grid, "grid", seed=idx))
    s_chunks = list(arrival_chunks(sensor, "burst", seed=idx))
    shadow = direct_codec.session()
    shadow_bytes = b"".join([shadow.feed(c) for c in g_chunks]
                            + [shadow.finish()])
    return {"g_chunks": g_chunks, "s_chunks": s_chunks,
            "shadow_bytes": shadow_bytes,
            "direct_decoded": direct_codec.decode(shadow_bytes),
            "coal_decoded": coal_codec.decode(coal_codec.encode(sensor)),
            "coal_codec": coal_codec}


async def run_tenant(host: str, port: int, tenant_id: str, idx: int,
                     oracle: dict, cfg_direct, cfg_coal,
                     report: dict) -> None:
    """One tenant's closed loop: a direct power-grid stream (byte-diffed
    against a shadow session) and a coalesced bursty-sensor stream
    (decode-diffed), then a decode phase through the batched mux.  The
    expected answers come from :func:`tenant_oracle`."""
    from repro_torch.errors import RateLimitedError, ReproError
    from repro_torch.serve import FrontendClient
    from repro_torch.store import pack

    t = {"tenant": tenant_id, "feeds": 0, "bytes_in": 0, "bytes_out": 0,
         "byte_diffs": 0, "decode_diffs": 0, "retries": 0, "decodes": 0}
    report["tenants"].append(t)

    async with FrontendClient(host, port, tenant_id) as c:
        await c.open("grid", cfg_direct, coalesce=False)
        await c.open("sensor", cfg_coal, coalesce=True)
        wire_direct, wire_coal = [], []

        async def feed(stream: str, chunk: np.ndarray) -> bytes:
            while True:
                try:
                    r = await c.feed(stream, chunk)
                except (RateLimitedError, ReproError) as exc:
                    retry = getattr(exc, "retry_after_s", None)
                    if retry is None:
                        raise
                    t["retries"] += 1
                    await asyncio.sleep(min(retry, 0.5))
                    continue
                t["feeds"] += 1
                t["bytes_in"] += chunk.nbytes
                t["bytes_out"] += len(r.segment)
                return r.segment

        g_iter, s_iter = iter(oracle["g_chunks"]), iter(oracle["s_chunks"])
        g_chunk, s_chunk = next(g_iter, None), next(s_iter, None)
        while g_chunk is not None or s_chunk is not None:
            if g_chunk is not None:
                wire_direct.append(await feed("grid", g_chunk))
                g_chunk = next(g_iter, None)
            if s_chunk is not None:
                wire_coal.append(await feed("sensor", s_chunk))
                s_chunk = next(s_iter, None)
        wire_direct.append((await c.close_stream("grid")).segment)
        wire_coal.append((await c.close_stream("sensor")).segment)

        direct_bytes = b"".join(wire_direct)
        if direct_bytes != oracle["shadow_bytes"]:
            t["byte_diffs"] += 1
        got = oracle["coal_codec"].decode(b"".join(wire_coal))
        if not np.array_equal(got, oracle["coal_decoded"]):
            t["decode_diffs"] += 1

        # decode phase: serve the direct stream's bytes back through the mux
        await c.attach("store", pack(direct_bytes))
        ref = oracle["direct_decoded"]
        B = cfg_direct.block_size
        total_blocks = len(ref) // B
        rng = np.random.default_rng(3000 + idx)
        for k in range(8):
            start = int(rng.integers(0, max(1, total_blocks - 4)))
            stop = min(total_blocks, start + int(rng.integers(1, 16)))
            rr = await c.decode("store", start, stop,
                                request_id=f"{tenant_id}-d{k}")
            t["decodes"] += 1
            vals = np.asarray(rr.values).ravel()
            if not np.allclose(vals, ref[start * B:stop * B]):
                t["decode_diffs"] += 1


async def run_noisy_tenant(host: str, port: int, report: dict) -> None:
    """A tenant behind a deliberately tight bytes/s quota: its rejections
    prove admission control is live and observable in /metrics.  It sends
    its trace's 1,024-sample chunks as the lines of one JSON-lines
    ``/v1/feed``, so the lines are admitted back to back inside one
    request and the bucket cannot refill between them however busy the
    host is; each rejected line answers with its typed error document
    (``rate_limited``, HTTP status 429 on its own)."""
    from repro_torch import api
    from repro_torch.errors import error_from_payload
    from repro_torch.serve import FrontendClient

    t = {"tenant": "noisy", "feeds": 0, "rejections_seen": 0}
    report["tenants"].append(t)
    cfg = api.CodecConfig(mode="std", block_size=32, backend="numpy")
    data = power_grid_trace(4096, seed=77)
    async with FrontendClient(host, port, "noisy") as c:
        await c.open("g", cfg)
        docs = await c.post_lines("/v1/feed", [
            api.CompressRequest("g", data[i:i + 1024]).to_json()
            for i in range(0, len(data), 1024)])
        for doc in docs:
            code = doc.get("error", {}).get("code")
            if code is None:
                t["feeds"] += 1
            elif code in ("rate_limited", "quota_exceeded"):
                t["rejections_seen"] += 1
            else:
                raise error_from_payload(doc)
        await c.close_stream("g")


# -------------------------------------------------------------------- main
def configs(device: str):
    """``(direct, coalesced)`` stream configurations on ``device``: the
    reference's knobs on the port's backend for that device."""
    from repro_torch import api
    backend = "cuda" if device == "cuda" else "torch"
    cfg_direct = api.CodecConfig(mode="std", block_size=32, num_dict=63,
                                 backend=backend, decode_backend=backend)
    cfg_coal = api.CodecConfig(mode="residual", block_size=32, num_dict=63,
                               alpha=0.05, rel_tol=0.5, backend=backend,
                               decode_backend=backend)
    return cfg_direct, cfg_coal


async def run(args) -> dict:
    from repro_torch import obs
    from repro_torch.serve import (FlushPolicy, FrontendClient,
                                   ServeFrontend, TenantQuota)

    report = {"config": {k: getattr(args, k) for k in
                         ("tenants", "samples", "slo_feed_p99_s",
                          "slo_decode_p99_s", "smoke", "device")},
              "tenants": [], "slos": [], "ok": True, "problems": []}
    policy = FlushPolicy(max_batch_blocks=2048, max_batch_streams=32,
                         max_age_s=0.01)
    quotas = {"noisy": TenantQuota(max_bytes_per_s=64_000,
                                   burst_bytes=16_384)}
    cfg_direct, cfg_coal = configs(args.device)

    fe = await ServeFrontend(policy=policy, quotas=quotas,
                             decode_backend=cfg_direct.decode_backend,
                             device=args.device).start()
    oracles = [tenant_oracle(i, args.samples, cfg_direct, cfg_coal,
                             fe.device) for i in range(args.tenants)]
    t0 = time.perf_counter()
    try:
        jobs = [run_tenant(fe.host, fe.port, f"tenant-{i:02d}", i,
                           oracles[i], cfg_direct, cfg_coal, report)
                for i in range(args.tenants)]
        jobs.append(run_noisy_tenant(fe.host, fe.port, report))
        await asyncio.gather(*jobs)

        async with FrontendClient(fe.host, fe.port, "probe") as c:
            metrics_text = await c.metrics()
            report["control"] = await c.control()
    finally:
        await fe.close()
    report["wall_s"] = time.perf_counter() - t0

    # ---------------------------------------------------------- verdicts
    byte_diffs = sum(t.get("byte_diffs", 0) for t in report["tenants"])
    decode_diffs = sum(t.get("decode_diffs", 0) for t in report["tenants"])
    rejections_seen = sum(t.get("rejections_seen", 0)
                          for t in report["tenants"])
    report["byte_diffs"] = byte_diffs
    report["decode_diffs"] = decode_diffs
    report["rejections_seen"] = rejections_seen
    if byte_diffs:
        report["problems"].append(f"{byte_diffs} direct stream(s) were not "
                                  "byte-identical to the shadow session")
    if decode_diffs:
        report["problems"].append(f"{decode_diffs} decode mismatch(es)")
    if not rejections_seen:
        report["problems"].append(
            "the rate-limited tenant saw no typed rejection")

    parsed = obs.parse_prometheus(metrics_text)
    rej = sum(v for (name, items), v in parsed.items()
              if name == "repro_frontend_rejections_total")
    report["metrics_rejections_total"] = rej
    if rej <= 0:
        report["problems"].append(
            "repro_frontend_rejections_total absent from /metrics")

    specs = [
        obs.SloSpec("repro_frontend_request_seconds", 0.99,
                    args.slo_feed_p99_s, {"route": "POST /v1/feed"}),
        obs.SloSpec("repro_frontend_request_seconds", 0.99,
                    args.slo_decode_p99_s, {"route": "POST /v1/decode"}),
    ]
    for res in obs.evaluate_slos(specs, parsed=parsed):
        report["slos"].append({"slo": res.spec.describe(),
                               "value": res.value, "ok": res.ok})
        if not res.ok:
            report["problems"].append(f"SLO breach: {res.describe()}")
        if res.value is None:
            report["problems"].append(
                f"no traffic recorded for {res.spec.describe()}")

    report["ok"] = not report["problems"]
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="loadgen", description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--tenants", type=int, default=8,
                    help="concurrent verified tenants (>= 8 for the "
                    "acceptance profile)")
    ap.add_argument("--samples", type=int, default=8192,
                    help="trace length per stream")
    ap.add_argument("--slo-feed-p99-s", type=float, default=0.5)
    ap.add_argument("--slo-decode-p99-s", type=float, default=1.0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the server's streams and decodes run")
    ap.add_argument("--smoke", action="store_true",
                    help="CI profile: small traces, same checks")
    ap.add_argument("--json", metavar="PATH",
                    help="write the full report as JSON")
    args = ap.parse_args(argv)
    if args.smoke:
        args.samples = min(args.samples, 4096)

    report = asyncio.run(run(args))
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(report, fh, indent=1, sort_keys=True)
        print(f"report -> {args.json}")
    feeds = sum(t.get("feeds", 0) for t in report["tenants"])
    print(f"{len(report['tenants'])} tenants, {feeds} feeds, "
          f"{report['byte_diffs']} byte diffs, "
          f"{report['decode_diffs']} decode diffs, "
          f"{report['rejections_seen']} typed rejections, "
          f"{report['wall_s']:.1f}s on {args.device}")
    for s in report["slos"]:
        v = "n/a" if s["value"] is None else f"{s['value']:.4f}s"
        print(f"  {s['slo']} = {v} {'ok' if s['ok'] else 'BREACH'}")
    for p in report["problems"]:
        print(f"FAIL: {p}")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
