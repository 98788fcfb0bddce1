"""Multi-tenant serving front end on the card, end to end: the reference's
``examples/serve_frontend.py`` on the PyTorch + CUDA port.

Starts a :class:`repro_torch.serve.ServeFrontend` on localhost, then
drives it the way a fleet of clients would -- over the real wire protocol:

1. several tenants compress uPMU-like traces concurrently, each stream's
   encode one K1 launch a feed, byte-identical to a local shadow session;
2. one tenant sits behind a tight bytes/s quota and shows the typed 429
   ``Retry-After`` dance;
3. the compressed container is attached back and range-decoded through
   the batched decode mux (the device reconstruction);
4. finally ``/metrics`` is scraped and the p99s printed -- the numbers
   the control loop (``repro_torch.serve.control``) steers on.

The tenants' codecs take the port's device backend: ``cuda`` (the
kernels) on the card, ``torch`` (their plain versions) with
``--device cpu``.

  PYTHONPATH=src python examples_torch/serve_frontend.py --tenants 4
"""
import argparse
import asyncio

import numpy as np

from repro_torch import api, obs
from repro_torch.core import IdealemCodec
from repro_torch.data import synthetic
from repro_torch.device import resolve_device
from repro_torch.errors import RateLimitedError
from repro_torch.serve import (FlushPolicy, FrontendClient, ServeFrontend,
                               TenantQuota)
from repro_torch.store import pack


async def compress_tenant(fe, i: int, samples: int, backend: str,
                          dev) -> None:
    cfg = api.CodecConfig(mode="std", block_size=32, num_dict=127,
                          backend=backend, decode_backend=backend)
    x = synthetic.pmu_magnitude(samples, level=100 + 5 * i, noise=1.0,
                                seed=i)
    shadow = IdealemCodec.from_config(cfg, device=str(dev)).session()
    async with FrontendClient(fe.host, fe.port, f"tenant-{i}") as c:
        await c.open("pmu", cfg)
        wire, ref = [], []
        for lo in range(0, samples, 1024):
            wire.append((await c.feed("pmu", x[lo:lo + 1024])).segment)
            ref.append(shadow.feed(x[lo:lo + 1024]))
        wire.append((await c.close_stream("pmu")).segment)
        ref.append(shadow.finish())
        blob, local = b"".join(wire), b"".join(ref)
        print(f"  tenant-{i}: {samples * 8} B -> {len(blob)} B over the "
              f"wire ({samples * 8 / len(blob):.1f}x), byte-identical to "
              f"the local session: {blob == local}")

        # decode it back through the batched mux
        await c.attach("pmu-store", pack(blob))
        got = await c.decode("pmu-store", 0, 16)
        want = IdealemCodec.from_config(
            cfg, device=str(dev)).decode(blob)[:16 * 32]
        ok = np.allclose(np.asarray(got.values).ravel(), want)
        print(f"  tenant-{i}: range decode of 16 blocks round-trips: {ok}")


async def throttled_tenant(fe, samples: int, backend: str) -> None:
    cfg = api.CodecConfig(mode="std", block_size=32, backend=backend,
                          decode_backend=backend)
    x = synthetic.pmu_magnitude(samples, level=120.0, noise=0.5, seed=99)
    rejected = 0
    async with FrontendClient(fe.host, fe.port, "throttled") as c:
        await c.open("pmu", cfg)
        for lo in range(0, samples, 2048):
            while True:
                try:
                    await c.feed("pmu", x[lo:lo + 2048])
                    break
                except RateLimitedError as exc:
                    rejected += 1
                    await asyncio.sleep(exc.retry_after_s or 0.05)
        await c.close_stream("pmu")
    print(f"  throttled: finished after {rejected} typed 429s "
          "(each carried Retry-After)")


async def main(args) -> None:
    dev = resolve_device(args.device)
    backend = "cuda" if dev.type == "cuda" else "torch"
    policy = FlushPolicy(max_batch_blocks=2048, max_batch_streams=32,
                         max_age_s=0.01)
    quotas = {"throttled": TenantQuota(max_bytes_per_s=200_000,
                                       burst_bytes=32_768)}
    async with ServeFrontend(policy=policy, quotas=quotas,
                             control_interval_s=0.05,
                             decode_backend=backend, device=dev) as fe:
        print(f"front end on {fe.host}:{fe.port}, "
              f"policy={policy.as_dict()}")
        await asyncio.gather(
            *(compress_tenant(fe, i, args.samples, backend, dev)
              for i in range(args.tenants)),
            throttled_tenant(fe, args.samples, backend))

        async with FrontendClient(fe.host, fe.port, "probe") as c:
            parsed = obs.parse_prometheus(await c.metrics())
            ctl = await c.control()
    for route in ("POST /v1/feed", "POST /v1/decode"):
        p99 = obs.quantile_from_parsed(
            parsed, "repro_frontend_request_seconds", 0.99,
            {"route": route})
        if p99 is not None:
            print(f"p99 {route}: {p99 * 1e3:.2f} ms")
    print(f"control loop: {ctl['control']['ticks']} ticks, "
          f"policy now {ctl['policy']}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--tenants", type=int, default=4)
    ap.add_argument("--samples", type=int, default=32 * 512)
    ap.add_argument("--device", default="cuda")
    asyncio.run(main(ap.parse_args()))
