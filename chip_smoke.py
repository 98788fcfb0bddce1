#!/usr/bin/env python3
"""Drive the PyTorch port of IDEALEM on one CUDA card: build, check, time.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each fatal on failure (no failure is caught):

1. device  -- a CUDA card must be present; prints its name and power limit.
2. build   -- compiles every kernel of ``src/repro_torch/csrc`` with nvcc
              for sm_90a (one process per source, in parallel).
3. K1      -- the fused encode scan against its plain version on the card:
              D in {1, 9, 255}, n in {7, 32, 111}, the min/max and KS
              ablations, a ragged block mask, plus one dictionary too large
              for shared memory.  Decisions and final carry must be equal.
4. K2      -- the sequential cumsum against its plain version and against
              ``np.cumsum`` of the host copy, bitwise, in f64/f32/f16 with a
              leading -0.0.
5. golden  -- the 8 streams of ``tests/golden`` encode byte for byte with
              ``backend="cuda"``; their cuda decode equals the host decode.
6. main    -- the paper's Table I configurations (MAG std B=32; ANG
              residual and delta B=112; D=255, alpha=0.01) on 64 channels x
              2**20 f64 samples of synthetic PMU traffic (the reference
              package's uPMU stand-ins, event rates kept), fed to
              ``codec.session(channels=64)`` in 16 chunks and decoded on the
              card channel by channel.  Launch counts are zeroed just before
              each configuration and read just after.  Checks: exact miss
              blocks (std) or block bases (residual/delta) and tails; cuda
              decode == numpy decode; K1's decisions on 4 channels == the
              plain scan on the card; the first 2,048 blocks of one channel
              == the numpy oracle; chunked == one-shot decode.  Then the
              same encode and decode again under ``torch.profiler``: the
              card's busy share and device time by kernel name.
7. timing  -- each kernel at a main-path shape against its plain version
              (equal, else fatal), its bound and (K2) ``torch.cumsum``; K1
              also on a MAG-shaped feed that turns the dictionary over;
              prints the ``{"kernels": [...]}`` line.

Prints the card line (``nvidia-smi --query-gpu=name,power.limit``) and, last,
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

CHANNELS, SAMPLES, CHUNKS = 64, 2 ** 20, 16
# The reference package's stand-in for the paper's uPMU channels
# (benchmarks/common.py, 262,144 samples each): channel c takes template
# c % 4.  MAG: (level, noise, tap_step, level shifts); 6 tap changes.
# ANG: (slope, noise).  Event counts are per REF_SAMPLES and scale with the
# series, so a longer series keeps the same event rate.
REF_SAMPLES = 262_144
MAG_TEMPLATES = ((120.0, 0.4, 2.0, 4), (7200.0, 1.5, 45.0, 4),
                 (95.0, 1.1, 3.0, 8), (7180.0, 0.9, 44.9, 4))
MAG_TAPS = 6
ANG_TEMPLATES = ((0.72, 0.04), (0.31, 0.02), (0.72, 0.06), (0.29, 0.03))
# K1 is also timed on traffic that fills the dictionary and turns it over:
# each block is N(level, 1) with the level drawn from TURNOVER_LEVELS > D
# levels one standard deviation apart.
TURNOVER_LEVELS = 384
ORACLE_BLOCKS = 2048
PLAIN_CHANNELS = (0, 21, 42, 63)
CONFIGS = {  # the paper's Table I (src/repro/configs/idealem_paper.py)
    "MAG": dict(mode="std", block_size=32, num_dict=255, alpha=0.01,
                rel_tol=0.5),
    "ANG_residual": dict(mode="residual", block_size=112, num_dict=255,
                         alpha=0.01, rel_tol=0.5, value_range=(0.0, 360.0)),
    "ANG_delta": dict(mode="delta", block_size=112, num_dict=255, alpha=0.01,
                      rel_tol=0.5, value_range=(0.0, 360.0)),
}
# NVIDIA H100 SXM data sheet: HBM3 3.35 TB/s; 67 TFLOP/s f32 and 34 TFLOP/s
# f64 outside the tensor cores.
HBM_BPS = 3.35e12
PEAK_OPS = {"f32": 67e12, "f64": 34e12}
# K1 operation count per dictionary row and block: the eq. 3 gate (one
# difference, one product, two sums, two differences, four compares) for
# every valid row; for every gate-passing row the KS distance, about 12 f32
# operations per sample (two ECDF products, a difference, an abs and a max
# for each of the two gaps, and the merge compares).
K1_GATE_OPS, K1_KS_OPS_PER_SAMPLE = 10, 12

def say(msg: str) -> None:
    print(msg, flush=True)


def check(cond, what: str) -> None:
    if not cond:
        raise AssertionError(f"check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` on the card, after one warm-up,
    from CUDA events around ``reps`` back-to-back calls."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def mixture(nb, n, seed):
    rng = np.random.default_rng(seed)
    parts = [rng.normal(m, s, size=(nb // 3, n))
             for m, s in [(0, 1), (5, 0.5), (0, 1)]]
    parts.append(rng.normal(0, 1, size=(nb - 3 * (nb // 3), n)))
    return np.concatenate(parts)


# ------------------------------------------------------------------ phases
def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    times = _build.build_all(force=True)
    wall = time.perf_counter() - t0
    check(set(times) == {"encode_step", "seq_cumsum"}, f"built {times}")
    for name in sorted(times):
        say(f"[build] {name}.cu: {times[name]:.2f} s")
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                say(f"[build]   {line.strip()}")
    say(f"[build] all kernels in {wall:.2f} s (parallel nvcc)")


def phase_k1(torch, dev):
    from repro_torch.core.encoder import init_state
    from repro_torch.kernels import encode_step as k1
    cases = [(D, n, mm, ks) for D in (1, 9, 255) for n in (7, 32, 111)
             for mm, ks in ((True, True), (False, True), (True, False))]
    cases.append((255, 256, True, True))  # dictionary in global memory
    C, nb = 3, 320
    seen = np.zeros(3, dtype=np.int64)  # hits, misses, overwrites
    for i, (D, n, mm, ks) in enumerate(cases):
        blocks = np.stack([mixture(nb, n, seed=100 * i + c) for c in range(C)])
        xs = torch.sort(torch.from_numpy(blocks).to(dev, torch.float32),
                        dim=-1).values
        valid = torch.ones((C, nb), dtype=torch.bool, device=dev)
        valid[1, nb // 2:] = False
        valid[2, ::5] = False
        st = init_state(D, n, channels=C, device=dev)
        kw = dict(d_crit=(int(0.4 * n) + 0.5) / n, rel_tol=0.5,
                  use_minmax=mm, use_ks=ks)
        got, gst = k1.encode_scan(xs, valid, st, **kw)
        torch.cuda.synchronize()
        want, wst = k1.encode_scan_torch(xs, valid, st, **kw)
        for a, b, name in zip(got, want, ("is_hit", "slot", "overwrite")):
            check(torch.equal(a, b), f"K1 {name} D={D} n={n} mm={mm} ks={ks}")
        for a, b, name in zip(gst, wst, gst._fields):
            check(torch.equal(a, b), f"K1 carry {name} D={D} n={n}")
        check(not got[0][~valid].any(), "K1 masked blocks decide no hit")
        h = got[0][valid]
        seen += [int(h.sum()), int((~h).sum()), int(got[2].sum())]
    check(np.all(seen > 0), f"K1 ring saw hits/misses/overwrites {seen}")
    say(f"[K1] {len(cases)} cases equal to the plain version on the card "
        f"(hits {seen[0]}, misses {seen[1]}, overwrites {seen[2]})")


def phase_k2(torch, dev):
    from repro_torch.kernels import seq_cumsum as k2
    rng = np.random.default_rng(7)
    for dt in (np.float64, np.float32, np.float16):
        for R, P in ((16384, 111), (1000, 255), (3, 1)):
            x = (rng.normal(0, 3, (R, P))
                 * 10.0 ** rng.integers(-3, 3, (R, 1))).astype(dt)
            x[:, 0] = -0.0
            xt = torch.from_numpy(x).to(dev)
            got = k2.seq_cumsum(xt)
            torch.cuda.synchronize()
            plain = k2.seq_cumsum_torch(xt)
            check(torch.equal(got, plain) and
                  got.cpu().numpy().tobytes() == plain.cpu().numpy().tobytes(),
                  f"K2 == plain {dt.__name__} {R}x{P}")
            check(got.cpu().numpy().tobytes() ==
                  np.cumsum(x, axis=1).tobytes(),
                  f"K2 == np.cumsum {dt.__name__} {R}x{P}")
            check(bool(torch.signbit(got[:, 0]).all()), "K2 keeps -0.0")
    say("[K2] bitwise equal to its plain version and to np.cumsum "
        "(f64/f32/f16, leading -0.0)")


def phase_golden(dev):
    import conftest
    from repro_torch import IdealemCodec
    from repro_torch.core.stream import decode_stream
    names = sorted(conftest.GOLDEN_CASES)
    for name in names:
        want = (ROOT / "tests" / "golden" / f"{name}.idlm").read_bytes()
        kw = conftest.golden_codec_kwargs(name)
        kw["backend"] = "cuda"
        codec = IdealemCodec(device=dev, **kw)
        x = conftest.golden_signal(name)
        blob = codec.encode(x)
        check(blob == want, f"golden {name}: cuda encode bytes")
        y = codec.decode(blob)
        check(y.shape == x.shape and np.all(np.isfinite(y)),
              f"golden {name}: decoded shape/finite")
        check(y.tobytes() == decode_stream(blob, backend="numpy").tobytes(),
              f"golden {name}: cuda decode == numpy decode")
    say(f"[golden] {len(names)} streams byte for byte on backend=cuda; "
        "cuda decode == numpy decode")


def make_traffic(cfg_name):
    from repro_torch.data.synthetic import pmu_angle, pmu_magnitude
    x = np.empty((CHANNELS, SAMPLES), dtype=np.float64)
    rate = SAMPLES / REF_SAMPLES
    for c in range(CHANNELS):
        if cfg_name == "MAG":
            level, noise, tap_step, shifts = MAG_TEMPLATES[c % 4]
            x[c] = pmu_magnitude(
                SAMPLES, level=level, noise=noise, tap_step=tap_step,
                n_shifts=round(shifts * rate), n_taps=round(MAG_TAPS * rate),
                seed=c)
        else:
            slope, noise = ANG_TEMPLATES[c % 4]
            x[c] = pmu_angle(SAMPLES, slope=slope, noise=noise, seed=c)
    return x


def turnover(C, nb, n, seed):
    rng = np.random.default_rng(seed)
    level = rng.integers(0, TURNOVER_LEVELS, (C, nb, 1)).astype(np.float64)
    return rng.normal(level, 1.0, (C, nb, n))


def device_profile(torch, fn):
    """Run ``fn`` under ``torch.profiler``: wall seconds (host clock, ending
    in a sync), the union of the card's activity intervals (kernels and
    copies), and the summed device time of the busiest names."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        by_name[e.name] = by_name.get(e.name, 0.0) + (b - a) / 1e3
    busy_us, end = 0.0, -np.inf
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"wall_s": wall, "device_events": len(spans),
            "device_busy_s": busy_us / 1e6,
            "busy_share": busy_us / 1e6 / wall if spans else None,
            "device_ms_by_name": {k[:80]: v for k, v in top}}


def phase_main(torch, dev, card):
    from repro_torch import IdealemCodec
    from repro_torch.core.encoder import init_state
    from repro_torch.core.npref import encode_decisions_np
    from repro_torch.core.stream import _parse_arrays, decode_stream
    from repro_torch.kernels import encode_step as k1
    from repro_torch.kernels import seq_cumsum as k2
    launches = {"encode_step": 0, "seq_cumsum": 0}
    first_chunks = {}
    for cfg_name, cfg in CONFIGS.items():
        codec = IdealemCodec(device=dev, **cfg)  # backend/decode: cuda
        B = codec.block_size
        x = make_traffic(cfg_name)
        step = SAMPLES // CHUNKS

        def encode():
            sess = codec.session(channels=CHANNELS)
            parts = [[] for _ in range(CHANNELS)]
            for lo in range(0, SAMPLES, step):
                for c, seg in enumerate(sess.feed(x[:, lo:lo + step])):
                    parts[c].append(seg)
            for c, seg in enumerate(sess.finish()):
                parts[c].append(seg)
            torch.cuda.synchronize()
            return [b"".join(p) for p in parts]

        def decode():
            ys = [codec.decode(b) for b in blobs]
            torch.cuda.synchronize()
            return ys

        k1.launches = k2.launches = 0
        t0 = time.perf_counter()
        blobs = encode()
        t_enc = time.perf_counter() - t0
        t0 = time.perf_counter()
        ys = decode()
        t_dec = time.perf_counter() - t0
        n1, n2 = k1.launches, k2.launches
        launches["encode_step"] += n1
        launches["seq_cumsum"] += n2

        check(n1 > 0, f"{cfg_name}: K1 launched on the main path ({n1})")
        if cfg["mode"] == "delta":
            check(n2 > 0, f"{cfg_name}: K2 launched on the main path ({n2})")
        nb = SAMPLES // B
        tail = SAMPLES - nb * B
        hits = 0
        for c, (blob, y) in enumerate(zip(blobs, ys)):
            check(y.shape == (SAMPLES,) and y.dtype == np.float64 and
                  bool(np.all(np.isfinite(y))), f"{cfg_name} ch{c} shape")
            want = decode_stream(blob, backend="numpy")
            check(y.tobytes() == want.tobytes(),
                  f"{cfg_name} ch{c}: cuda decode == numpy decode")
            _, pr = _parse_arrays(blob)
            hits += int(pr.is_hit.sum())
            yb, xb = y[:nb * B].reshape(nb, B), x[c, :nb * B].reshape(nb, B)
            if cfg["mode"] == "std":
                check(np.array_equal(yb[~pr.is_hit], xb[~pr.is_hit]),
                      f"{cfg_name} ch{c}: miss blocks exact")
            else:
                check(np.array_equal(yb[:, 0], xb[:, 0]),
                      f"{cfg_name} ch{c}: block bases exact")
                err = np.abs(yb[~pr.is_hit] - xb[~pr.is_hit])
                check(float(err.max()) <= 1e-9,
                      f"{cfg_name} ch{c}: miss blocks within 1e-9 "
                      f"({float(err.max())})")
            check(np.array_equal(y[nb * B:], x[c, nb * B:]),
                  f"{cfg_name} ch{c}: tail exact ({tail} samples)")
        # K1's decisions as written to the stream vs the plain scan
        pay = np.stack([codec._transform(x[c, :nb * B].reshape(nb, B))[0]
                        for c in PLAIN_CHANNELS])
        xs = torch.sort(torch.as_tensor(pay, dtype=torch.float32,
                                        device=dev), dim=-1).values
        (h, s, o), _ = k1.encode_scan_torch(
            xs, torch.ones(xs.shape[:2], dtype=torch.bool, device=dev),
            init_state(codec.num_dict, xs.shape[-1], channels=len(xs),
                       device=dev),
            d_crit=codec.d_crit, rel_tol=codec.rel_tol)
        for i, c in enumerate(PLAIN_CHANNELS):
            _, pr = _parse_arrays(blobs[c])
            check(np.array_equal(h[i].cpu().numpy(), pr.is_hit) and
                  np.array_equal(s[i].cpu().numpy(), pr.slot) and
                  np.array_equal(o[i].cpu().numpy(), pr.overwrite),
                  f"{cfg_name} ch{c}: K1 decisions == plain scan")
        # numpy oracle on the first blocks of channel 0, fed the f32
        # payloads the scan sees (the tensor backends cast to f32)
        pay = codec._transform(x[0, :ORACLE_BLOCKS * B].reshape(-1, B))[0]
        kw = dict(num_dict=codec.num_dict, d_crit=codec.d_crit,
                  rel_tol=codec.rel_tol)
        want = encode_decisions_np(pay.astype(np.float32), **kw)
        _, pr0 = _parse_arrays(blobs[0])
        for w, g in zip(want, (pr0.is_hit, pr0.slot, pr0.overwrite)):
            check(np.array_equal(w, g[:ORACLE_BLOCKS]),
                  f"{cfg_name}: first {ORACLE_BLOCKS} blocks == numpy oracle")
        f64_diff = int(np.sum(encode_decisions_np(pay, **kw)[0]
                              != pr0.is_hit[:ORACLE_BLOCKS]))
        # chunked segments vs a one-shot encode of one channel
        one = codec.decode(codec.encode(x[1]))
        check(one.tobytes() == ys[1].tobytes(),
              f"{cfg_name}: chunked decode == one-shot decode")

        bytes_in = x.nbytes
        bytes_out = sum(len(b) for b in blobs)
        res = {
            "ratio": bytes_in / bytes_out, "hit_rate": hits / (nb * CHANNELS),
            "encode_MBps": bytes_in / t_enc / 1e6,
            "decode_MBps": bytes_in / t_dec / 1e6,
            "encode_s": t_enc, "decode_s": t_dec,
            "launches": {"encode_step": n1, "seq_cumsum": n2},
            "blocks_per_channel": nb,
            "numpy_f64_payload_hit_diffs": f64_diff,
        }
        say(f"[main] {cfg_name} {CHANNELS} ch x {SAMPLES} f64 "
            f"({bytes_in / 2**20:.0f} MiB): {json.dumps(res)} [{card}]")
        say(f"[main] {cfg_name}: checks passed (f64-payload numpy backend "
            f"differs on {f64_diff} of the first {ORACLE_BLOCKS} hits)")
        # the same encode and decode again, under the profiler (the timed
        # run above is not profiled; launch counts were read before this)
        for what, fn in (("encode", encode), ("decode", decode)):
            say(f"[profile] {cfg_name} {what}: "
                f"{json.dumps(device_profile(torch, fn))} [{card}]")
        p0 = codec._transform(x[:, :step - step % B].reshape(
            CHANNELS, -1, B).reshape(-1, B))[0]
        first_chunks[cfg_name] = (codec, p0.reshape(CHANNELS, -1, p0.shape[-1]))
        del x, ys, blobs
    return launches, first_chunks


def k1_work(torch, xs, is_hit, D, rel_tol):
    """(valid rows, gate-passing rows) summed over a scan from an empty
    dictionary: each step's dictionary is replayed from the decisions."""
    C, nb, n = xs.shape
    dev = xs.device
    miss = (~is_hit).to(torch.int64)
    before = torch.cumsum(miss, dim=1) - miss   # inserts before each step
    slot = before % D
    m = torch.full((C, nb, D), -1, dtype=torch.int64, device=dev)
    ci, bi = torch.nonzero(miss, as_tuple=True)
    m[ci, bi, slot[ci, bi]] = bi
    last = torch.cummax(m, dim=1).values
    last = torch.cat([torch.full((C, 1, D), -1, dtype=torch.int64,
                                 device=dev), last[:, :-1]], dim=1)
    valid = last >= 0
    idx = last.clamp(min=0).reshape(C, -1)
    dmin = torch.gather(xs[..., 0], 1, idx).reshape(C, nb, D)
    dmax = torch.gather(xs[..., -1], 1, idx).reshape(C, nb, D)
    r = torch.tensor(float(np.float32(rel_tol)), dtype=torch.float32,
                     device=dev)
    t = (dmax - dmin) * r
    xmin, xmax = xs[..., :1], xs[..., -1:]
    gate = valid & (xmin >= dmin - t) & (xmin <= dmin + t) \
        & (xmax >= dmax - t) & (xmax <= dmax + t)
    return int(valid.sum()), int(gate.sum())


def time_k1(torch, dev, codec, pay):
    """K1 on one feed ``pay`` (C, nb, n) from an empty dictionary, with
    ``codec``'s D, d_crit and rel_tol."""
    from repro_torch.core.encoder import init_state
    from repro_torch.kernels import encode_step as k1
    C, nb, n = pay.shape
    D = codec.num_dict
    xs = torch.sort(torch.as_tensor(pay, dtype=torch.float32, device=dev),
                    dim=-1).values
    valid = torch.ones((C, nb), dtype=torch.bool, device=dev)
    st = init_state(D, n, channels=C, device=dev)
    kw = dict(d_crit=codec.d_crit, rel_tol=codec.rel_tol)
    ms = cuda_ms(lambda: k1.encode_scan(xs, valid, st, **kw), reps=5)
    got, gst = k1.encode_scan(xs, valid, st, **kw)
    plain_ms = cuda_ms(lambda: k1.encode_scan_torch(xs, valid, st, **kw),
                       reps=1)
    want, wst = k1.encode_scan_torch(xs, valid, st, **kw)
    err = max(float((a.double() - b.double()).abs().max())
              for a, b in zip((*got, *gst), (*want, *wst)))
    rows, gated = k1_work(torch, xs, got[0], D, codec.rel_tol)
    nbytes = (xs.numel() * 4 + valid.numel()
              + 2 * C * (D * n * 4 + D * 9 + 4) + C * nb * 6)
    ops = rows * K1_GATE_OPS + gated * K1_KS_OPS_PER_SAMPLE * n
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / PEAK_OPS["f32"] * 1e3
    return {
        "ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
        "shape": {"C": C, "nb": nb, "n": n, "D": D},
        "valid_rows": rows, "gated_rows": gated, "bytes": nbytes, "ops": ops,
        "misses": int((~got[0]).sum()), "overwrites": int(got[2].sum()),
    }


def time_k2(torch, dev, rows, width):
    from repro_torch.kernels import seq_cumsum as k2
    rng = np.random.default_rng(11)
    x = rng.normal(0, 0.05, (rows, width))
    x[:, 0] = -0.0
    xt = torch.from_numpy(x).to(dev)
    ms = cuda_ms(lambda: k2.seq_cumsum(xt), reps=20)
    got = k2.seq_cumsum(xt)
    plain_ms = cuda_ms(lambda: k2.seq_cumsum_torch(xt), reps=3)
    want = k2.seq_cumsum_torch(xt)
    library_ms = cuda_ms(lambda: torch.cumsum(xt, dim=1), reps=20)
    nbytes = 2 * xt.numel() * 8
    ops = rows * (width - 1)
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / PEAK_OPS["f64"] * 1e3
    return {
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "max_abs_err": float((got - want).abs().max()),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "shape": {"R": rows, "P": width, "dtype": "float64"},
    }


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "tests"))
    import repro_torch  # noqa: F401  (fails outside a checkout)

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    say(f"[device] {kind} x{torch.cuda.device_count()}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}; {card}")

    phase_build()
    phase_k1(torch, dev)
    phase_k2(torch, dev)
    phase_golden(dev)
    launches, first_chunks = phase_main(torch, dev, card)

    from repro_torch.core.decode import _pow2
    k1_main = time_k1(torch, dev, *first_chunks["MAG"])
    k1_ang = time_k1(torch, dev, *first_chunks["ANG_delta"])
    mag_codec, mag_pay = first_chunks["MAG"]
    k1_turn = time_k1(torch, dev, mag_codec,
                      turnover(*mag_pay.shape, seed=5))
    nb_ang = SAMPLES // CONFIGS["ANG_delta"]["block_size"]
    k2_main = time_k2(torch, dev, _pow2(nb_ang),
                      CONFIGS["ANG_delta"]["block_size"] - 1)
    for name, t in (("K1 MAG", k1_main), ("K1 ANG", k1_ang),
                    ("K1 turnover", k1_turn), ("K2 ANG_delta", k2_main)):
        say(f"[timing] {name} {json.dumps(t)} [{card}]")
        check(t["max_abs_err"] == 0.0,
              f"{name}: kernel == plain version at the timed shape "
              f"(max_abs_err {t['max_abs_err']})")
    check(k1_turn["overwrites"] > 0,
          f"turnover traffic turns the dictionary over "
          f"({k1_turn['overwrites']} overwrites)")

    def entry(name, source, replaces, t, n_launch):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": n_launch,
                "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"]}

    kernels = {"kernels": [
        entry("encode_step", "src/repro_torch/csrc/encode_step.cu",
              "src/repro/kernels/encode_step.py:306", k1_main,
              launches["encode_step"]),
        entry("seq_cumsum", "src/repro_torch/csrc/seq_cumsum.cu",
              "src/repro/kernels/seq_cumsum.py:58", k2_main,
              launches["seq_cumsum"]),
    ]}
    say(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
