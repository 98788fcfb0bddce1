#!/usr/bin/env python3
"""Drive the PyTorch port of IDEALEM on one CUDA card: build, check, time.

It drives the port's paths: the codec round trip with its indexed store,
serving services, network front end and scale-out encode (phases 3-17),
the LM serve path (phases 18-20), the LM trainer (phase 21), the dry
run's cost counter (phase 22) and the user entry points (phase 23: the
examples and the KS cross-check).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each fatal on failure (no failure is caught):

1. device  -- a CUDA card must be present; prints its name and power limit.
2. build   -- compiles every kernel of ``src/repro_torch/csrc`` with nvcc
              for sm_90a (one process per source, in parallel).
3. K1      -- the fused encode scan against its plain version on the card:
              D in {1, 9, 255}, n in {7, 32, 111}, the min/max and KS
              ablations, a ragged block mask, plus one dictionary too large
              for shared memory, traffic that turns the dictionary over,
              and blocks with ties, -0.0/+0.0, +-inf and NaN tails
              (carries compared bit for bit); and the error-bounded mode
              (std and cumulative) at D=255, n=111 (sorted and raw
              dictionaries fill shared memory to its edge) and at n=256
              (global memory).  With the chan operand (adaptive cohorts):
              lanes of widths n-3..n padded with +inf, per-lane d_crit,
              error metric and armed gate, NaN/+-inf/-0.0 blocks with and
              without the eq. 3 gate, both dictionary layouts, and rows
              stored at width n-1 with NaNs, grown to n ([.., NaN, +inf])
              and queried by candidates with +inf inside their width.
              Decisions and final carry must be equal.
4. K2      -- the sequential cumsum against its plain version and against
              ``np.cumsum`` of the host copy, bitwise, in f64/f32/f16 with a
              leading -0.0; ragged R (1, 63, 65, 16383) x P (1, 2, 111,
              255, 1024), as views whose storage offset (3 elements) is
              not 16-byte aligned and as aligned tensors.
5. K3      -- the dict_match kernel against its plain version, bitwise:
              C in {1, 64} x D in {1, 8, 9, 255} x n in {7, 32, 111, 256},
              rows in stored (unsorted) order with one equal to the
              candidate (distance 0), rows on the eq. 3 gate's boundary,
              f16/bf16 operands; on sorted rows its distances also equal
              K1's plain KS.  Rows with NaNs of both signs, +-inf, +-0.0 and
              ties, stored and sorted, against sorted and unsorted
              candidates, up to n = 4096.
6. golden  -- the 8 streams of ``tests/golden`` encode byte for byte with
              ``backend="cuda"``; their cuda decode equals the host decode.
7. main    -- the paper's Table I configurations (MAG std B=32; ANG
              residual and delta B=112; D=255, alpha=0.01) on 64 channels of
              synthetic PMU traffic (the reference package's uPMU stand-ins,
              event rates kept), the first 4 of 16 chunks of 65,536 f64
              samples fed to ``codec.session(channels=64)`` and decoded on
              the card channel by channel.  Launch counts are zeroed just before
              each path and read just after.  Checks: exact miss
              blocks (std) or block bases (residual/delta) and tails; cuda
              decode == numpy decode; K1's decisions on 4 channels == the
              plain scan on the card; the first 2,048 blocks of one channel
              == the numpy oracle; chunked == one-shot decode.  Then the
              same encode and decode again under ``torch.profiler``: the
              card's busy share and device time by kernel name.
8. ops     -- MAG with ``matcher="ops"`` (K3 once per block step), the
              first 4 of 16 chunks (2**18 samples a channel; all 16 before
              phase 15, 8 before phase 22 took the room): the streams must
              equal the fused streams of the same chunks byte for byte,
              with one K3 launch per block stepped and no K1 launch.
9. bound   -- the error-bounded mode on ``backend="cuda"``, all 16 chunks
              (2**20 samples a channel): MAG with
              ``error_bound``, ANG_delta with ``error_bound_rel``.  Every
              channel decodes within the bound (circular for ANG) up to the
              gate's float32 rounding; cuda decode == numpy decode; K1's
              decisions on 4 channels == the plain scan on the card.
10. store  -- the indexed store, per Table I configuration at 64 channels
              x 2**20 samples: a ``codec.session(channels=64,
              container=True)`` fed all 16 chunks on ``backend="cuda"``;
              the container copied into a file (a temporary directory)
              through ``ContainerWriter(path)`` and read back with
              ``Container.open(path, mmap=True)``; a full
              ``decode_channels`` read; 4,096 range requests (seed 17:
              channel uniform, length log-uniform over 1..4,096 blocks,
              start uniform) in calls of 256 through ``decode_ranges``
              (``numpy``: the first 2 calls).
              Checks: the container's 4 plain channels == a plain
              session's bytes; mmap == in memory; cuda reads == numpy
              reads bitwise, == ``decode_stream`` on the plain channels,
              miss blocks (std) or bases (residual/delta) and tails exact;
              every range == its slice of the full read; one K2 launch a
              read call on ANG_delta, none elsewhere, no K1 on reads; a
              one-block range deep in a channel walks one chunk, a
              two-block range across a segment boundary two; the port's
              ``obs.selfcheck`` is clean and its request, block and
              cuda-call counters equal the phase's own counts.  Prints the
              container's bytes, index share and ratio, encode MB/s, full
              and range read MB/s and requests/s on cuda and numpy, and a
              ``[profile]`` line of one 256-request read.
11. auto   -- ``matcher="auto"`` resolved on the card at the MAG and ANG
              shapes: the probe's times and choice; the choice decides the
              first feed as the fused scan does.
12. adaptive -- ``IdealemCodec(adaptive=True)`` (the MAG configuration,
              the default SelectorConfig) on 64 channels, MAG traffic on
              the even ones and ANG traffic on the odd ones, all 16 chunks:
              the ANG lanes switch to delta (width 31) beside the std MAG
              lanes (32), and each feed is one K1 launch with its chan
              operand.  Checks: one K1 launch per feed and no K3 launch;
              switches happened and a dispatch held both widths; the
              streams equal the per-channel loop's
              (``REPRO_TORCH_ADAPTIVE_LOOP=1``, one static K1 launch per
              channel a feed) byte for byte; four lanes of the first mixed
              dispatch (two switched) equal ``encode_decisions_mixed_np``
              on its padded float32 cohort; the first 4 feeds of 4
              channels equal ``backend="torch"`` (the plain mixed scan);
              cuda decode == numpy decode on every channel; a run at
              ``error_bound=3.0`` holds the bound on every channel, its
              delta lanes on the cumulative gate.  Prints MB/s, hit rate,
              switches by channel kind, the selectors' and the staging's
              host seconds and a ``[profile]`` line of the encode.
13. coalesce -- a fleet of PMU streams through one ``StreamCoalescer`` on
              ``backend="cuda"``, per Table I configuration: 256 streams of
              2**18 f64 samples (64 joining a round: the slot table grows
              64 -> 128 -> 256 under a live carry), chunks of a seeded
              6,000-10,000 samples submitted round robin
              (``FlushPolicy(max_batch_blocks=65536)``, ``block_bucket``
              32), 16 streams replaced by new ids midway.  Checks: one K1
              launch a flush that holds blocks; 16 seeded streams == a
              per-stream ``CompressionService(backend="cuda")`` fed the
              runs the flushes cut, the first 4 == ``backend="numpy"``;
              lengths, tails and miss blocks (std) or bases exact.  Prints
              flushes, ``nb_pad`` a flush, MB/s, ratio, the host seconds
              in ``prepare``/``commit`` and a ``[profile]`` line.
14. coalesce-adaptive -- 64 adaptive streams (the MAG configuration,
              MAG traffic on even rows, ANG on odd) of 2**18 samples, the
              same chunking, a flush a round: one K1 launch with its chan
              operand a flush; every stream == a per-stream adaptive
              session fed the same runs.
15. shard  -- the scale-out encode through encode plans of 4 shards on the
              visible cards round robin (``cuda:0`` four times on one
              card): the main phase's sessions with a channel plan (16
              channels a shard), streams == phase 7's and K1 == feeds x
              shards; MAG and ANG_delta at 2**16 samples with the
              dictionary split over 2 and 4 shards (D=255 padded to 256,
              a pad row on the last shard), and MAG ``error_bound=3.0`` over
              2: streams == the unplanned fused session's, K3 == block
              steps x shards, no K1, K3 == its plain version on every
              shard's final rows; phase 12's adaptive session through a
              channel plan: streams == phase 12's, one K1 chan launch a
              shard a feed; a planned ``StreamCoalescer`` of 64 slots a
              Table I configuration (64 streams of 2**18): streams == the
              unplanned coalescer's, K1 == flushes x shards.  A
              ``[profile]`` line of 64 dictionary-sharded block steps
              (K3's and the cross-shard minimum's device ms).
16. service -- the three containers of phase 10 attached to a
              ``DecompressionService``, its 4,096 range requests submitted
              one by one with ``FlushPolicy(max_batch_streams=256)`` at
              pipeline depth 1 and 2 on ``backend="cuda"``, at depth 2 on
              ``backend="auto"`` (prints ``autotune_choices()``), and on
              ANG_delta with the container attached under two ids.
              Checks: every answer == phase 10's ``decode_ranges`` on cuda
              bitwise, and on numpy for its first 512; K2 launches == the
              ANG_delta cuda units; two attaches dispatch as one.  Prints
              requests/s, MB/s, dispatches, padded / requested rows, chunk
              cache hits and misses, the four stage seconds and a
              ``[profile]`` line.
17. frontend -- the multi-tenant front end on the card: one
              ``ServeFrontend(device="cuda", decode_backend="cuda")`` on
              127.0.0.1, ticker and control loop on (its deadline bound
              0.1 s), the coalesce phase's flush policy with a 10 ms
              deadline.  8 tenants, each its own keep-alive
              ``FrontendClient``, closed loop; per tenant and
              Table I configuration 1 direct and 8 coalesced streams (216)
              of 2**17 f64 samples, each its own PMU channel, seeded
              chunks of 6,000-10,000 samples round robin, every fourth
              request of a tenant a 4-line JSON-lines ``/v1/feed``;
              tenant 0's direct MAG stream on ``matcher="ops"``; a ninth,
              noisy tenant under the load generator's bytes/s quota.  Each
              tenant then packs its 3 direct streams, attaches them over
              ``/v1/attach`` and reads 64 ranges of each (seed 19: start
              uniform, 1..256 blocks log-uniform), 16 in flight.  Launch
              counts are zeroed just before and read just after.  Checks:
              direct streams == a ``cuda`` shadow session fed the same
              chunks (tenant 0's also == ``numpy``; the ``ops`` stream ==
              the fused shadow); coalesced streams decode == the one-shot
              decode of their traces, miss blocks (std) or bases and tails
              exact; every answer == its slice of the full ``cuda`` and
              ``numpy`` decodes bitwise; K1 == whole-block direct ``cuda``
              feeds + coalescer flushes, K3 == the ``ops`` stream's block
              steps, K2 == the ANG_delta ``cuda`` dispatches; the noisy
              tenant's lines get typed ``rate_limited`` (429) documents
              and ``/metrics`` counts them (``obs.parse_prometheus``);
              p99 of ``POST /v1/feed`` <= 0.5 s and of ``POST
              /v1/decode`` <= 1.0 s.  Prints feed requests/s
              and MB/s in, decode requests/s, ratio by configuration, p50
              and p99 by route, the launches, the control loop's final
              policy and moves, and a ``[profile]`` line of one ingest
              window (each tenant's first 27 feed requests, a fresh
              server).  Then the port's load
              generator (``python -m repro_torch.launch.loadgen --tenants
              8``) in its own process must report ok.
18. K4     -- the flash_decode kernel against its plain version on the
              card, within 1e-5: the JAX test's shapes, C in {1, 33, 700,
              2048}, G in {1, 4, 16}, hd in {64, 128}, f32/bf16/f16 caches,
              rows masked by ``decode_attention``'s ring formula (plain,
              windowed, wrapped) and one row with no valid position (the
              mean of V); shapes split along C with a ragged last split,
              G=6 in head groups and C=32,768 at B=1.  Prints the split
              counts.
19. serve  -- granite-3-8b at full width (weights from a seeded
              ``torch.Generator``) through ``ServeEngine.generate``: 8
              numpy-seeded prompts of 256 tokens, 16 greedy tokens (64
              before phase 20 took the room), max_seq 2048.  Checks: one
              K4 launch per layer and step (10,880); K4 == its plain
              version on the last layer's
              operands of the last step; over 32 teacher-forced steps the
              ``backend="cuda"`` logits within ``SERVE_LOGIT_TOL`` of
              ``backend="torch"``; ``prefill_step`` (the forward) at the
              last forced position within the reference's
              decode-vs-forward contract (atol 0.75, rtol 0.1).  Prints
              weight and peak GB, prefill and decode tokens/s, ms per
              decode step, a ``torch.profiler`` trace of 16 decode steps
              (device operations a step; K4's and its combine kernel's
              device ms), and the host's milliseconds to issue those steps
              unprofiled beside their wall time.
20. families -- the other decode families at published widths, one at
              a time (each freed before the next), weights from a seeded
              ``torch.Generator``, through ``ServeEngine.generate``: 8
              numpy-seeded prompts of 64 tokens, 16 greedy tokens, max_seq
              512 (``FAMILIES``): granite-moe-1b-a400m, rwkv6-3b,
              zamba2-1.2b (38 layers, 6 shared-attention applications),
              whisper-tiny (4 + 4 encoder layers, cross caches of 1,500)
              and gemma3-27b (62 layers, 52 local with rings of 512
              positions) at full depth, mixtral-8x22b at 4 of 56 layers and
              llama-3.2-vision-90b at 10 of 100 (cross caches of 1,024):
              one card's 80 GB.  Checks, each fatal: the FULL config's
              parameter count (meta device) == the reference's; K4
              launches == self-attention layers x steps (0 for RWKV6); K4
              == its plain version on the last self-attention layer's
              operands; over 16 teacher-forced steps ``backend="cuda"``
              logits within ``SERVE_LOGIT_TOL`` of ``"torch"`` (in float32
              for rwkv6, zamba2 and mixtral: see ``FAMILIES``); the
              forward against the decode (float32 argmax agreement above
              0.9 for rwkv6 and zamba2, the bfloat16 contract at the last
              forced position for the others, a MoE's forward at a
              capacity that drops no copy); whisper's encoder output
              finite; logits finite and tokens in range.  Prints weight
              and peak GB, prefill and decode tokens/s, ms a decode step,
              device operations a step from a card-only trace of 8 steps,
              the host's ms to issue them, and each part's seconds.
              ``[banded]``, on gemma3-27b's weights: one local layer's q, k,
              v at B=1, S=8,192 (window = chunk = 1,024) through
              ``_flash_banded`` (16 chunk pairs) and the unbanded chunk loop
              (64), within ``BANDED_TOL``, both timed; the whole model's
              forward at S=4,096 with every local layer on the banded path:
              finite logits, seconds and tokens/s.
21. train  -- granite-moe-1b-a400m at published widths: (a) 24 of 24
              layers, 3 steps of ``make_train_step`` (8 x 128 tokens, 2
              microbatches, lr 1e-3) on float32 masters, finite losses;
              loss, grad_norm, ms a step, peak GB, and device operations a
              step from a card-only trace of one step; (b) the SMOKE
              config's first step in float32 on the card and on the CPU
              from one state, TF32 off: loss, grad_norm, gradient
              leaves (mu) and parameters within 1e-4 (relative); (c) ``python -m repro_torch.launch.train``'s
              ``main`` with ``--gradcomp``, 5 steps, a checkpoint every 2,
              a crash injected at step 3, at 2 of 24 layers (a checkpoint
              holds ~16 B a parameter: ~2.5 GB against ~21 GB at full
              depth), checkpoints in a temporary directory removed after:
              the log restores from step 2 and ends at step 5 with finite
              losses; one K1 launch a train step run (the gradient's
              encode scan); K1's decisions on the first 4,096 blocks of
              the flattened gradient == the plain scan on the card,
              bitwise.  Prints the checkpoint's bytes (reckoned and on
              disk), hit rate, wire ratio and seconds a compress.
22. dryrun -- the dry run: (a) ``python -m repro_torch.launch.dryrun`` on
              the reference test's four SMOKE cells (granite-3-8b
              train_4k multi, granite-moe-1b-a400m train_4k single,
              rwkv6-3b long_500k multi, zamba2-1.2b decode_32k single)
              and one FULL cell a mesh (granite-3-8b decode_32k single,
              gemma3-27b long_500k multi), each in its own process
              without the card, all at once: every record ``ok``, FLOPs
              and bytes above 0, 256 or 512 chips; prints each cell's
              per-chip FLOPs, bytes, wire bytes by kind and trace
              seconds.  (b) the cost counter around a meta trace of
              granite-3-8b's ``decode_step`` at [serve]'s shape (40
              layers, B=8, a 2,048-position cache, bf16) against the
              same step on the card (K4 40 launches): FLOPs and bytes
              equal, the arguments reckoned on meta equal to what the
              card's allocation grew by within 512 B a tensor; and one
              train step of granite-moe-1b-a400m at 2 of 24 layers, 8 x
              128 tokens, 2 microbatches, meta against the card: FLOPs
              and bytes equal.  (c) ``python -m
              repro_torch.launch.reanalyze`` over the six records and
              their op logs: every rewritten field equal to what the
              trace wrote.
23. examples -- the user entry points as a user runs them, each in its
              own process, all at once on the card: the five
              ``examples_torch/*.py`` (quickstart at its own size, the
              others at small sizes; ``serve_lm.py``
              for rwkv6-3b, its default, and for granite-3-8b's SMOKE
              config, which runs K4; ``train_lm.py`` with ``--gradcomp
              --inject-crash``) and ``python -m
              repro_torch.launch.ks_crosscheck`` on cuda.  Each exits 0
              and prints its own verdict (byte-identical wire bytes, the
              restore, tokens in the vocabulary, PASS); each reports the
              K1/K2/K3/K4 launches of its process, added to the kernels
              line.
24. timing -- each kernel at a main-path shape against its plain version
              (equal, K4 within 1e-5, else fatal), its bound and (K2)
              ``torch.cumsum``, (K4) ``scaled_dot_product_attention``; K1
              also on a MAG-shaped feed that turns the dictionary over and,
              with the error bound, at the ANG_delta feed shape, and with
              its chan operand at the adaptive feed shape (C=64, nb=2048,
              n=32, half the lanes at width 31: ``K1 mixed``); K3 at the
              MAG and ANG step shapes, rows sorted (as the ops path passes
              them) and in random order, with its launch plan (CTAs), and
              at C=1, D=1, n=32 (the launch floor); K2 in f64 (the decode's
              type), f32 and f16, and on its operands of the store's
              ANG_delta reads (one 256-request call and the full read),
              bitwise against its plain version and ``np.cumsum``; K4 at
              the serve shape and at a 32k context (with its split
              count); K1 also in microseconds a
              block step; prints the ``{"kernels": [...]}`` line.

Prints the card line (``nvidia-smi --query-gpu=name,power.limit``) and, last,
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import asyncio
import contextlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

CHANNELS, SAMPLES, CHUNKS = 64, 2 ** 20, 16
# The fused main path (phase 7) runs the first quarter of the feeds, to
# keep the run short; the paths added after it run all 16 but [ops]
# (below).
MAIN_CHUNKS = 4
# [ops] (phase 8) runs the first half of the feeds: phase 15's
# dictionary-sharded scans took the room in the script's time budget.
OPS_CHUNKS = 8
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
# The paper's Table I, the port's ``configs/idealem_paper.py`` (copies: a
# rehearsal may shrink ``num_dict`` in place).  Outside a checkout this
# import fails, and the script prints no result.
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.configs import idealem_paper  # noqa: E402

CONFIGS = {"MAG": dict(idealem_paper.MAG),
           "ANG_residual": dict(idealem_paper.ANG_RESIDUAL),
           "ANG_delta": dict(idealem_paper.ANG_DELTA)}
# NVIDIA H100 SXM data sheet: HBM3 3.35 TB/s; 67 TFLOP/s f32 and 34 TFLOP/s
# f64 outside the tensor cores.
HBM_BPS = 3.35e12
PEAK_OPS = {"f32": 67e12, "f64": 34e12}
# A compare is one instruction where the 67 TFLOP/s counts an FMA as two
# operations: half that rate.
PEAK_COMPARES = PEAK_OPS["f32"] / 2
# K1 operation count per dictionary row and block: the eq. 3 gate (one
# difference, one product, two sums, two differences, four compares) for
# every valid row; for every gate-passing row the KS distance, about 12 f32
# operations per sample (two ECDF products, a difference, an abs and a max
# for each of the two gaps, and the merge compares) and, with the error
# bound, 3 per sample (a difference, the running sum, a compare).
K1_GATE_OPS, K1_KS_OPS_PER_SAMPLE, K1_EB_OPS_PER_SAMPLE = 10, 12, 3
# The error-bounded runs: MAG with an absolute bound in its own units,
# ANG_delta with a bound relative to the [0, 360) range (0.18 degrees; at
# 0.36 degrees this traffic's phase noise stays inside the bound and almost
# nothing is demoted).
BOUNDS = {"MAG": dict(error_bound=3.0),
          "ANG_delta": dict(error_bound_rel=5e-4)}
# tests/test_error_bounded.py's allowance for f32 rounding on top of the
# bound, relative to the bound
EB_SLOP = 1e-4
# The store phase: range reads an analyst makes of archived telemetry,
# issued STORE_BATCH to a decode_ranges call.
STORE_REQUESTS, STORE_BATCH, STORE_MAX_BLOCKS = 4096, 256, 4096
# backend="numpy" reconstructs each call's padded batch (~2**20 rows) on
# the host, ~6 s a call on ANG: it is timed on the first calls only.
STORE_NUMPY_CALLS = 2
# The coalesce phases: a fleet of 120 Hz PMU channels ingesting through one
# StreamCoalescer (FlushPolicy's default max_batch_streams), each stream
# submitting chunks of a seeded length in COALESCE_CHUNK samples.  The slot
# table starts at COALESCE_CAPACITY and grows; COALESCE_RECYCLED streams
# are replaced by new ids midway.
COALESCE_STREAMS, COALESCE_SAMPLES = 256, 2 ** 18
COALESCE_CHUNK = (6000, 10000)
COALESCE_CAPACITY, COALESCE_RECYCLED = 64, 16
COALESCE_MAX_BLOCKS, COALESCE_BUCKET = 65536, 32
COALESCE_CHECKED, COALESCE_ORACLE = 16, 4
COALESCE_ADAPTIVE_STREAMS = 64
COALESCE_PROFILE_ROUNDS = 6
# The shard phase: encode plans of SHARD_SHARDS shards on the visible cards
# round robin (all on cuda:0 on a one-card machine); the dictionary-sharded
# runs take SHARD_D_SAMPLES a channel at each of SHARD_DICT_SHARDS, and the
# profiler traces the first SHARD_PROFILE_STEPS block steps of one; the
# planned coalescer holds SHARD_COALESCE_STREAMS slots.  The
# dictionary-sharded runs encode turnover traffic, so that every channel's
# FIFO wraps and hits land on every dictionary shard; ANG_delta's deltas
# are its levels at SHARD_DEGREES_PER_LEVEL degrees each.
SHARD_SHARDS, SHARD_DICT_SHARDS, SHARD_D_SAMPLES = 4, (2, 4), 2 ** 16
SHARD_DEGREES_PER_LEVEL = 0.25
SHARD_PROFILE_STEPS, SHARD_COALESCE_STREAMS = 64, 64
# The service phase: [store]'s range requests through DecompressionService
# (FlushPolicy(max_batch_streams=SERVICE_STREAMS)); the profiler traces
# the first SERVICE_PROFILED of them.
SERVICE_STREAMS, SERVICE_PROFILED = 256, 512
# The frontend phase: a fleet of tenants behind one ServeFrontend on the
# card, each with a direct and FRONTEND_COALESCED coalesced streams per
# Table I configuration of FRONTEND_SAMPLES (chunks of COALESCE_CHUNK),
# every FRONTEND_LINES_EVERY-th request of a tenant a FRONTEND_LINES-line
# JSON-lines /v1/feed; then FRONTEND_DECODES range reads per container
# (seed 19: start uniform, 1..FRONTEND_DECODE_BLOCKS blocks log-uniform),
# FRONTEND_INFLIGHT in flight per tenant.  The noisy tenant is the load
# generator's; the SLOs are its defaults (p99 seconds by route).
FRONTEND_TENANTS, FRONTEND_COALESCED, FRONTEND_SAMPLES = 8, 8, 2 ** 17
FRONTEND_LINES_EVERY, FRONTEND_LINES = 4, 4
FRONTEND_DECODES, FRONTEND_INFLIGHT, FRONTEND_DECODE_BLOCKS = 64, 16, 256
FRONTEND_PROFILE_ROUNDS = 1
FRONTEND_SLOS = {"POST /v1/feed": 0.5, "POST /v1/decode": 1.0}
# The control loop may stretch the flush deadline (max_age_s) up to this
# bound.  A decode request waits for its batch's deadline, so the bound is
# kept at a tenth of the decode SLO: at the loop's default 0.5 s the
# deadline alone is half the SLO, and stalls of the shared event loop
# (other tenants' handlers and flushes) took the decode p99 to 0.96 s
# on an H100.
FRONTEND_MAX_AGE_S = 0.1
# The serve phase: granite-3-8b at full width, a few requests of a
# realistic prompt length at the engine's default max_seq.
# SERVE_GEN was 64 before the families phase took the room.
SERVE_ARCH, SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = "granite-3-8b", 8, 256, 16
SERVE_MAX_SEQ = 2048
# Teacher-forced steps compared between the K4 and plain attention cores,
# and decode steps traced under the profiler.
SERVE_FORCED, SERVE_PROFILED = 32, 16
# K4 vs its plain version: both compute in float32 and differ in the order
# of their sums only.
K4_TOL = 1e-5
# backend="cuda" vs backend="torch" logits over SERVE_FORCED teacher-forced
# steps: the two attention cores agree to ~1e-7 in float32, but their
# outputs are rounded to bfloat16 before wo, so an output that lies near a
# bfloat16 rounding boundary lands one bfloat16 ulp (2**-8 relative) apart,
# and such differences pass through 40 residual layers into the logits.
SERVE_LOGIT_TOL = 0.25
# The families phase: the other decode families at published widths, a few
# requests each (gemma3-27b since its banded prefill was ported).  (arch, layers run or None for the full depth, the FULL
# config's parameter count as the reference counts it).  Mixtral's experts
# and the VLM's layers do not fit one card's 80 GB at full depth: 4 of 56
# layers hold ~21 GB of bfloat16 experts, 10 of 100 (two super-blocks of
# four self-attention layers and a cross layer) ~26 GB.
# The last field is the dtype in which backend="cuda" and "torch" logits
# are compared over the forced steps.  bfloat16 where the model allows it,
# as [serve] does; float32 where one bfloat16 ulp between the two
# attention cores' outputs grows past SERVE_LOGIT_TOL: the recurrent
# families (the reference runs their decode checks in float32; zamba2's
# bfloat16 logits moved 0.335, SSM states carrying the ulp through 38
# layers) and mixtral (0.989: the ulp flipped a top-2 routing choice), both
# on an NVIDIA H100 80GB HBM3 at 700 W.  granite-moe's bfloat16 logits
# stayed within 0.121.
FAMILIES = (("granite-moe-1b-a400m", None, 1_334_628_352, "bfloat16"),
            ("rwkv6-3b", None, 2_905_541_120, "float32"),
            ("zamba2-1.2b", None, 1_104_777_344, "float32"),
            ("whisper-tiny", None, 36_439_680, "bfloat16"),
            ("mixtral-8x22b", 4, 140_630_071_296, "float32"),
            ("llama-3.2-vision-90b", 10, 87_666_794_496, "bfloat16"),
            ("gemma3-27b", None, 19_840_778_496, "bfloat16"))
FAMILY_BATCH, FAMILY_PROMPT, FAMILY_GEN, FAMILY_MAX_SEQ = 8, 64, 16, 512
FAMILY_FORCED, FAMILY_PROFILED = 16, 8
# The banded check, on gemma3-27b's weights while [families] holds them:
# one local layer's q, k, v at B=1, S=8,192 (window and chunk 1,024)
# through _flash_banded and the unbanded chunk loop; both take float32
# products of the same bfloat16 operands and round their outputs to
# bfloat16, in another order of the online softmax, so they may land up to
# a bfloat16 ulp apart at magnitudes below 2 (2**-7): the tolerance allows
# two.  Then the whole model's forward at S=4,096, where every local layer
# takes the banded path.
BANDED_ARCH, BANDED_S, BANDED_FORWARD_S = "gemma3-27b", 8192, 4096
BANDED_TOL = 2.0 ** -6
# The train phase: granite-moe-1b-a400m (the reference launcher's default
# architecture) at published widths.  (a) full depth, the launcher's
# batch: TRAIN_STEPS steps of make_train_step on float32 masters (~21 GB
# of parameters, gradients and moments).  (b) the first step of the SMOKE
# config in float32 on the card and on the CPU from one state, TF32 off:
# loss, grad_norm, each gradient leaf (AdamW's mu after one step) and each
# parameter leaf within TRAIN_REL_TOL of the CPU's (a leaf's relative to
# its largest magnitude).  (c) the launcher's fault-tolerant run
# with --gradcomp at TRAIN_FT_LAYERS of 24 layers: each checkpoint holds
# the whole state, ~16 B a parameter (params, moments, residual), ~21 GB
# at full depth against ~2.5 GB at two layers; a crash at step
# TRAIN_FT_CRASH restores the checkpoint of step 2.
TRAIN_ARCH, TRAIN_PARAMS = "granite-moe-1b-a400m", 1_334_628_352
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, TRAIN_LR, TRAIN_STEPS = 8, 128, 2, 1e-3, 3
TRAIN_REL_TOL = 1e-4
TRAIN_FT_LAYERS, TRAIN_FT_STEPS, TRAIN_FT_EVERY, TRAIN_FT_CRASH = 2, 5, 2, 3
# blocks of the flattened gradient whose K1 decisions are held against the
# plain scan on the card
TRAIN_PREFIX_BLOCKS = 4096
# [dryrun] (22.): the reference test's four SMOKE cells and one FULL cell a
# mesh through ``python -m repro_torch.launch.dryrun``, each in its own
# process (its own fake process group, no card); then the cost counter
# around a meta trace and a card run of granite-3-8b's decode at
# [serve]'s shape and of granite-moe's train step at [train]'s batch
DRYRUN_SMOKE = (("granite-3-8b", "train_4k", "multi"),
                ("granite-moe-1b-a400m", "train_4k", "single"),
                ("rwkv6-3b", "long_500k", "multi"),
                ("zamba2-1.2b", "decode_32k", "single"))
DRYRUN_FULL = (("granite-3-8b", "decode_32k", "single"),
               ("gemma3-27b", "long_500k", "multi"))
DRYRUN_TIMEOUT = 300
# [examples] (23.): each entry point in its own process, all at once
# (quickstart at its one size, the others small); (name, argv after ``python``, the kernels it must launch,
# a line its output must hold; none may print ": False")
EXAMPLES = (
    ("quickstart", ["examples_torch/quickstart.py"], ("encode_step",),
     "[minmax]   big jumps"),
    ("stream_compress", ["examples_torch/stream_compress.py", "--channels",
                         "16", "--samples", "8192"],
     ("encode_step",), "decode identically to one-shot encode"),
    ("serve_frontend", ["examples_torch/serve_frontend.py", "--tenants", "2",
                        "--samples", "8192"],
     ("encode_step",), "byte-identical to the local session: True"),
    ("serve_lm rwkv6-3b", ["examples_torch/serve_lm.py", "--gen", "16"],
     (), "in [0, 128): True"),
    ("serve_lm granite-3-8b", ["examples_torch/serve_lm.py", "--arch",
                               "granite-3-8b", "--gen", "16"],
     ("flash_decode",), "in [0, 128): True"),
    ("train_lm", ["examples_torch/train_lm.py", "--steps", "16", "--batch",
                  "4", "--seq", "64", "--gradcomp", "--inject-crash", "6"],
     ("encode_step",), "'event': 'restore'"),
    ("ks_crosscheck", ["-m", "repro_torch.launch.ks_crosscheck"], (),
     "ks_crosscheck (cuda): PASS"),
)
EXAMPLES_TIMEOUT = 300
# runs an entry point as ``python <argv>`` would, then prints the launch
# counts of the kernels in its process
EXAMPLE_RUNNER = """
import json, runpy, sys
argv = sys.argv[1:]
try:
    if argv[0] == "-m":
        sys.argv = argv[1:]
        runpy.run_module(argv[1], run_name="__main__", alter_sys=True)
    else:
        sys.argv = argv
        runpy.run_path(argv[0], run_name="__main__")
finally:
    from repro_torch.kernels import (dict_match, encode_step, flash_decode,
                                     seq_cumsum)
    print("LAUNCHES " + json.dumps({m.__name__.rsplit(".", 1)[1]: m.launches
          for m in (encode_step, seq_cumsum, dict_match, flash_decode)}),
          flush=True)
"""
DRYRUN_TRAIN_LAYERS = 2
# the caching allocator rounds each allocation up to 512 bytes
ALLOC_ROUND = 512

T_START = time.perf_counter()


def say(msg: str) -> None:
    """Print a line, prefixed (after its tag) with the seconds since the
    script started."""
    tag, _, rest = msg.partition("] ")
    print(f"{tag}] +{time.perf_counter() - T_START:.1f}s {rest}"
          if rest else msg, flush=True)


def check(cond, what: str) -> None:
    if not cond:
        raise AssertionError(f"check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, queued: bool = False) -> float:
    """Mean milliseconds per call of ``fn`` on the card, after one warm-up,
    from CUDA events around ``reps`` back-to-back calls.

    ``queued`` (for kernels): a spin kernel (``torch.cuda._sleep``) first
    holds the card while the host enqueues all ``reps`` calls, so the
    events time the kernels back to back and not the host's launch
    overhead between them (which exceeds a short kernel's run time)."""
    import torch
    fn()
    torch.cuda.synchronize()
    if queued:
        t0 = time.perf_counter()
        fn()
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        # >= 2e9 cycles a second at any SM clock: sleeps at least as long
        torch.cuda._sleep(int(2e9 * (2 * reps * host_s + 1e-3)))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms_once(fn):
    """``(result, milliseconds)`` of one call of ``fn`` on the card, from
    CUDA events: for plain scans, whose seconds-long runs need no warm-up
    and are too long to repeat."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


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
    check(set(times) == {"encode_step", "seq_cumsum", "dict_match",
                         "flash_decode"},
          f"built {times}")
    for name in sorted(times):
        say(f"[build] {name}.cu: {times[name]:.2f} s")
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                say(f"[build]   {line.strip()}")
    say(f"[build] all kernels in {wall:.2f} s (parallel nvcc)")


def same_bits(torch, a, b):
    """``torch.equal``, with float32 tensors compared by their bits (a NaN
    row in a carry is equal to itself)."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def special_blocks(C, nb, n, seed):
    """Mixture blocks with ties, -0.0/+0.0, +-inf and NaN tails: NaNs sort
    last and count 0 in the KS counts, an inf extreme fails the eq. 3
    gate."""
    rng = np.random.default_rng(seed)
    x = np.stack([mixture(nb, n, seed=seed + c) for c in range(C)])
    x = np.round(x, 1)                      # ties within and across blocks
    x[rng.random(x.shape) < 0.05] = 0.0
    x[rng.random(x.shape) < 0.05] = -0.0
    kind = rng.integers(0, 4, (C, nb))
    k = max(1, n // 5)
    x[kind == 1, :k] = np.nan
    x[kind == 2, 0] = np.inf
    x[kind == 3, -1] = -np.inf
    return x


def phase_k1(torch, dev):
    from repro_torch.core.encoder import init_state
    from repro_torch.kernels import encode_step as k1
    cases = [(D, n, mm, ks, "mixture") for D in (1, 9, 255)
             for n in (7, 32, 111)
             for mm, ks in ((True, True), (False, True), (True, False))]
    cases.append((255, 256, True, True, "mixture"))  # global memory
    # a dictionary that turns over; NaN/+-inf blocks (without the gate the
    # KS sees them)
    cases += [(255, 32, True, True, "turnover"),
              (9, 111, True, True, "turnover")]
    cases += [(D, n, mm, True, "special") for D, n in ((9, 7), (255, 32),
                                                        (255, 111))
              for mm in (True, False)]
    C, nb = 3, 320
    seen = np.zeros(3, dtype=np.int64)  # hits, misses, overwrites
    for i, (D, n, mm, ks, traffic) in enumerate(cases):
        if traffic == "mixture":
            blocks = np.stack([mixture(nb, n, seed=100 * i + c)
                               for c in range(C)])
        elif traffic == "turnover":
            blocks = turnover(C, 4 * nb, n, seed=i)
        else:
            blocks = special_blocks(C, nb, n, seed=100 * i)
        xs = torch.sort(torch.from_numpy(blocks).to(dev, torch.float32),
                        dim=-1).values
        nb_i = xs.shape[1]
        valid = torch.ones((C, nb_i), dtype=torch.bool, device=dev)
        valid[1, nb_i // 2:] = False
        valid[2, ::5] = False
        st = init_state(D, n, channels=C, device=dev)
        kw = dict(d_crit=(int(0.4 * n) + 0.5) / n, rel_tol=0.5,
                  use_minmax=mm, use_ks=ks)
        got, gst = k1.encode_scan(xs, valid, st, **kw)
        torch.cuda.synchronize()
        want, wst = k1.encode_scan_torch(xs, valid, st, **kw)
        what = f"D={D} n={n} mm={mm} ks={ks} {traffic}"
        for a, b, name in zip(got, want, ("is_hit", "slot", "overwrite")):
            check(torch.equal(a, b), f"K1 {name} {what}")
        for a, b, name in zip(gst, wst, gst._fields):
            check(same_bits(torch, a, b), f"K1 carry {name} {what}")
        check(not got[0][~valid].any(), "K1 masked blocks decide no hit")
        h = got[0][valid]
        seen += [int(h.sum()), int((~h).sum()), int(got[2].sum())]
    check(np.all(seen > 0), f"K1 ring saw hits/misses/overwrites {seen}")
    say(f"[K1] {len(cases)} cases equal to the plain version on the card, "
        f"turnover and NaN/+-inf blocks included (hits {seen[0]}, misses "
        f"{seen[1]}, overwrites {seen[2]})")
    phase_k1_bound(torch, dev)


def templated(C, nb, n, seed):
    """Blocks near one of 24 template blocks, half with noise 0.05 and half
    with noise 0.6: the KS test passes on most repeats, and an error bound
    between the two noise levels demotes the noisy half."""
    rng = np.random.default_rng(seed)
    tmpl = rng.normal(0, 1, (24, n))
    idx = rng.integers(0, 24, (C, nb))
    noise = np.where(rng.random((C, nb, 1)) < 0.5, 0.05, 0.6)
    return tmpl[idx] + noise * rng.normal(0, 1, (C, nb, n))


def phase_k1_bound(torch, dev):
    """K1's error-bound operands against the plain version: std and
    cumulative gates; the shared-memory edge and the global layout."""
    from repro_torch.core.encoder import init_state
    from repro_torch.kernels import encode_step as k1
    C, nb = 3, 320
    seen = np.zeros(2, dtype=np.int64)  # hits, demoted would-be hits
    for D, n, smem in ((9, 32, True), (255, 111, True), (255, 256, False)):
        check(k1.dict_in_smem(n, D, True) == smem,
              f"K1 error-bound layout D={D} n={n}: shared memory {smem}")
        for cum in (False, True):
            raw = torch.from_numpy(templated(C, nb, n, seed=D + n)).to(
                dev, torch.float32)
            xs = torch.sort(raw, dim=-1).values
            valid = torch.ones((C, nb), dtype=torch.bool, device=dev)
            valid[2, ::5] = False
            kw = dict(d_crit=(int(0.4 * n) + 0.5) / n, rel_tol=0.5)
            eb = dict(raw=raw, error_bound=3.0 if cum else 0.5,
                      error_cumulative=cum)
            st = init_state(D, n, channels=C, device=dev, raw=True)
            got, gst = k1.encode_scan(xs, valid, st, **kw, **eb)
            torch.cuda.synchronize()
            want, wst = k1.encode_scan_torch(xs, valid, st, **kw, **eb)
            what = f"K1 error bound D={D} n={n} cumulative={cum}"
            for a, b, name in zip((*got, *gst), (*want, *wst),
                                  ("is_hit", "slot", "overwrite",
                                   *gst._fields)):
                check(torch.equal(a, b), f"{what}: {name}")
            free, _ = k1.encode_scan(xs, valid, init_state(
                D, n, channels=C, device=dev), **kw)
            seen += [int(got[0].sum()), int(free[0].sum() - got[0].sum())]
    check(np.all(seen > 0), f"K1 error-bound ring saw hits/demotions {seen}")
    say(f"[K1] error bound: 6 cases equal to the plain version, raw rows "
        f"included (hits {seen[0]}, fewer than without the bound by "
        f"{seen[1]}); D=255 n=111 in shared memory, n=256 in global memory")
    phase_k1_chan(torch, dev)


def k1_pair(torch, xs, valid, st, what, **kw):
    """K1 and its plain version on the same operands: decisions and carry
    must be equal bit for bit.  Returns the kernel's result."""
    from repro_torch.kernels import encode_step as k1
    got, gst = k1.encode_scan(xs, valid, st, **kw)
    torch.cuda.synchronize()
    want, wst = k1.encode_scan_torch(xs, valid, st, **kw)
    for a, b, name in zip((*got, *gst), (*want, *wst),
                          ("is_hit", "slot", "overwrite", *gst._fields)):
        check(same_bits(torch, a, b), f"{what}: {name}")
    return got, gst


def phase_k1_chan(torch, dev):
    """K1's chan operand (the mixed-mode scan of adaptive cohorts) against
    the plain version: lanes of different widths (+inf pads), per-lane
    d_crit, error metric and armed gate; NaN/+-inf/-0.0 blocks with and
    without the eq. 3 gate; both dictionary layouts; and rows stored at a
    narrower width, grown by ``repad_state_n`` to [.., NaN, +inf] and
    queried by candidates whose +inf pads fall inside their width."""
    from repro_torch.core.encoder import chan_params, init_state, repad_state_n
    from repro_torch.kernels import encode_step as k1
    from repro_torch.testing import mixed_cohort
    C, nb = 6, 320
    cases = [(9, 16, True, None, False), (9, 16, False, None, True),
             (255, 32, True, None, True), (255, 32, False, None, True),
             (255, 111, True, None, False), (255, 111, False, None, True),
             (255, 256, True, None, False), (9, 32, True, 0.5, False),
             (255, 32, False, 0.5, True), (255, 111, True, 0.5, False)]
    seen = np.zeros(3, dtype=np.int64)  # hits, misses, demoted would-be hits
    layouts = set()
    for i, (D, n, mm, bound, nonfinite) in enumerate(cases):
        blocks, valid, nf, dc, ec, ebo = mixed_cohort(C, nb, n, seed=i,
                                                      nonfinite=nonfinite)
        raw = torch.from_numpy(blocks).to(dev)
        xs = torch.sort(raw, dim=-1).values
        vt = torch.from_numpy(valid).to(dev)
        kw = dict(d_crit=0.0, rel_tol=0.5, use_minmax=mm,
                  chan=chan_params(nf, dc, ec, ebo, dev).block())
        if bound is not None:
            kw.update(raw=raw, error_bound=bound)
        eb = bound is not None
        st = init_state(D, n, channels=C, device=dev, raw=eb)
        got, _ = k1_pair(torch, xs, vt, st, f"K1 chan D={D} n={n} mm={mm} "
                         f"bound={bound} nonfinite={nonfinite}", **kw)
        layouts.add(k1.dict_in_smem(n, D, eb, chan=True))
        h = got[0][vt]
        seen[:2] += [int(h.sum()), int((~h).sum())]
        if eb:
            free = k1.encode_scan(xs, vt, init_state(D, n, channels=C,
                                                     device=dev), **dict(
                kw, raw=None, error_bound=None))[0][0]
            seen[2] += int(free.sum() - got[0].sum())
    check(np.all(seen > 0) and layouts == {True, False},
          f"K1 chan saw hits/misses/demotions {seen}, layouts {layouts}")
    grown = 0
    for D, n in ((9, 32), (255, 32), (255, 111)):
        # feed A at width n - 1 stores rows with NaNs; the cohort grows to n
        # (lane 0 widens), the other lanes keep their width
        wa = [n - 1, n - 3, n - 2, n - 1, n - 4, n - 2]
        st = init_state(D, n - 1, channels=C, device=dev)
        for feed, widths in ((0, wa), (1, [n] + wa[1:])):
            width = n - 1 + feed
            blocks, valid, _, dc, ec, ebo = mixed_cohort(
                C, nb, width, seed=50 + D + n + feed, widths=widths,
                nonfinite=True)
            xs = torch.sort(torch.from_numpy(blocks).to(dev), dim=-1).values
            chan = chan_params(widths, dc, ec, ebo, dev).block()
            if feed:
                st = repad_state_n(st, n)
                rows = st.sorted_blocks
                # a NaN before a grown +inf: not sorted NaN-last
                bad = (torch.isnan(rows[..., :-1]) & torch.isinf(rows[..., 1:])
                       ).any(-1) & st.valid
                grown += int(bad.sum())
            _, st = k1_pair(torch, xs, torch.from_numpy(valid).to(dev), st,
                            f"K1 chan repad D={D} n={n} feed {feed}",
                            d_crit=0.0, rel_tol=0.5, use_minmax=False,
                            chan=chan)
    check(grown > 0, f"K1 chan: grown rows [.., NaN, +inf] seen ({grown})")
    say(f"[K1] chan: {len(cases)} cohorts of 6 lanes (widths n-3..n, "
        f"per-lane d_crit/error metric/gate) and 6 grown feeds equal to the "
        f"plain version (hits {seen[0]}, misses {seen[1]}, demoted "
        f"{seen[2]}; {grown} grown rows [.., NaN, +inf] queried); both "
        f"dictionary layouts")


def phase_k3(torch, dev):
    from repro_torch.kernels import dict_match as k3
    from repro_torch.kernels import ops, ref
    from repro_torch.testing import k3_special
    rng = np.random.default_rng(12)
    cases = [(C, D, n) for C in (1, 64) for D in (1, 8, 9, 255)
             for n in (7, 32, 111, 256)]
    for C, D, n in cases:
        xs = torch.sort(torch.from_numpy(rng.normal(size=(C, n))).to(
            dev, torch.float32), dim=-1).values
        rows = torch.from_numpy(rng.normal(size=(C, D, n))).to(
            dev, torch.float32)
        rows[:, 0] = xs[:, torch.randperm(n, device=dev)]  # distance 0
        lo, hi = rows.amin(-1), rows.amax(-1)
        ks, mm = k3.dict_match_cuda(xs, rows, lo, hi, 0.3)
        torch.cuda.synchronize()
        ks_p, mm_p = ref.dict_match_ref(xs, rows, lo, hi, 0.3)
        what = f"K3 C={C} D={D} n={n}"
        check(torch.equal(ks, ks_p) and torch.equal(mm, mm_p),
              f"{what}: kernel == plain version (stored order)")
        check(not ks[:, 0].any(), f"{what}: identical block at distance 0")
        srt = torch.sort(rows, dim=-1).values
        ks_s, _ = k3.dict_match_cuda(xs, srt, lo, hi, 0.3)
        check(torch.equal(ks_s, ks), f"{what}: order-free")
        check(torch.equal(ks_s, ref.ks_counts(xs, srt, float(
            np.float32(1.0 / n)))), f"{what}: sorted rows == K1's plain KS")
    # eq. 3 boundary: candidate extremes exactly on dmin/dmax -+ t pass,
    # beyond them fail (tests/test_kernels.py:86)
    n = 32
    xs = torch.linspace(0.0, 1.0, n, dtype=torch.float32, device=dev)
    base = xs.repeat(6, 1)
    r = 0.25
    t = (base[:, -1] - base[:, 0]) * torch.tensor(r, device=dev)
    shift = torch.tensor([0.0, 1.0, -1.0, 1.0001, 0.5, 2.0], device=dev)
    ds = base + (shift * t)[:, None]
    lo, hi = ds.amin(-1), ds.amax(-1)
    ks, mm = k3.dict_match_cuda(xs[None], ds[None], lo[None], hi[None], r)
    torch.cuda.synchronize()
    ks_p, mm_p = ref.dict_match_ref(xs[None], ds[None], lo[None], hi[None], r)
    check(torch.equal(ks, ks_p) and torch.equal(mm, mm_p),
          "K3 gate boundary: kernel == plain version")
    check(mm[0, :3].all() and not mm[0, 3] and not mm[0, 5],
          f"K3 gate boundary: on-edge pass, outside fail ({mm.tolist()})")
    for dt in (torch.float16, torch.bfloat16):
        x = torch.sort(torch.randn(64, 111, device=dev), -1).values.to(dt)
        rows = torch.randn(64, 255, 111, device=dev).to(dt)
        args = (x, rows, rows.amin(-1), rows.amax(-1), 0.5)
        got, want = ops.dict_match(*args), ops.dict_match_reference(*args)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"K3 {dt} operands == plain version")
    special = [(64, 255, 32), (64, 255, 111), (2, 40, 33), (1, 1, 1),
               (2, 9, 4096)]
    for C, D, n in special:
        for cand_sorted in (True, False):
            xs, rows, lo, hi = k3_special(C, D, n, C * D + n, cand_sorted)
            args = [torch.from_numpy(a).to(dev) for a in (xs, rows, lo, hi)]
            srt = torch.from_numpy(np.sort(rows, axis=-1)).to(dev)
            for order, r in (("stored", args[1]), ("sorted", srt)):
                ks, mm = k3.dict_match_cuda(args[0], r, *args[2:], 0.3)
                torch.cuda.synchronize()
                ks_p, mm_p = ref.dict_match_ref(args[0], r, *args[2:], 0.3)
                check(same_bits(torch, ks, ks_p) and torch.equal(mm, mm_p),
                      f"K3 C={C} D={D} n={n} NaN/inf/+-0/ties, {order} rows, "
                      f"{'sorted' if cand_sorted else 'unsorted'} candidate: "
                      "kernel == plain version")
    say(f"[K3] {len(cases)} shapes bitwise equal to the plain version on the "
        "card (stored order, distance-0 rows, sorted rows == K1's plain "
        "KS); gate boundary; f16/bf16 operands; rows with NaNs of both "
        "signs, +-inf, +-0 and ties, stored and sorted, sorted and unsorted "
        f"candidates at {special}")


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
    cases = 0
    # 33 x 30000: rows over 48 KB in every dtype go in column chunks, the
    # running sum carried from chunk to chunk
    shapes = [(R, P) for R in (1, 63, 65, 16383)
              for P in (1, 2, 111, 255, 1024)] + [(33, 30000)]
    for dt in (np.float64, np.float32, np.float16):
        for R, P in shapes:
            x = (rng.normal(0, 3, (R, P))
                 * 10.0 ** rng.integers(-3, 3, (R, 1))).astype(dt)
            x[:, 0] = -0.0
            want = np.cumsum(x, axis=1).tobytes()
            for off in (0, 3):  # 3 elements: not 16-byte aligned
                base = torch.from_numpy(np.concatenate(
                    [np.zeros(off, dt), x.reshape(-1)])).to(dev)
                view = base[off:].view(R, P)
                got = k2.seq_cumsum(view)
                torch.cuda.synchronize()
                plain = k2.seq_cumsum_torch(view)
                what = f"K2 {dt.__name__} {R}x{P} storage offset {off}"
                check(got.cpu().numpy().tobytes() == want,
                      f"{what}: == np.cumsum")
                check(got.cpu().numpy().tobytes() ==
                      plain.cpu().numpy().tobytes(),
                      f"{what}: == plain version")
                cases += 1
    say("[K2] bitwise equal to its plain version and to np.cumsum "
        "(f64/f32/f16, leading -0.0); R in (1, 63, 65, 16383) x P in (1, 2, "
        "111, 255, 1024) and 33 x 30000 (column chunks), x storage offset 0 "
        f"and 3 elements: {cases} cases")


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


def make_traffic(cfg_name, channels=range(CHANNELS), samples=SAMPLES):
    """The configuration's traffic for ``channels`` (rows in that order;
    channel c takes template c % 4 and seed c), ``samples`` a channel."""
    from repro_torch.data.synthetic import pmu_angle, pmu_magnitude
    x = np.empty((len(channels), samples), dtype=np.float64)
    rate = samples / REF_SAMPLES
    for i, c in enumerate(channels):
        if cfg_name == "MAG":
            level, noise, tap_step, shifts = MAG_TEMPLATES[c % 4]
            x[i] = pmu_magnitude(
                samples, level=level, noise=noise, tap_step=tap_step,
                n_shifts=round(shifts * rate), n_taps=round(MAG_TAPS * rate),
                seed=c)
        else:
            slope, noise = ANG_TEMPLATES[c % 4]
            x[i] = pmu_angle(samples, slope=slope, noise=noise, seed=c)
    return x


def turnover(C, nb, n, seed):
    rng = np.random.default_rng(seed)
    level = rng.integers(0, TURNOVER_LEVELS, (C, nb, 1)).astype(np.float64)
    return rng.normal(level, 1.0, (C, nb, n))


def device_profile(torch, fn, names=(), cpu=True):
    """Run ``fn`` under ``torch.profiler``: wall seconds (host clock, ending
    in a sync), the union of the card's activity intervals (kernels and
    copies), the summed device time of the busiest names and of the names
    that hold each of ``names``.  A trace that holds no device activity
    (seen now and then after many traces in one process) is taken again,
    up to 3 runs; ``runs`` says how many were made.  ``cpu=False`` traces
    the card alone (host operators untraced: a trace of ~25,000 kernels
    and their host operators took ~11 s to read back)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    for runs in range(1, 4):
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
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
        if spans:
            break
    busy_us, end = 0.0, -np.inf
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    out = {"wall_s": wall, "runs": runs, "device_events": len(spans),
           "device_busy_s": busy_us / 1e6,
           "busy_share": busy_us / 1e6 / wall if spans else None,
           "device_ms_by_name": {k[:80]: v for k, v in top}}
    if names:
        out["device_ms_of"] = {m: sum(v for k, v in by_name.items() if m in k)
                               for m in names}
    return out


def encode_session(torch, codec, x, chunks=CHUNKS):
    """The first ``chunks`` of CHUNKS feeds of ``x`` (C, SAMPLES) through
    one ``codec.session(channels=C)``; one stream per channel, ending in a
    device sync."""
    step = SAMPLES // CHUNKS
    sess = codec.session(channels=len(x))
    parts = [[] for _ in range(len(x))]
    for lo in range(0, chunks * step, step):
        for c, seg in enumerate(sess.feed(x[:, lo:lo + step])):
            parts[c].append(seg)
    for c, seg in enumerate(sess.finish()):
        parts[c].append(seg)
    torch.cuda.synchronize()
    return [b"".join(p) for p in parts]


def decode_all(torch, codec, blobs):
    ys = [codec.decode(b) for b in blobs]
    torch.cuda.synchronize()
    return ys


def phase_main(torch, dev, card):
    from repro_torch import IdealemCodec
    from repro_torch.core.encoder import init_state
    from repro_torch.core.npref import encode_decisions_np
    from repro_torch.core.stream import _parse_arrays, decode_stream
    from repro_torch.kernels import encode_step as k1
    from repro_torch.kernels import seq_cumsum as k2
    launches = {"encode_step": 0, "seq_cumsum": 0}
    first_chunks, streams = {}, {}
    step = SAMPLES // CHUNKS
    samples = MAIN_CHUNKS * step
    for cfg_name, cfg in CONFIGS.items():
        codec = IdealemCodec(device=dev, **cfg)  # backend/decode: cuda
        B = codec.block_size
        x = make_traffic(cfg_name)[:, :samples]

        def encode():
            return encode_session(torch, codec, x, chunks=MAIN_CHUNKS)

        def decode():
            return decode_all(torch, codec, blobs)

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
        nb = samples // B
        tail = samples - nb * B
        hits = 0
        for c, (blob, y) in enumerate(zip(blobs, ys)):
            check(y.shape == (samples,) and y.dtype == np.float64 and
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
        say(f"[main] {cfg_name} {CHANNELS} ch x {samples} f64 "
            f"({bytes_in / 2**20:.0f} MiB): {json.dumps(res)} [{card}]")
        say(f"[main] {cfg_name}: checks passed (f64-payload numpy backend "
            f"differs on {f64_diff} of the first {ORACLE_BLOCKS} hits)")
        # the same encode and decode again, under the profiler (the timed
        # run above is not profiled; launch counts were read before this)
        for what, fn in (("encode", encode), ("decode", decode)):
            say(f"[profile] {cfg_name} {what}: "
                f"{json.dumps(device_profile(torch, fn))} [{card}]")
        first_chunks[cfg_name] = first_chunk(codec, x)
        streams[cfg_name] = blobs
        del x, ys
    return launches, first_chunks, streams


def first_chunk(codec, x):
    """``(codec, payload (C, nb, n))`` of the first feed of traffic ``x``:
    what K1 is timed on."""
    B, step = codec.block_size, SAMPLES // CHUNKS
    p0 = codec._transform(x[:, :step - step % B].reshape(
        CHANNELS, -1, B).reshape(-1, B))[0]
    return codec, p0.reshape(CHANNELS, -1, p0.shape[-1])


def stream_hits(blobs):
    """Hit blocks over the streams (sections of any mode)."""
    from repro_torch.core.stream import _walk_all
    return sum(int(_walk_all(memoryview(b))[1].sum()) for b in blobs)


def unbounded(torch, dev, cfg_name):
    """``(traffic, streams)`` of one configuration at 2**20 samples a
    channel, encoded by the fused scan with no error bound."""
    from repro_torch import IdealemCodec
    x = make_traffic(cfg_name)
    codec = IdealemCodec(device=dev, **CONFIGS[cfg_name])
    return x, encode_session(torch, codec, x)


def phase_ops(torch, dev, card, x):
    """MAG with ``matcher="ops"`` on the first OPS_CHUNKS feeds of traffic
    ``x``: K3 once per block step, then the plain tensor step; the streams
    must equal the fused scan's on the same feeds.  Returns K3's launch
    count on this path."""
    from repro_torch import IdealemCodec
    from repro_torch.kernels import dict_match as k3
    from repro_torch.kernels import encode_step as k1
    fused = encode_session(torch, IdealemCodec(device=dev, **CONFIGS["MAG"]),
                           x, chunks=OPS_CHUNKS)
    codec = IdealemCodec(device=dev, matcher="ops", **CONFIGS["MAG"])
    samples = OPS_CHUNKS * (SAMPLES // CHUNKS)
    k1.launches = k3.launches = 0
    t0 = time.perf_counter()
    blobs = encode_session(torch, codec, x, chunks=OPS_CHUNKS)
    t_enc = time.perf_counter() - t0
    n3, n1 = k3.launches, k1.launches
    steps = samples // codec.block_size
    check(n3 == steps and n1 == 0,
          f"MAG ops: one K3 launch per block step ({n3} of {steps}), no K1 "
          f"launch ({n1})")
    check(blobs == fused,
          "MAG ops: streams == the fused (backend=cuda) streams, byte for "
          "byte")
    res = {"encode_MBps": 8 * CHANNELS * samples / t_enc / 1e6,
           "encode_s": t_enc,
           "launches": {"dict_match": n3, "encode_step": n1},
           "us_per_block_step": t_enc / steps * 1e6}
    say(f"[ops] MAG matcher=ops {CHANNELS} ch x {samples} f64: "
        f"{json.dumps(res)} [{card}]")
    say("[ops] MAG: streams equal the fused streams byte for byte")
    # a shorter window under the profiler: the first 256 block steps
    window = x[:, :256 * codec.block_size]
    say(f"[profile] MAG ops encode, first 256 block steps: "
        f"{json.dumps(device_profile(torch, lambda: encode_session(torch, codec, window, chunks=1)))}"
        f" [{card}]")
    return n3


def phase_bound(torch, dev, card, known):
    """The error-bounded mode end to end on ``backend="cuda"``, against the
    unbounded encodes (``known`` maps a configuration to its
    :func:`unbounded` result where one was made already).  Returns (K1,
    K2) launch counts on these paths."""
    from repro_torch import IdealemCodec
    from repro_torch.core.encoder import init_state
    from repro_torch.core.stream import _parse_arrays, decode_stream
    from repro_torch.kernels import encode_step as k1
    from repro_torch.kernels import seq_cumsum as k2
    launches = np.zeros(2, dtype=np.int64)
    for cfg_name, extra in BOUNDS.items():
        cfg = CONFIGS[cfg_name]
        codec = IdealemCodec(device=dev, **cfg, **extra)
        bound, vr, B = codec.error_bound, codec.value_range, codec.block_size
        x, fused = known.get(cfg_name) or unbounded(torch, dev, cfg_name)
        free = stream_hits(fused)
        k1.launches = k2.launches = 0
        t0 = time.perf_counter()
        blobs = encode_session(torch, codec, x)
        t_enc = time.perf_counter() - t0
        t0 = time.perf_counter()
        ys = decode_all(torch, codec, blobs)
        t_dec = time.perf_counter() - t0
        n1, n2 = k1.launches, k2.launches
        launches += [n1, n2]
        check(n1 == CHUNKS, f"{cfg_name} bound: K1 launched once per feed "
              f"({n1})")
        if cfg["mode"] == "delta":
            check(n2 > 0, f"{cfg_name} bound: K2 launched ({n2})")
        nb = SAMPLES // B
        worst, worst_excess = 0.0, -np.inf
        for c, (blob, y) in enumerate(zip(blobs, ys)):
            check(y.shape == (SAMPLES,) and bool(np.all(np.isfinite(y))),
                  f"{cfg_name} bound ch{c}: shape/finite")
            check(y.tobytes() == decode_stream(blob, backend="numpy")
                  .tobytes(), f"{cfg_name} bound ch{c}: cuda decode == "
                  "numpy decode")
            err = np.abs(y - x[c])
            if vr is not None:
                err = np.minimum(err, (vr[1] - vr[0]) - err)
            # the gate compares float32 casts of the f64 payloads: each cast
            # may move a sample by half a float32 spacing at its magnitude
            slop = EB_SLOP * max(bound, 1.0) + float(
                np.spacing(np.float32(np.abs(x[c]).max())))
            check(float(err.max()) <= bound + slop,
                  f"{cfg_name} bound ch{c}: max error {float(err.max())} "
                  f"within {bound} + {slop}")
            worst = max(worst, float(err.max()))
            worst_excess = max(worst_excess, float(err.max()) - bound)
        hits = stream_hits(blobs)
        demoted = 1.0 - hits / free
        check(0.05 <= demoted <= 0.95,
              f"{cfg_name} bound: demotes {demoted:.4f} of the unbounded "
              "hits (want 5-95 %)")
        # K1's decisions as written to the stream vs the plain scan
        pay = torch.as_tensor(np.stack([codec._transform(
            x[c, :nb * B].reshape(nb, B))[0] for c in PLAIN_CHANNELS]),
            dtype=torch.float32, device=dev)
        (h, s, o), _ = k1.encode_scan_torch(
            torch.sort(pay, dim=-1).values,
            torch.ones(pay.shape[:2], dtype=torch.bool, device=dev),
            init_state(codec.num_dict, pay.shape[-1], channels=len(pay),
                       device=dev, raw=True),
            d_crit=codec.d_crit, rel_tol=codec.rel_tol, raw=pay,
            error_bound=bound, error_cumulative=cfg["mode"] == "delta")
        for i, c in enumerate(PLAIN_CHANNELS):
            pr = _parse_arrays(blobs[c])[1]
            check(np.array_equal(h[i].cpu().numpy(), pr.is_hit) and
                  np.array_equal(s[i].cpu().numpy(), pr.slot) and
                  np.array_equal(o[i].cpu().numpy(), pr.overwrite),
                  f"{cfg_name} bound ch{c}: K1 decisions == plain scan")
        res = {"error_bound": bound, "max_abs_err": worst,
               "max_excess_over_bound": worst_excess,
               "ratio": x.nbytes / sum(len(b) for b in blobs),
               "hit_rate": hits / (nb * CHANNELS),
               "hit_rate_unbounded": free / (nb * CHANNELS),
               "demoted_share": demoted,
               "encode_MBps": x.nbytes / t_enc / 1e6,
               "decode_MBps": x.nbytes / t_dec / 1e6,
               "launches": {"encode_step": n1, "seq_cumsum": n2}}
        say(f"[bound] {cfg_name} {CHANNELS} ch x {SAMPLES} f64: "
            f"{json.dumps(res)} [{card}]")
        say(f"[bound] {cfg_name}: every channel within the bound; checks "
            "passed")
        say(f"[profile] {cfg_name} bounded encode: "
            f"{json.dumps(device_profile(torch, lambda: encode_session(torch, codec, x)))}"
            f" [{card}]")
        del x, fused, ys, blobs
    return launches


def store_requests(nb):
    """The analyst's range traffic over a container whose channels hold
    ``nb`` blocks each: STORE_REQUESTS ``(channel, start, stop)`` from
    seed 17, channel uniform, length log-uniform over 1..STORE_MAX_BLOCKS
    (clipped to the channel), start uniform."""
    rng = np.random.default_rng(17)
    ch = rng.integers(0, CHANNELS, STORE_REQUESTS)
    return [(int(c), a, b) for c, (a, b) in zip(
        ch, block_ranges(rng, nb, STORE_REQUESTS, STORE_MAX_BLOCKS))]


def block_ranges(rng, nb, count, max_blocks):
    """``count`` ``(start, stop)`` block ranges over ``nb`` blocks from
    ``rng``: length log-uniform over 1..``max_blocks`` (clipped to ``nb``),
    start uniform."""
    n = np.exp(rng.uniform(0.0, np.log(max_blocks), count))
    n = np.clip(np.rint(n).astype(np.int64), 1, nb)
    start = (rng.random(count) * (nb - n + 1)).astype(np.int64)
    return [(int(a), int(a + m)) for a, m in zip(start, n)]


@contextlib.contextmanager
def first_k2_operand(k2):
    """Holds a reference (no copy) to the operand of the first K2 launch
    made inside the block: the read path's padded batch."""
    seen, real = [], k2.seq_cumsum

    def spy(x):
        if not seen:
            seen.append(x)
        return real(x)

    k2.seq_cumsum = spy
    try:
        yield seen
    finally:
        k2.seq_cumsum = real


def phase_store(torch, dev, card):
    """The indexed store (10.): for each Table I configuration a
    ``container=True`` session of 64 channels x 2**20 samples, the
    container written to a file and opened through mmap, a full read and
    STORE_REQUESTS range reads on ``backend="cuda"`` against
    ``backend="numpy"``, and the port's telemetry.  Returns the (K1, K2)
    launches of its paths, the K2 operands of the ANG_delta reads and, by
    configuration, the container and its range answers (``cuda``, and
    ``numpy`` on the first calls) for the service phase."""
    import os
    import tempfile
    from repro_torch import IdealemCodec, obs
    from repro_torch.core.stream import _walk_all, decode_stream
    from repro_torch.kernels import encode_step as k1
    from repro_torch.kernels import seq_cumsum as k2
    from repro_torch.store import (Container, ContainerWriter,
                                   decode_channels, decode_ranges)
    reg = obs.registry()
    counted = {"requests": ("repro_store_range_requests_total", None),
               "blocks": ("repro_encode_blocks_total", None),
               "cuda_calls": ("repro_decode_backend_calls_total",
                              {"backend": "cuda"})}
    before = {k: reg.get_value(*v) for k, v in counted.items()}
    own = dict.fromkeys(counted, 0)
    k2_operands, archives = {}, {}
    step = SAMPLES // CHUNKS
    k1.launches = k2.launches = 0

    def read(store, requests, backend):
        own["requests"] += len(requests)
        own["cuda_calls"] += backend == "cuda"
        return decode_ranges(store, requests, backend=backend)

    with tempfile.TemporaryDirectory() as tmp:
        for cfg_name, cfg in CONFIGS.items():
            delta = cfg["mode"] == "delta"
            codec = IdealemCodec(device=dev, **cfg)
            B = codec.block_size
            nb = SAMPLES // B
            x = make_traffic(cfg_name)
            # 1. write: one container session, then the container copied
            # into a file through the writer and opened through mmap
            n1 = k1.launches
            sess = codec.session(channels=CHANNELS, container=True)
            t0 = time.perf_counter()
            for lo in range(0, SAMPLES, step):
                sess.feed(x[:, lo:lo + step])
            blob = sess.finish()
            torch.cuda.synchronize()
            t_enc = time.perf_counter() - t0
            check(k1.launches - n1 == CHUNKS,
                  f"store {cfg_name}: K1 once per feed "
                  f"({k1.launches - n1})")
            plain = encode_session(torch, codec, x[list(PLAIN_CHANNELS)])
            own["blocks"] += (CHANNELS + len(PLAIN_CHANNELS)) * nb
            mem = Container(blob)
            for i, c in enumerate(PLAIN_CHANNELS):
                check(mem.stream_bytes(c) == plain[i],
                      f"store {cfg_name} ch{c}: container stream == plain "
                      "session bytes")
            path = os.path.join(tmp, f"{cfg_name}.idlmc")
            w = ContainerWriter(path)
            for c in mem.channels:
                w.append(mem.stream_bytes(c), channel=c)
            w.finalize()
            store = Container.open(path, mmap=True)
            check(store.describe() == mem.describe() and all(
                store.stream_bytes(c) == mem.stream_bytes(c)
                for c in mem.channels),
                f"store {cfg_name}: mmap container == in-memory container")
            info = mem.describe()
            written = {"container_bytes": len(blob),
                       "index_bytes": info["index_bytes"],
                       "index_share_of_stream_bytes":
                           info["index_bytes"] / info["data_bytes"],
                       "chunks": info["chunks"], "ratio": x.nbytes / len(blob),
                       "encode_MBps": x.nbytes / t_enc / 1e6}

            # 2. full read of every channel
            n1, n2 = k1.launches, k2.launches
            with first_k2_operand(k2) as op:
                own["requests"] += CHANNELS
                own["cuda_calls"] += 1
                t0 = time.perf_counter()
                full = decode_channels(store, backend="cuda")
                t_full = time.perf_counter() - t0
            check(k2.launches - n2 == int(delta),
                  f"store {cfg_name}: full read, K2 launches "
                  f"{k2.launches - n2}")
            if delta:
                k2_operands["decode_channels"] = op[0]
            own["requests"] += CHANNELS
            t0 = time.perf_counter()
            ref = decode_channels(store, backend="numpy")
            t_full_np = time.perf_counter() - t0
            tail = SAMPLES - nb * B
            for c in range(CHANNELS):
                y = full[c]
                check(y.shape == (SAMPLES,)
                      and y.tobytes() == ref[c].tobytes(),
                      f"store {cfg_name} ch{c}: cuda read == numpy read")
                yb = y[:nb * B].reshape(nb, B)
                xb = x[c, :nb * B].reshape(nb, B)
                if cfg["mode"] == "std":
                    hit = _walk_all(memoryview(store.stream_bytes(c)))[1]
                    check(np.array_equal(yb[~hit], xb[~hit]),
                          f"store {cfg_name} ch{c}: miss blocks exact")
                else:
                    check(np.array_equal(yb[:, 0], xb[:, 0]),
                          f"store {cfg_name} ch{c}: block bases exact")
                check(np.array_equal(y[nb * B:], x[c, nb * B:]),
                      f"store {cfg_name} ch{c}: tail exact ({tail})")
            for c in PLAIN_CHANNELS:
                check(ref[c].tobytes() == decode_stream(
                    mem.stream_bytes(c), backend="numpy").tobytes(),
                    f"store {cfg_name} ch{c}: read == decode_stream")

            # 3. range traffic, STORE_BATCH requests a call
            reqs = store_requests(nb)
            batches = [reqs[i:i + STORE_BATCH]
                       for i in range(0, len(reqs), STORE_BATCH)]
            n1, n2 = k1.launches, k2.launches
            with first_k2_operand(k2) as op:
                t0 = time.perf_counter()
                got = [y for b in batches for y in read(store, b, "cuda")]
                t_cuda = time.perf_counter() - t0
            check(k2.launches - n2 == len(batches) * int(delta),
                  f"store {cfg_name}: K2 launches on reads "
                  f"{k2.launches - n2} for {len(batches)} calls")
            check(k1.launches == n1, f"store {cfg_name}: no K1 on reads")
            if delta:
                k2_operands["decode_ranges"] = op[0]
            t0 = time.perf_counter()
            got_np = [y for b in batches[:STORE_NUMPY_CALLS]
                      for y in read(store, b, "numpy")]
            t_np = time.perf_counter() - t0
            for k, ((c, i, j), y) in enumerate(zip(reqs, got)):
                want = ref[c][i * B:j * B].tobytes()
                check(y.tobytes() == want and (k >= len(got_np) or
                                               got_np[k].tobytes() == want),
                      f"store {cfg_name}: range ({c}, {i}, {j}) == the "
                      "slice of the full read")
            # a one-block range deep in a channel walks its one chunk; a
            # two-block range across a segment boundary walks two
            ks = store.chunks_of(CHANNELS - 1)
            edge = int(store._cols["blocks_before"][ks[CHUNKS // 2]])
            for lo, hi, walks in ((edge + 5, edge + 6, 1),
                                  (edge - 1, edge + 1, 2)):
                w0 = reg.get_value("repro_store_chunk_walks_total")
                (y,) = read(store, [(CHANNELS - 1, lo, hi)], "cuda")
                grew = reg.get_value("repro_store_chunk_walks_total") - w0
                check(grew == walks and y.tobytes() ==
                      ref[CHANNELS - 1][lo * B:hi * B].tobytes(),
                      f"store {cfg_name}: [{lo}, {hi}) walked {grew} chunks "
                      f"(want {walks})")
            blocks = sum(j - i for _, i, j in reqs)
            blocks_np = sum(j - i for _, i, j in reqs[:len(got_np)])
            res = {**written,
                   "full_read_MBps": x.nbytes / t_full / 1e6,
                   "full_read_numpy_MBps": x.nbytes / t_full_np / 1e6,
                   "requests": len(reqs), "calls": len(batches),
                   "blocks_requested": blocks,
                   "requests_per_s": len(reqs) / t_cuda,
                   "range_MBps": blocks * B * 8 / t_cuda / 1e6,
                   "requests_numpy": len(got_np),
                   "requests_per_s_numpy": len(got_np) / t_np,
                   "range_MBps_numpy": blocks_np * B * 8 / t_np / 1e6}
            say(f"[store] {cfg_name} {CHANNELS} ch x {SAMPLES} f64: "
                f"{json.dumps(res)} [{card}]")
            say(f"[profile] {cfg_name} range read, {STORE_BATCH} requests: "
                f"""{json.dumps(device_profile(
                    torch, lambda: read(store, batches[0], 'cuda'),
                    names=('seq_cumsum', 'HtoD', 'DtoH', 'indexSelect',
                           'gather')))} [{card}]""")
            store.close()
            archives[cfg_name] = (blob, got, got_np)
            del x, full, ref, got, got_np, mem, blob

    # 4. the port's telemetry over the phase
    check(obs.selfcheck(reg) == [], "obs.selfcheck(registry()) == []")
    grew = {k: reg.get_value(*v) - before[k] for k, v in counted.items()}
    check(grew == own, f"store telemetry {grew} == the phase's own counts "
          f"{own}")
    misses = {r: reg.get_value("repro_encode_miss_total", {"reason": r})
              for r in ("cold", "minmax", "ks", "error_bound")}
    say(f"[store] telemetry: {len(obs.to_prometheus().splitlines())} "
        f"exposition lines; counters == the phase's counts {json.dumps(own)}"
        f"; repro_encode_miss_total by reason (numpy oracle runs) "
        f"{json.dumps(misses)}")
    return (k1.launches, k2.launches), k2_operands, archives


def phase_auto(torch, dev, card, first_chunks):
    """``matcher="auto"`` on the card: the probe's times and choice at the
    MAG and ANG shapes; the choice decides the first feed as K1 does."""
    from repro_torch.core import encoder as enc
    enc.reset_encode_autotune()
    for cfg_name in ("MAG", "ANG_delta"):
        codec, pay = first_chunks[cfg_name]
        pt = torch.as_tensor(pay, dtype=torch.float32, device=dev)
        kw = dict(num_dict=codec.num_dict, d_crit=codec.d_crit,
                  rel_tol=codec.rel_tol)
        got = enc.encode_decisions_batched(pt, matcher="auto", **kw)
        want = enc.encode_decisions_batched(pt, matcher="fused", **kw)
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"auto {cfg_name}: decisions == fused")
        key = enc._matcher_key(codec.num_dict, pt.shape[-1], pt.dtype, dev)
        ent = {"matcher": enc.encode_autotune_choices()[key],
               "times_us": enc._TUNER.choices("times_us")[key]}
        say(f"[auto] {cfg_name} {key}: {json.dumps(ent)} [{card}]")
    say(f"[auto] choices {json.dumps(enc.encode_autotune_choices())}; the "
        "chosen matcher decides the first feed as the fused scan does")


def adaptive_traffic():
    """The adaptive phase's 64 channels: MAG traffic on the even channels,
    ANG traffic on the odd ones (each channel's own template and seed)."""
    x = np.empty((CHANNELS, SAMPLES), dtype=np.float64)
    x[0::2] = make_traffic("MAG", range(0, CHANNELS, 2))
    x[1::2] = make_traffic("ANG", range(1, CHANNELS, 2))
    return x


def adaptive_encode(torch, codec, x, chunks=None, capture=None, plan=None):
    """``(per-feed segments [channel][feed], the session, the lane widths
    of each feed's dispatch, host seconds in the selectors)`` of the first
    ``chunks`` feeds of ``x`` through ``codec.session(channels=C,
    plan=plan)``, ending in a device sync.  ``capture`` (a dict) records
    the first dispatch whose lanes differ in width: its cohort carry before
    the scan, its entries and its decisions, for lanes
    ``capture["lanes"](session)``."""
    step, chunks = SAMPLES // CHUNKS, chunks or CHUNKS
    sess = codec.session(channels=len(x), plan=plan)
    sel_s = [0.0]

    def timed(fn):
        def run(*a):
            t0 = time.perf_counter()
            out = fn(*a)
            sel_s[0] += time.perf_counter() - t0
            return out
        return run

    for sel in sess._selectors:
        sel.decide, sel.observe = timed(sel.decide), timed(sel.observe)
    parts = [[] for _ in range(len(x))]
    widths = []
    for lo in range(0, chunks * step, step):
        if capture is not None and sess._mixed is not None and \
                "dec" not in capture:
            watch(sess, capture)
        for c, seg in enumerate(sess.feed(x[:, lo:lo + step])):
            parts[c].append(seg)
        if sess._mixed is not None:
            widths.append(sorted(set(sess._mixed.lane_n.tolist())))
    for c, seg in enumerate(sess.finish()):
        parts[c].append(seg)
    torch.cuda.synchronize()
    return parts, sess, widths, sel_s[0]


def watch(sess, capture):
    """Wrap the session's cohort dispatch once (see adaptive_encode)."""
    cohort = sess._mixed
    if getattr(cohort, "_watched", False):
        return
    orig = cohort.decide

    def decide(entries, **kw):
        if "dec" in capture or len({p.shape[-1] for _, p, *_ in entries}) < 2:
            return orig(entries, **kw)
        lanes = capture["lanes"](sess)
        capture["state"] = {f: v[lanes].cpu().numpy()
                            for f, v in cohort.state._asdict().items()}
        capture["entries"] = [entries[c] for c in lanes]
        out = orig(entries, **kw)
        capture["dec"] = [out[c] for c in lanes]
        return out

    cohort.decide, cohort._watched = decide, True


def oracle_check(capture, codec):
    """The captured dispatch's decisions for its lanes against the numpy
    oracle (``encode_decisions_mixed_np``) on the same padded float32
    cohort, each lane starting from its carry before the scan."""
    from repro_torch.core.npref import NpDictState, encode_decisions_mixed_np
    ents, st = capture["entries"], capture["state"]
    nb = max(p.shape[0] for _, p, *_ in ents)
    n_max = max(p.shape[1] for _, p, *_ in ents)
    cohort = np.full((len(ents), nb, n_max), np.inf, dtype=np.float32)
    states = []
    for i, (_, p, *_) in enumerate(ents):
        cohort[i, :p.shape[0], :p.shape[1]] = p
        nf = p.shape[1]
        states.append(NpDictState(
            blocks=[row[:nf].copy() if ok else None for row, ok in
                    zip(st["sorted_blocks"][i], st["valid"][i])],
            dmin=st["dmin"][i].astype(np.float64),
            dmax=st["dmax"][i].astype(np.float64),
            count=int(st["count"][i])))
    want, _ = encode_decisions_mixed_np(
        cohort, num_dict=codec.num_dict,
        n_valid=[p.shape[1] for _, p, *_ in ents],
        d_crit=[dc for _, _, dc, *_ in ents], rel_tol=codec.rel_tol,
        states=states)
    for i, dec in enumerate(capture["dec"]):
        for w, g, name in zip(want, dec, ("is_hit", "slot", "overwrite")):
            check(np.array_equal(w[i], g),
                  f"adaptive lane {ents[i][0]}: {name} == numpy oracle")
    return [int(e[0]) for e in ents], [int(p.shape[1]) for _, p, *_ in ents]


def phase_adaptive(torch, dev, card):
    """Adaptive mode selection on ``backend="cuda"`` (IdealemCodec(adaptive=
    True) with the default SelectorConfig, the paper's MAG configuration)
    on 64 channels of MAG (even) and ANG (odd) traffic, 16 feeds of 65,536
    samples: one K1 launch with its chan operand a feed.  Returns the K1
    launches of its paths and the first feed's mixed cohort for timing."""
    import os
    from repro_torch import IdealemCodec
    from repro_torch.core.session import _ADAPTIVE_LOOP_ENV
    from repro_torch.core.stream import decode_stream
    from repro_torch.kernels import dict_match as k3
    from repro_torch.kernels import encode_step as k1
    x = adaptive_traffic()
    codec = IdealemCodec(device=dev, adaptive=True, **CONFIGS["MAG"])

    def lanes(sess):  # two lanes that switched and two that did not
        sw = [c for c in range(CHANNELS) if sess._stats[c].mode_switches]
        still = [c for c in range(0, CHANNELS, 2)
                 if not sess._stats[c].mode_switches]
        return sw[:2] + still[:2]

    capture = {"lanes": lanes}
    k1.launches = k3.launches = 0
    t0 = time.perf_counter()
    parts, sess, widths, sel_s = adaptive_encode(torch, codec, x,
                                                 capture=capture)
    t_enc = time.perf_counter() - t0
    n1, n3 = k1.launches, k3.launches
    blobs = [b"".join(p) for p in parts]
    check(n1 == CHUNKS and sess._mixed.dispatches == CHUNKS and n3 == 0,
          f"adaptive: one K1 launch per feed ({n1}, {sess._mixed.dispatches} "
          f"dispatches, {CHUNKS} feeds), no K3 launch ({n3})")
    switches = {kind: [st.mode_switches for st in sess.stats[first::2]]
                for kind, first in (("MAG", 0), ("ANG", 1))}
    modes = {kind: sorted({sess._codecs[c].mode
                           for c in range(first, CHANNELS, 2)})
             for kind, first in (("MAG", 0), ("ANG", 1))}
    mixed_feeds = sum(1 for w in widths if len(w) > 1)
    check(sum(switches["ANG"]) > 0 and mixed_feeds > 0,
          f"adaptive: mode switches happened ({switches}) and a dispatch "
          f"held lanes of both widths ({widths})")
    check("dec" in capture and len(capture["entries"]) == 4,
          "adaptive: a heterogeneous dispatch was captured for 4 lanes")
    oracle_lanes, oracle_widths = oracle_check(capture, codec)
    # the per-channel loop (one static K1 launch per channel a feed)
    os.environ[_ADAPTIVE_LOOP_ENV] = "1"
    try:
        k1.launches = 0
        t0 = time.perf_counter()
        loop_parts, loop_sess, _, _ = adaptive_encode(torch, codec, x)
        t_loop = time.perf_counter() - t0
    finally:
        del os.environ[_ADAPTIVE_LOOP_ENV]
    check(loop_sess._mixed is None and k1.launches == CHANNELS * CHUNKS,
          f"adaptive loop arm: {k1.launches} K1 launches "
          f"({CHANNELS * CHUNKS} expected)")
    check(loop_parts == parts, "adaptive: streams == the loop arm's streams")
    # the plain mixed scan (backend="torch") on 4 channels, 4 feeds
    few = list(range(4))
    t_codec = IdealemCodec(device=dev, adaptive=True, backend="torch",
                           **CONFIGS["MAG"])
    t_parts = adaptive_encode(torch, t_codec, x[few], chunks=4)[0]
    check(all(t_parts[i][:4] == parts[c][:4] for i, c in enumerate(few)),
          "adaptive: the first 4 feeds of 4 channels == backend=torch")
    t0 = time.perf_counter()
    ys = decode_all(torch, codec, blobs)
    t_dec = time.perf_counter() - t0
    for c, (blob, y) in enumerate(zip(blobs, ys)):
        check(y.shape == (SAMPLES,) and bool(np.all(np.isfinite(y))),
              f"adaptive ch{c}: shape/finite")
        check(y.tobytes() == decode_stream(blob, backend="numpy").tobytes(),
              f"adaptive ch{c}: cuda decode == numpy decode")
    hits = stream_hits(blobs)
    nb = SAMPLES // codec.block_size
    res = {"ratio": x.nbytes / sum(len(b) for b in blobs),
           "hit_rate": hits / (nb * CHANNELS),
           "encode_MBps": x.nbytes / t_enc / 1e6,
           "decode_MBps": x.nbytes / t_dec / 1e6, "encode_s": t_enc,
           "loop_arm_encode_s": t_loop,
           "selector_s": sel_s, "staging_s": sess._mixed.stage_s,
           "switches_per_channel": {k: sum(v) / len(v)
                                    for k, v in switches.items()},
           "modes_at_end": modes,
           "feeds_with_both_widths": mixed_feeds,
           "launches": {"encode_step": n1, "dict_match": n3,
                        "encode_step_loop_arm": CHANNELS * CHUNKS}}
    say(f"[adaptive] MAG+ANG {CHANNELS} ch x {SAMPLES} f64: "
        f"{json.dumps(res)} [{card}]")
    say(f"[adaptive] checks passed: streams == loop arm; lanes "
        f"{oracle_lanes} (widths {oracle_widths}) of the first mixed "
        f"dispatch == numpy oracle; 4 ch x 4 feeds == backend=torch; cuda "
        f"decode == numpy decode on every channel")
    prof = {}

    def profiled():
        _, ps, _, prof["selector_s"] = adaptive_encode(torch, codec, x)
        prof["staging_s"] = ps._mixed.stage_s

    out = device_profile(torch, profiled)
    out.update(host_selector_s=prof["selector_s"],
               host_staging_s=prof["staging_s"])
    say(f"[profile] adaptive encode: {json.dumps(out)} [{card}]")
    # the error-bounded run: MAG's bound on every lane, the delta lanes
    # with the cumulative gate
    b_codec = IdealemCodec(device=dev, adaptive=True, error_bound=3.0,
                           **CONFIGS["MAG"])
    k1.launches = 0
    b_parts, b_sess, _, _ = adaptive_encode(torch, b_codec, x)
    n1_b = k1.launches
    check(n1_b == CHUNKS, f"adaptive bound: one K1 launch per feed ({n1_b})")
    delta = [c for c in range(CHANNELS) if b_sess._codecs[c].mode == "delta"]
    check(len(delta) > 0, "adaptive bound: delta lanes (cumulative gate)")
    b_blobs = [b"".join(p) for p in b_parts]
    worst = 0.0
    for c, blob in enumerate(b_blobs):
        y = b_codec.decode(blob)
        err = float(np.abs(y - x[c]).max())
        slop = EB_SLOP * 3.0 + float(np.spacing(np.float32(
            np.abs(x[c]).max())))
        check(err <= 3.0 + slop, f"adaptive bound ch{c}: max error {err} "
              f"within 3.0 + {slop}")
        worst = max(worst, err)
    b_hits = stream_hits(b_blobs)
    say(f"[adaptive] error_bound=3.0: every channel within the bound (max "
        f"error {worst}); {len(delta)} delta lanes; K1 launches {n1_b}; hit "
        f"rate {b_hits / (nb * CHANNELS)} (unbounded {hits / (nb * CHANNELS)})"
        f" [{card}]")
    return n1 + n1_b, mixed_first_feed(codec, x), blobs


def mixed_first_feed(codec, x):
    """The first feed of ``x`` as a mixed cohort with the even lanes in std
    (width B) and the odd lanes in delta (width B - 1, +inf padded):
    ``(payload (C, nb, B) float32, widths (C,), d_crit (C,))``, the shape
    the adaptive phase dispatches once its ANG lanes have switched."""
    import dataclasses
    B, step = codec.block_size, SAMPLES // CHUNKS
    delta = dataclasses.replace(codec, mode="delta")
    blocks = x[:, :step - step % B].reshape(CHANNELS, -1, B)
    pay = np.full(blocks.shape, np.inf, dtype=np.float32)
    nf = np.empty(CHANNELS, dtype=np.int64)
    d_crit = np.empty(CHANNELS, dtype=np.float32)
    for c in range(CHANNELS):
        cdc = codec if c % 2 == 0 else delta
        p = cdc._transform(blocks[c])[0]
        pay[c, :, :p.shape[1]] = p
        nf[c], d_crit[c] = p.shape[1], cdc.d_crit
    return pay, nf, d_crit, codec


@contextlib.contextmanager
def k1_calls(k1):
    """Records ``(xs shape, chan given)`` of every call of K1's wrapper
    made inside the block."""
    seen, real = [], k1.encode_scan

    def spy(xs, valid, state, **kw):
        seen.append((tuple(xs.shape), kw.get("chan") is not None))
        return real(xs, valid, state, **kw)

    k1.encode_scan = spy
    try:
        yield seen
    finally:
        k1.encode_scan = real


@contextlib.contextmanager
def host_seconds(**targets):
    """Host seconds spent inside each ``name=(class, method)`` while the
    block runs."""
    acc = dict.fromkeys(targets, 0.0)
    real = {k: getattr(cls, m) for k, (cls, m) in targets.items()}
    # the attributes as the classes hold them (a classmethod stays one)
    held = {k: vars(cls)[m] for k, (cls, m) in targets.items()}

    def timed(key):
        fn = real[key]

        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                acc[key] += time.perf_counter() - t0
        return run

    for k, (cls, m) in targets.items():
        setattr(cls, m, timed(k))
    try:
        yield acc
    finally:
        for k, (cls, m) in targets.items():
            setattr(cls, m, held[k])


def histogram_sum(name, labels=None):
    from repro_torch import obs
    for v in obs.registry().snapshot().get(name, {"values": []})["values"]:
        if v["labels"] == (labels or {}):
            return v["sum"]
    return 0.0


def coalesce_traffic(co, x, streams, spare=(), rounds=None, seed=18):
    """Drive ``co`` the way a fleet of PMU streams does: the streams (rows
    of ``x``, ids ``s<row>``) join ``co.capacity`` at a time, one wave a
    round (each ramp round ends in an explicit flush, as a deadline tick
    would, so the slot table grows under a live carry); each live stream
    submits its next chunk in turn, its length drawn from ``seed`` in
    COALESCE_CHUNK.  At the first flush after the streams are halfway
    through, the first len(``spare``) of them close and the ``spare`` rows
    open under new ids (recycled slots) and feed the samples that remain.
    Stops after ``rounds`` rounds or when every stream is fed; then flushes
    and closes every open stream.  Returns ``(segments, feeds, fed)`` by
    id: ``feeds`` are the sample runs the flushes took from each stream
    (what a per-stream session must be fed to emit the same segments),
    ``fed`` its samples."""
    rng = np.random.default_rng(seed)
    limit = {f"s{r}": x.shape[1] for r in streams}
    segs = {sid: [] for sid in limit}
    feeds = {sid: [] for sid in limit}
    staged = {sid: [] for sid in limit}
    fed = dict.fromkeys(limit, 0)
    waiting, live, wave = list(limit), [], co.capacity

    def cut(res):
        for sid, runs in staged.items():
            if runs:
                feeds[sid].append(np.concatenate(runs))
                staged[sid] = []
        for sid, seg in res.items():
            segs[sid].append(seg)

    spare = [f"s{r}" for r in spare]
    r = 0
    while (rounds is None or r < rounds) and (waiting or any(
            fed[sid] < limit[sid] for sid in live)):
        ramp = bool(waiting)
        for sid in waiting[:wave]:
            co.open_stream(sid)
            live.append(sid)
        waiting = waiting[wave:]
        for sid in live:
            n = min(int(rng.integers(*COALESCE_CHUNK, endpoint=True)),
                    limit[sid] - fed[sid])
            if n <= 0:
                continue
            row = int(sid[1:])
            chunk = x[row, fed[sid]:fed[sid] + n]
            fed[sid] += n
            staged[sid].append(chunk)
            res = co.submit(sid, chunk)
            if res is None:
                continue
            cut(res)
            if spare and fed[live[0]] >= x.shape[1] // 2:
                # nothing is staged right after a flush: the closes below
                # emit their tails and launch nothing
                for old, new in zip(live[:len(spare)], spare):
                    segs[old].append(co.close_stream(old))
                    co.open_stream(new)
                    limit[new] = x.shape[1] - fed[old]
                    segs[new], feeds[new], staged[new] = [], [], []
                    fed[new] = 0
                live = live[len(spare):] + spare
                spare = []
                break
        if ramp:
            cut(co.flush())
        r += 1
    cut(co.flush())
    for sid in live:
        segs[sid].append(co.close_stream(sid))
    return ({sid: b"".join(v) for sid, v in segs.items()}, feeds, fed)


def profile_coalesce(torch, make, x, streams):
    """``device_profile`` of the first COALESCE_PROFILE_ROUNDS rounds of
    ``coalesce_traffic`` on a fresh coalescer from ``make()``, with the
    host seconds of the sessions' ``prepare`` and ``commit`` and the rest
    of the flushes (the decide: batch staging, copies, K1, the sync)."""
    from repro_torch.core.session import IdealemSession
    made = []

    def drive():
        made.append(make())
        coalesce_traffic(made[-1], x, streams,
                         rounds=COALESCE_PROFILE_ROUNDS)

    with host_seconds(prepare=(IdealemSession, "prepare"),
                      commit=(IdealemSession, "commit")) as host:
        s0 = histogram_sum("repro_encode_flush_seconds")
        out = device_profile(torch, drive,
                             names=("encode_scan", "HtoD", "DtoH", "Sort"))
        flush_s = histogram_sum("repro_encode_flush_seconds") - s0
    runs = out["runs"]
    out.update(host_prepare_s=host["prepare"] / runs,
               host_commit_s=host["commit"] / runs,
               host_decide_s=(flush_s - host["prepare"] - host["commit"])
               / runs, rounds=COALESCE_PROFILE_ROUNDS)
    mixed = made[-1]._mixed
    if mixed is not None:
        out["cohort_staging_s"] = mixed.stage_s
    return out


def phase_coalesce(torch, dev, card):
    """[coalesce]: per Table I configuration, COALESCE_STREAMS live streams
    of COALESCE_SAMPLES through one ``StreamCoalescer`` on ``backend="cuda"``
    (capacity 64, grown twice), COALESCE_RECYCLED of them replaced midway.
    One K1 launch a flush that holds blocks.  Checks: K1 launches == such
    flushes; COALESCE_CHECKED seeded streams == a per-stream
    ``CompressionService(backend="cuda")`` fed the same runs, the first
    COALESCE_ORACLE == ``backend="numpy"``, and decode with exact miss
    blocks (std) or bases, and tails.  Returns the K1 launches."""
    from repro_torch import obs
    from repro_torch.core.session import IdealemSession
    from repro_torch.core.stream import _walk_all, decode_stream
    from repro_torch.kernels import encode_step as k1
    from repro_torch.serve import (CompressionService, FlushPolicy,
                                   StreamCoalescer)
    reg = obs.registry()
    total = 0
    n_rows = COALESCE_STREAMS + COALESCE_RECYCLED
    streams = range(COALESCE_STREAMS)
    spare = range(COALESCE_STREAMS, n_rows)
    policy = FlushPolicy(max_batch_streams=COALESCE_STREAMS,
                         max_batch_blocks=COALESCE_MAX_BLOCKS)
    for cfg_name, cfg in CONFIGS.items():
        x = make_traffic(cfg_name, range(n_rows), COALESCE_SAMPLES)
        B = cfg["block_size"]
        co = StreamCoalescer(policy=policy, capacity=COALESCE_CAPACITY,
                             block_bucket=COALESCE_BUCKET, device=dev, **cfg)
        f0 = reg.get_value("repro_encode_flushes_total")
        s0 = histogram_sum("repro_encode_flush_seconds")
        k1.launches = 0
        with k1_calls(k1) as calls, host_seconds(
                prepare=(IdealemSession, "prepare"),
                commit=(IdealemSession, "commit")) as host:
            t0 = time.perf_counter()
            segs, feeds, fed = coalesce_traffic(co, x, streams, spare)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = k1.launches
        flushes = reg.get_value("repro_encode_flushes_total") - f0
        flush_s = histogram_sum("repro_encode_flush_seconds") - s0
        total += launches
        check(launches == flushes == len(calls) and all(
            not chan for _, chan in calls),
            f"coalesce {cfg_name}: one static K1 launch a flush with blocks "
            f"({launches} launches, {flushes} flushes, {len(calls)} calls)")
        grown = sorted({sh[0] for sh, _ in calls})
        check(co.capacity == COALESCE_STREAMS and len(segs) == n_rows
              and grown[0] == COALESCE_CAPACITY and len(grown) >= 3,
              f"coalesce {cfg_name}: capacity {co.capacity} (flushed at "
              f"{grown}), {len(segs)} streams")
        # per-stream services fed the runs each stream's flushes cut
        pick = np.random.default_rng(19).choice(
            n_rows, COALESCE_CHECKED, replace=False)
        pick = sorted({*map(int, pick[:-2]), 0, n_rows - 1})  # recycled, new
        svc = CompressionService(device=dev, **cfg)
        host_svc = CompressionService(backend="numpy", device=dev, **cfg)
        for k, row in enumerate(pick):
            sid = f"s{row}"
            for one in ((svc, host_svc) if k < COALESCE_ORACLE else (svc,)):
                one.open_stream(sid)
                want = b"".join([one.feed(sid, f) for f in feeds[sid]]
                                + [one.close_stream(sid)])
                check(segs[sid] == want,
                      f"coalesce {cfg_name} {sid}: stream == per-stream "
                      f"service ({one._defaults.get('backend', 'cuda')})")
            y = decode_stream(segs[sid], backend="numpy")
            xs = x[row, :fed[sid]]
            nb = fed[sid] // B
            check(y.shape == xs.shape and np.array_equal(
                y[nb * B:], xs[nb * B:]),
                f"coalesce {cfg_name} {sid}: length and tail")
            yb, xb = y[:nb * B].reshape(nb, B), xs[:nb * B].reshape(nb, B)
            if cfg["mode"] == "std":
                hit = _walk_all(memoryview(segs[sid]))[1]
                check(np.array_equal(yb[~hit], xb[~hit]),
                      f"coalesce {cfg_name} {sid}: miss blocks exact")
            else:
                check(np.array_equal(yb[:, 0], xb[:, 0]),
                      f"coalesce {cfg_name} {sid}: block bases exact")
        nbytes = 8 * sum(fed.values())
        nb_pads = [shape[1] for shape, _ in calls]
        st = co.stats()
        res = {"streams": len(segs), "samples_fed": sum(fed.values()),
               "flushes": flushes, "k1_launches": launches,
               "capacity_per_flush": sorted({sh[0] for sh, _ in calls}),
               "blocks": st["blocks"], "blocks_per_flush":
                   st["blocks"] / max(flushes, 1),
               "nb_pad_per_flush": nb_pads,
               "encode_MBps": nbytes / wall / 1e6, "wall_s": wall,
               "ratio": nbytes / sum(len(b) for b in segs.values()),
               "hit_rate": st["hit_rate"], "flush_s": flush_s,
               "host_prepare_s": host["prepare"],
               "host_commit_s": host["commit"]}
        say(f"[coalesce] {cfg_name} {len(segs)} streams x "
            f"{COALESCE_SAMPLES} f64: {json.dumps(res)} [{card}]")
        say(f"[coalesce] {cfg_name} checks passed: K1 launches == flushes; "
            f"{len(pick)} streams {pick} == per-stream cuda service, the "
            f"first {COALESCE_ORACLE} == numpy service; tails, "
            f"{'miss blocks' if cfg['mode'] == 'std' else 'bases'} exact")
        # the first rounds again, on a fresh coalescer, under the profiler
        out = profile_coalesce(torch, lambda: StreamCoalescer(
            policy=policy, capacity=COALESCE_CAPACITY,
            block_bucket=COALESCE_BUCKET, device=dev, **cfg), x, streams)
        say(f"[profile] {cfg_name} coalesce, {COALESCE_PROFILE_ROUNDS} "
            f"rounds: {json.dumps(out)} [{card}]")
        del x, segs, feeds
    return total


def phase_coalesce_adaptive(torch, dev, card):
    """[coalesce-adaptive]: COALESCE_ADAPTIVE_STREAMS adaptive streams (the
    MAG configuration, MAG traffic on even rows, ANG on odd) of
    COALESCE_SAMPLES through one ``StreamCoalescer(adaptive=True)``,
    capacity 16 grown twice, a flush a round.  Checks: one K1 launch with
    its chan operand a flush with blocks; every stream == a per-stream
    adaptive session fed the same runs.  Returns the K1 launches."""
    from repro_torch import IdealemCodec, obs
    from repro_torch.core.select import ChannelSelector
    from repro_torch.core.session import IdealemSession
    from repro_torch.kernels import encode_step as k1
    from repro_torch.serve import FlushPolicy, StreamCoalescer
    reg = obs.registry()
    n = COALESCE_ADAPTIVE_STREAMS
    x = np.empty((n, COALESCE_SAMPLES), dtype=np.float64)
    x[0::2] = make_traffic("MAG", range(0, n, 2), COALESCE_SAMPLES)
    x[1::2] = make_traffic("ANG", range(1, n, 2), COALESCE_SAMPLES)
    cfg = dict(adaptive=True, **CONFIGS["MAG"])
    co = StreamCoalescer(
        policy=FlushPolicy(max_batch_streams=n,
                           max_batch_blocks=COALESCE_MAX_BLOCKS),
        capacity=n // 4, block_bucket=COALESCE_BUCKET, device=dev, **cfg)
    f0 = reg.get_value("repro_encode_flushes_total")
    s0 = histogram_sum("repro_encode_flush_seconds")
    k1.launches = 0
    with k1_calls(k1) as calls, host_seconds(
            prepare=(IdealemSession, "prepare"),
            commit=(IdealemSession, "commit"),
            select_decide=(ChannelSelector, "decide"),
            select_observe=(ChannelSelector, "observe")) as host:
        t0 = time.perf_counter()
        segs, feeds, fed = coalesce_traffic(co, x, range(n))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = k1.launches
    flushes = reg.get_value("repro_encode_flushes_total") - f0
    flush_s = histogram_sum("repro_encode_flush_seconds") - s0
    check(launches == flushes == co._mixed.dispatches == len(calls)
          and all(chan for _, chan in calls),
          f"coalesce-adaptive: one K1 chan launch a flush ({launches} "
          f"launches, {flushes} flushes, {co._mixed.dispatches} dispatches)")
    grown = sorted({sh[0] for sh, _ in calls})
    check(co.capacity == n and grown[0] == n // 4 and len(grown) >= 3,
          f"coalesce-adaptive: capacity {co.capacity} (flushed at {grown})")
    codec = IdealemCodec(device=dev, **cfg)
    for row in range(n):
        sid = f"s{row}"
        sess = codec.session()
        want = b"".join([sess.feed(f) for f in feeds[sid]] + [sess.finish()])
        check(segs[sid] == want, f"coalesce-adaptive {sid}: stream == "
              "per-stream adaptive session")
    st = [co.stats(f"s{r}") for r in range(n)]
    nbytes = 8 * sum(fed.values())
    res = {"streams": n, "flushes": flushes, "k1_chan_launches": launches,
           "capacity_per_flush": sorted({sh[0] for sh, _ in calls}),
           "padded_width_per_flush": sorted({sh[2] for sh, _ in calls}),
           "lane_widths_at_end": sorted(set(co._mixed.lane_n.tolist())),
           "nb_pad_per_flush": [sh[1] for sh, _ in calls],
           "blocks": sum(s["blocks"] for s in st),
           "encode_MBps": nbytes / wall / 1e6, "wall_s": wall,
           "ratio": nbytes / sum(len(b) for b in segs.values()),
           "switches": {k: sum(s["mode_switches"] for s in st[i::2])
                        for k, i in (("MAG", 0), ("ANG", 1))},
           "flush_s": flush_s, "host_prepare_s": host["prepare"],
           "host_commit_s": host["commit"],
           "host_selectors_s": host["select_decide"]
           + host["select_observe"],
           "cohort_staging_s": co._mixed.stage_s}
    say(f"[coalesce-adaptive] MAG+ANG {n} streams x {COALESCE_SAMPLES} f64:"
        f" {json.dumps(res)} [{card}]")
    say(f"[coalesce-adaptive] checks passed: one K1 chan launch a flush; "
        f"{n} streams == per-stream adaptive sessions")
    out = profile_coalesce(torch, lambda: StreamCoalescer(
        policy=FlushPolicy(max_batch_streams=n,
                           max_batch_blocks=COALESCE_MAX_BLOCKS),
        capacity=n // 4, block_bucket=COALESCE_BUCKET, device=dev, **cfg),
        x, range(n))
    say(f"[profile] coalesce-adaptive, {COALESCE_PROFILE_ROUNDS} rounds: "
        f"{json.dumps(out)} [{card}]")
    return launches


def session_streams(torch, codec, x, feeds, plan=None):
    """``(streams, session)``: ``x`` (C, m) fed in ``feeds`` equal chunks
    to ``codec.session(channels=C, plan=plan)``, ending in a device
    sync."""
    step = x.shape[1] // feeds
    sess = codec.session(channels=len(x), plan=plan)
    parts = [[] for _ in range(len(x))]
    for lo in range(0, feeds * step, step):
        for c, seg in enumerate(sess.feed(x[:, lo:lo + step])):
            parts[c].append(seg)
    for c, seg in enumerate(sess.finish()):
        parts[c].append(seg)
    torch.cuda.synchronize()
    return [b"".join(p) for p in parts], sess


def dshard_traffic(cfg_name, seed):
    """``(CHANNELS, SHARD_D_SAMPLES)`` samples whose payload blocks are
    :func:`turnover`'s (more levels than D, so the FIFO turns over): MAG's
    blocks as they are; for ANG_delta a running sum of the levels in
    SHARD_DEGREES_PER_LEVEL steps wrapped into [0, 360), so each block's
    deltas are one turnover block (its first value is the jump from the
    block before)."""
    B = CONFIGS[cfg_name]["block_size"]
    x = turnover(CHANNELS, -(-SHARD_D_SAMPLES // B), B, seed).reshape(
        CHANNELS, -1)[:, :SHARD_D_SAMPLES]
    if CONFIGS[cfg_name]["mode"] == "std":
        return x
    return np.mod(np.cumsum(x * SHARD_DEGREES_PER_LEVEL, axis=1), 360.0)


def hits_by_shard(blobs, rows, shards):
    """Hit blocks over the streams by the dictionary shard that holds the
    slot each hit names (``shards`` shards of ``rows`` rows)."""
    from repro_torch.core.stream import _walk_all
    by = np.zeros(shards, dtype=np.int64)
    for b in blobs:
        _, is_hit, slot, _ = _walk_all(memoryview(b))
        by += np.bincount(slot[is_hit] // rows, minlength=shards)
    return by


def shard_devices(torch):
    """SHARD_SHARDS devices: the visible cards round robin."""
    return [torch.device("cuda", i % torch.cuda.device_count())
            for i in range(SHARD_SHARDS)]


def k3_at_shard_shapes(torch, sess, xs, rel_tol):
    """K3 on a D-sharded session's final carry, shard by shard (the shapes
    the scan gave it), against its plain version: bitwise."""
    from repro_torch.kernels import dict_match as k3
    from repro_torch.kernels.ref import dict_match_ref
    shapes = []
    for row in sess._dev_state.grid:
        for st in row:
            x = xs[:st.count.shape[0]].to(st.dmin.device)
            got = k3.dict_match_cuda(x, st.sorted_blocks, st.dmin, st.dmax,
                                     rel_tol)
            want = dict_match_ref(x, st.sorted_blocks, st.dmin, st.dmax,
                                  rel_tol)
            torch.cuda.synchronize()
            check(same_bits(torch, got[0], want[0])
                  and torch.equal(got[1], want[1]),
                  f"K3 at the shard shape {tuple(st.sorted_blocks.shape)}: "
                  "kernel == plain version")
            shapes.append(tuple(st.sorted_blocks.shape))
    return shapes


def phase_shard(torch, dev, card, main_streams, adaptive_streams):
    """[shard]: the scale-out encode through ``IdealemCodec.session(plan=)``
    and ``StreamCoalescer(plan=)``, each plan's SHARD_SHARDS shards on the
    visible cards (``cuda:0`` SHARD_SHARDS times on one card).  Checks:
    channel-sharded Table I sessions == ``[main]``'s streams with K1 ==
    feeds x shards; dictionary-sharded MAG and ANG_delta sessions (and MAG
    with ``error_bound=3.0``) == the unplanned fused session on the same
    samples with K3 == block steps x shards and no K1, every channel's FIFO
    wrapped and hits on every dictionary shard, and K3 == its plain version
    at each shard's shape; the adaptive session of ``[adaptive]``
    through a plan == its streams with one K1 chan launch a shard a feed;
    a planned coalescer of SHARD_COALESCE_STREAMS slots == the unplanned
    one with K1 == flushes x shards.  Returns the path's launches by
    kernel."""
    from repro_torch import IdealemCodec, obs
    from repro_torch.kernels import dict_match as k3
    from repro_torch.kernels import encode_step as k1
    from repro_torch.launch.encode_plan import make_encode_plan
    from repro_torch.serve import FlushPolicy, StreamCoalescer
    devs = shard_devices(torch)
    S = SHARD_SHARDS
    launches = {"encode_step": 0, "dict_match": 0}
    step = SAMPLES // CHUNKS
    # channel-sharded: [main]'s sessions through a plan
    for cfg_name, cfg in CONFIGS.items():
        codec = IdealemCodec(device=dev, **cfg)
        x = make_traffic(cfg_name)[:, :MAIN_CHUNKS * step]
        plan = make_encode_plan(CHANNELS, block_size=codec.block_size,
                                devices=devs)
        check(plan.num_devices == S and plan.padded_channels == CHANNELS,
              f"shard {cfg_name}: plan {plan.summary()}")
        k1.launches = k3.launches = 0
        t0 = time.perf_counter()
        blobs, sess = session_streams(torch, codec, x, MAIN_CHUNKS, plan)
        wall = time.perf_counter() - t0
        n1, n3 = k1.launches, k3.launches
        launches["encode_step"] += n1
        check(n1 == MAIN_CHUNKS * S and n3 == 0,
              f"shard {cfg_name}: K1 launches {n1} == feeds x shards "
              f"({MAIN_CHUNKS} x {S}), no K3 ({n3})")
        check(blobs == main_streams[cfg_name],
              f"shard {cfg_name}: planned streams == [main]'s streams")
        res = {"shards": S, "devices": sorted({str(d) for d in devs}),
               "shard_channels": plan.shard_channels,
               "encode_MBps": x.nbytes / wall / 1e6, "encode_s": wall,
               "launches": {"encode_step": n1}}
        say(f"[shard] {cfg_name} channel-sharded {CHANNELS} ch x "
            f"{x.shape[1]} f64: {json.dumps(res)} [{card}]")
        del x
    say("[shard] channel-sharded: streams == [main]'s byte for byte (whose "
        "K1 decisions on channels 0, 21, 42, 63 -- one in each shard -- "
        "equal the plain scan)")
    # dictionary-sharded: K3 a shard a block step, on traffic that turns
    # the FIFO over so the cross-shard minimum and the owner's insert decide
    runs = [("MAG", {}, ds) for ds in SHARD_DICT_SHARDS]
    runs += [("ANG_delta", {}, ds) for ds in SHARD_DICT_SHARDS]
    runs += [("MAG", BOUNDS["MAG"], 2)]
    plain = {}
    traffic = {name: dshard_traffic(name, seed=20 + i)
               for i, name in enumerate(("MAG", "ANG_delta"))}
    for cfg_name, extra, ds in runs:
        codec = IdealemCodec(device=dev, **CONFIGS[cfg_name], **extra)
        key = (cfg_name, tuple(extra.items()))
        x = traffic[cfg_name]
        if key not in plain:
            plain[key] = session_streams(torch, codec, x, 1)[0]
        plan = make_encode_plan(CHANNELS, block_size=codec.block_size,
                                devices=devs[:ds], dict_shards=ds)
        check(plan.grid == (tuple(devs[:ds]),),
              f"shard {cfg_name}: one group of {ds} dictionary shards")
        k1.launches = k3.launches = 0
        t0 = time.perf_counter()
        blobs, sess = session_streams(torch, codec, x, 1, plan)
        wall = time.perf_counter() - t0
        n1, n3 = k1.launches, k3.launches
        launches["dict_match"] += n3
        steps = SHARD_D_SAMPLES // codec.block_size
        what = f"shard {cfg_name}{' bound' if extra else ''} D/{ds}"
        check(n3 == steps * ds and n1 == 0,
              f"{what}: K3 launches {n3} == block steps x shards "
              f"({steps} x {ds}), no K1 ({n1})")
        check(blobs == plain[key],
              f"{what}: streams == the unplanned fused session's")
        count = sess._dev_state.grid[0][0].count
        rows = sess._dev_state.partition.shard_rows
        hits = hits_by_shard(blobs, rows, ds)
        check(int(count.min()) > codec.num_dict and bool((hits > 0).all()),
              f"{what}: every channel's FIFO wrapped (inserts "
              f"{int(count.min())} > D={codec.num_dict}) and every "
              f"dictionary shard holds hits ({hits.tolist()})")
        xs = torch.sort(torch.as_tensor(
            codec._transform(x[:, :codec.block_size])[0], dtype=torch.float32,
            device=dev), dim=-1).values
        shapes = k3_at_shard_shapes(torch, sess, xs, codec.rel_tol)
        res = {"dict_shards": ds, "rows_per_shard": shapes[0][1],
               "pad_rows": ds * shapes[0][1] - codec.num_dict,
               "fifo_inserts": [int(count.min()), int(count.max())],
               "hits_by_shard": hits.tolist(),
               "encode_s": wall, "us_per_block_step": wall / steps * 1e6,
               "launches": {"dict_match": n3, "encode_step": n1}}
        say(f"[shard] {cfg_name}{' error_bound=3.0' if extra else ''} "
            f"dictionary-sharded {CHANNELS} ch x {SHARD_D_SAMPLES} f64 turnover: "
            f"{json.dumps(res)} [{card}]")
    say("[shard] dictionary-sharded: streams == the unplanned fused "
        "sessions' byte for byte; K3 == its plain version at every shard's "
        "shape")
    codec = IdealemCodec(device=dev, **CONFIGS["MAG"])
    plan = make_encode_plan(CHANNELS, block_size=codec.block_size,
                            devices=devs[:2], dict_shards=2)
    window = traffic["MAG"][:, :SHARD_PROFILE_STEPS * codec.block_size]
    out = device_profile(torch, lambda: session_streams(
        torch, codec, window, 1, plan), names=("dict_match", "minimum"))
    say(f"[profile] MAG dictionary-sharded D/2, first {SHARD_PROFILE_STEPS} "
        f"block steps: {json.dumps(out)} [{card}]")
    # an adaptive session through a channel plan
    x = adaptive_traffic()
    codec = IdealemCodec(device=dev, adaptive=True, **CONFIGS["MAG"])
    plan = make_encode_plan(CHANNELS, block_size=codec.block_size,
                            devices=devs).validate_adaptive()
    k1.launches = k3.launches = 0
    with k1_calls(k1) as calls:
        t0 = time.perf_counter()
        parts, sess, _, _ = adaptive_encode(torch, codec, x, plan=plan)
        wall = time.perf_counter() - t0
    n1 = k1.launches
    launches["encode_step"] += n1
    check(n1 == len(calls) == CHUNKS * S and k3.launches == 0
          and all(chan for _, chan in calls)
          and {sh[0] for sh, _ in calls} == {plan.shard_channels},
          f"shard adaptive: one K1 chan launch a shard a feed ({n1}, "
          f"{CHUNKS} x {S} expected)")
    check([b"".join(p) for p in parts] == adaptive_streams,
          "shard adaptive: planned streams == [adaptive]'s streams")
    say(f"[shard] adaptive MAG+ANG {CHANNELS} ch x {SAMPLES} f64, {S} "
        f"shards: {json.dumps({'encode_MBps': x.nbytes / wall / 1e6, 'encode_s': wall, 'switches': sum(st.mode_switches for st in sess.stats), 'launches': {'encode_step': n1}})}"
        f" [{card}]")
    del x
    # a planned coalescer against the unplanned one
    n = SHARD_COALESCE_STREAMS
    policy = FlushPolicy(max_batch_streams=n,
                         max_batch_blocks=COALESCE_MAX_BLOCKS)
    reg = obs.registry()
    for cfg_name, cfg in CONFIGS.items():
        x = make_traffic(cfg_name, range(n), COALESCE_SAMPLES)
        plan = make_encode_plan(n, block_size=cfg["block_size"],
                                devices=devs)
        got = {}
        for name, p in (("plain", None), ("planned", plan)):
            co = StreamCoalescer(policy=policy, capacity=n, plan=p,
                                 block_bucket=COALESCE_BUCKET, device=dev,
                                 **cfg)
            f0 = reg.get_value("repro_encode_flushes_total")
            k1.launches = 0
            t0 = time.perf_counter()
            segs = coalesce_traffic(co, x, range(n))[0]
            torch.cuda.synchronize()
            got[name] = (segs, k1.launches, time.perf_counter() - t0,
                         int(reg.get_value("repro_encode_flushes_total")
                             - f0))
        segs, n1, wall, flushes = got["planned"]
        launches["encode_step"] += n1
        check(co.capacity == n and n1 == flushes * S
              and got["plain"][1] == flushes,
              f"shard coalesce {cfg_name}: K1 launches {n1} == flushes x "
              f"shards ({flushes} x {S}); unplanned {got['plain'][1]}")
        check(segs == got["plain"][0],
              f"shard coalesce {cfg_name}: planned streams == unplanned")
        res = {"streams": n, "flushes": flushes, "k1_launches": n1,
               "encode_MBps": x.nbytes / wall / 1e6, "wall_s": wall,
               "unplanned_wall_s": got["plain"][2]}
        say(f"[shard] {cfg_name} coalesce, plan of {S} shards: "
            f"{json.dumps(res)} [{card}]")
        del x
    say("[shard] checks passed: planned sessions and coalescers == the "
        "unplanned ones byte for byte; K1 once a shard a feed or flush, K3 "
        "once a shard a block step")
    return launches


def serve_ranges(svc, reqs, store_of=lambda k: "s"):
    """Every ``(channel, start, stop)`` of ``reqs`` through ``svc.submit``
    (request id = index), then ``svc.close()``: ``(answers by index, wall
    seconds ending when the last answer is on the host)``."""
    out = {}
    t0 = time.perf_counter()
    for k, (c, i, j) in enumerate(reqs):
        out.update(svc.submit(str(k), store_of(k), i, j, channel=c) or {})
    out.update(svc.close())
    wall = time.perf_counter() - t0
    check(not svc.last_errors and len(out) == len(reqs),
          f"service: {len(out)} answers of {len(reqs)}, errors "
          f"{list(svc.last_errors)[:3]}")
    return {int(k): v for k, v in out.items()}, wall


@contextlib.contextmanager
def reconstruct_units():
    """Records ``(backend, plan blocks, plan mode)`` of every reconstruct
    dispatch made inside the block (from any thread)."""
    from repro_torch.core import decode as decode_mod
    seen, real = [], decode_mod.reconstruct

    def spy(plan, backend="cuda", device=None):
        seen.append((backend, plan.nb, plan.mode))
        return real(plan, backend=backend, device=device)

    decode_mod.reconstruct = spy
    try:
        yield seen
    finally:
        decode_mod.reconstruct = real


def phase_service(torch, dev, card, archives):
    """[service]: the three containers of [store] attached to a
    ``DecompressionService``, its STORE_REQUESTS range requests submitted
    one by one with ``FlushPolicy(max_batch_streams=SERVICE_STREAMS)`` at
    pipeline depth 1 and 2 on ``backend="cuda"``, once more on
    ``backend="auto"``, and on ANG_delta with the container attached
    under two ids (requests alternating).  Checks: every answer ==
    ``decode_ranges(backend="cuda")`` of [store] bitwise, and == numpy on
    its first calls; K2 launches == the ANG_delta cuda units; the merged
    run dispatches as the single-store run.  Returns the K2 launches."""
    from repro_torch import obs
    from repro_torch.core import decode as decode_mod
    from repro_torch.core.decode import _pow2
    from repro_torch.kernels import seq_cumsum as k2
    from repro_torch.serve import DecompressionService, FlushPolicy
    from repro_torch.store import Container
    reg = obs.registry()
    stages = ("plan", "gather", "reconstruct", "emit")
    total = 0

    def run(blob, got, got_np, label, stores=1, **kw):
        nonlocal total
        store = Container(blob)
        svc = DecompressionService(device=dev, **kw)
        for i in range(stores):
            svc.attach(f"s{i}", store)
        reqs = store_requests(store.total_blocks(0))
        s0 = {st: histogram_sum("repro_serve_stage_seconds",
                                {"stage": st}) for st in stages}
        k2.launches = 0
        with reconstruct_units() as units:
            out, wall = serve_ranges(svc, reqs,
                                     lambda k: f"s{k % stores}")
        launches = k2.launches
        delta = store.header_of(0).mode == 2
        cuda_units = sum(b == "cuda" for b, _, _ in units)
        explicit = kw.get("backend", "cuda") == "cuda"
        # "auto" launches K2 in its probes too: its count is not checked
        check(not explicit or launches == (cuda_units if delta else 0),
              f"service {label}: K2 launches {launches} == ANG_delta cuda "
              f"units ({cuda_units if delta else 0})")
        for k, y in out.items():
            check(y.tobytes() == got[k].tobytes() and (
                k >= len(got_np) or y.tobytes() == got_np[k].tobytes()),
                f"service {label}: request {k} == decode_ranges (cuda"
                f"{', numpy' if k < len(got_np) else ''})")
        blocks = sum(j - i for _, i, j in reqs)
        B = store.header_of(0).block_size
        res = {"requests": len(reqs), "requests_per_s": len(reqs) / wall,
               "MBps": blocks * B * 8 / wall / 1e6, "wall_s": wall,
               "flushes": svc.stats["flushes"],
               "dispatches": svc.stats["dispatches"],
               "units_by_backend": {b: sum(u[0] == b for u in units)
                                    for b in sorted({u[0] for u in units})},
               "k2_launches": launches,
               "plan_rows_per_requested":
                   sum(n for _, n, _ in units) / blocks,
               "padded_rows_per_requested":
                   sum(_pow2(n) for _, n, _ in units) / blocks,
               "cache_hits": svc.stats["cache_hits"],
               "cache_misses": svc.stats["cache_misses"],
               "inflight_peak": svc.stats["inflight_peak"],
               "stage_seconds": {st: histogram_sum(
                   "repro_serve_stage_seconds", {"stage": st}) - s0[st]
                   for st in stages}}
        total += launches if explicit else 0
        return res, reqs, store

    for cfg_name, (blob, got, got_np) in archives.items():
        policy = dict(max_batch_streams=SERVICE_STREAMS)
        for depth in (1, 2):
            res, reqs, store = run(
                blob, got, got_np, f"{cfg_name} depth {depth}",
                policy=FlushPolicy(pipeline_depth=depth, **policy))
            if depth == 1:
                single = res
            say(f"[service] {cfg_name} cuda depth {depth}: "
                f"{json.dumps(res)} [{card}]")
        decode_mod.reset_autotune()
        res, _, _ = run(blob, got, got_np, f"{cfg_name} auto",
                        policy=FlushPolicy(pipeline_depth=2, **policy),
                        backend="auto")
        say(f"[service] {cfg_name} auto depth 2: {json.dumps(res)} "
            f"autotune_choices {json.dumps(decode_mod.autotune_choices())} "
            f"times_us {json.dumps(decode_mod._TUNER.choices('times_us'))}"
            f" [{card}]")
        if cfg_name == "ANG_delta":
            res, _, _ = run(blob, got, got_np, f"{cfg_name} two stores",
                            stores=2, policy=FlushPolicy(**policy))
            check(res["dispatches"] == single["dispatches"]
                  and res["cache_misses"] <= single["cache_misses"],
                  f"service {cfg_name}: two attaches merge as one store "
                  f"({res['dispatches']} vs {single['dispatches']} "
                  f"dispatches) and share the chunk cache")
            say(f"[service] {cfg_name} cuda depth 1, two stores: "
                f"{json.dumps(res)} [{card}]")
        head = reqs[:SERVICE_PROFILED]

        def profiled():
            svc = DecompressionService(
                device=dev, policy=FlushPolicy(pipeline_depth=2, **policy))
            svc.attach("s", store)
            serve_ranges(svc, head)

        out = device_profile(torch, profiled,
                             names=("seq_cumsum", "HtoD", "DtoH",
                                    "indexSelect", "gather"))
        say(f"[profile] {cfg_name} service depth 2, {len(head)} requests: "
            f"{json.dumps(out)} [{card}]")
    say(f"[service] checks passed: every answer at depth 1, 2 and auto == "
        f"decode_ranges(cuda) bitwise (numpy on the first "
        f"{STORE_NUMPY_CALLS * STORE_BATCH}); K2 launches == ANG_delta cuda "
        f"units; telemetry {reg.get_value('repro_serve_requests_total')} "
        f"requests")
    return total


def frontend_fleet():
    """Every tenant's streams, ``{tenant: [(stream id, config name,
    CodecConfig, coalesce, trace row)]}``: per Table I configuration one
    direct stream (row ``t * per``) and FRONTEND_COALESCED coalesced ones
    (the rows after it).  Tenant 0's direct MAG stream opens with
    ``matcher="ops"``."""
    from repro_torch import api
    per = 1 + FRONTEND_COALESCED
    fleet = {}
    for t in range(FRONTEND_TENANTS):
        fleet[t] = []
        for cfg_name, cfg in CONFIGS.items():
            ops = t == 0 and cfg_name == "MAG"
            direct = api.CodecConfig(matcher="ops" if ops else None, **cfg)
            fleet[t].append((f"{cfg_name}-d", cfg_name, direct, False,
                             t * per))
            fleet[t] += [(f"{cfg_name}-c{k}", cfg_name, api.CodecConfig(**cfg),
                          True, t * per + k) for k in range(1, per)]
    return fleet


async def frontend_ingest(host, port, t, streams, traffic, max_requests=None):
    """Tenant ``t``'s closed-loop ingest over one keep-alive connection:
    opens its streams, sends chunks of a seeded length in COALESCE_CHUNK
    round robin over them (every FRONTEND_LINES_EVERY-th request a
    FRONTEND_LINES-line JSON-lines /v1/feed), stops after
    ``max_requests`` requests or when every trace is fed, and closes every
    stream.  Returns ``{"chunks", "segs"}`` by stream id, the feed
    requests and lines sent, and the direct feeds as ``(stream id, samples
    before, samples)``."""
    from collections import deque

    from repro_torch import api
    from repro_torch.serve import FrontendClient
    rng = np.random.default_rng(19_000 + t)
    rows = {sid: traffic[cfg_name][row] for sid, cfg_name, _, _, row
            in streams}
    chunks = {sid: [] for sid in rows}
    segs = {sid: [] for sid in rows}
    fed = dict.fromkeys(rows, 0)
    direct = {sid for sid, _, _, coalesce, _ in streams if not coalesce}
    direct_feeds, requests, lines = [], 0, 0
    async with FrontendClient(host, port, f"tenant-{t}") as c:
        for sid, _, cfg, coalesce, _ in streams:
            await c.open(sid, cfg, coalesce=coalesce)
        queue = deque(rows)
        while queue and (max_requests is None or requests < max_requests):
            want = (FRONTEND_LINES if requests % FRONTEND_LINES_EVERY
                    == FRONTEND_LINES_EVERY - 1 else 1)
            batch = []
            while queue and len(batch) < want:
                sid = queue.popleft()
                x = rows[sid]
                n = min(int(rng.integers(*COALESCE_CHUNK, endpoint=True)),
                        len(x) - fed[sid])
                batch.append((sid, x[fed[sid]:fed[sid] + n]))
                if sid in direct:
                    direct_feeds.append((sid, fed[sid], n))
                fed[sid] += n
                chunks[sid].append(batch[-1][1])
                if fed[sid] < len(x):
                    queue.append(sid)
            if len(batch) == 1:
                res = [await c.feed(*batch[0])]
            else:
                docs = await c.post_lines("/v1/feed", [
                    api.CompressRequest(sid, ch).to_json()
                    for sid, ch in batch])
                check(len(docs) == len(batch) and not any(
                    "error" in d for d in docs),
                    f"frontend tenant {t}: JSON-lines feed answered "
                    f"{[d.get('error') for d in docs]}")
                res = [api.FeedResult.from_json(d) for d in docs]
            for (sid, _), r in zip(batch, res):
                check(r.stream_id == sid, f"frontend tenant {t}: answer for "
                      f"{r.stream_id} to a feed of {sid}")
                segs[sid].append(r.segment)
            requests += 1
            lines += len(batch)
        for sid in rows:
            segs[sid].append((await c.close_stream(sid)).segment)
    return {"chunks": chunks, "segs": segs, "requests": requests,
            "lines": lines, "direct_feeds": direct_feeds}


async def frontend_reads(host, port, t, containers, reqs):
    """Tenant ``t`` attaches its containers (``{store id: bytes}``) and
    issues ``reqs`` (``[(request id, store id, start, stop)]``) over
    FRONTEND_INFLIGHT keep-alive connections, each closed loop, so up to
    FRONTEND_INFLIGHT wait in the tenant's decode mux at once.  Returns
    the answers by request id."""
    from repro_torch.serve import FrontendClient
    tenant = f"tenant-{t}"
    async with FrontendClient(host, port, tenant) as c:
        for store_id, blob in containers.items():
            await c.attach(store_id, blob)
    todo, answers = list(reversed(reqs)), {}

    async def worker():
        async with FrontendClient(host, port, tenant) as c:
            while todo:
                rid, store_id, i, j = todo.pop()
                rr = await c.decode(store_id, i, j, request_id=rid)
                check(rr.request_id == rid, f"frontend tenant {t}: answer "
                      f"{rr.request_id} to request {rid}")
                answers[rid] = rr.values

    await asyncio.gather(*(worker() for _ in range(FRONTEND_INFLIGHT)))
    return answers


def frontend_server(dev):
    """The phase's server (not started): the card, ``cuda`` decodes, the
    coalesce phase's flush policy with a 10 ms deadline, a control loop
    whose deadline stays within FRONTEND_MAX_AGE_S, the load generator's
    quota on the noisy tenant, and a staged-block budget per tenant of one
    full batch."""
    from repro_torch.serve import (ControlConfig, ControlLoop, FlushPolicy,
                                   ServeFrontend, TenantQuota)
    policy = FlushPolicy(max_batch_blocks=COALESCE_MAX_BLOCKS,
                         max_batch_streams=COALESCE_STREAMS, max_age_s=0.01)
    return ServeFrontend(
        policy=policy,
        control=ControlLoop(policy=policy, config=ControlConfig(
            max_age_s=FRONTEND_MAX_AGE_S)),
        default_quota=TenantQuota(max_staged_blocks=COALESCE_MAX_BLOCKS),
        quotas={"noisy": TenantQuota(max_bytes_per_s=64_000,
                                     burst_bytes=16_384)},
        device=dev, decode_backend="cuda")


def phase_frontend(torch, dev, card):
    """[frontend]: FRONTEND_TENANTS tenants and the noisy one over real
    sockets to one ``ServeFrontend`` on the card (ticker and control loop
    on): per tenant and Table I configuration a direct stream and
    FRONTEND_COALESCED coalesced ones of FRONTEND_SAMPLES, then
    FRONTEND_DECODES range reads of each of its three direct streams,
    packed and attached.  Launch counts are zeroed just before the serving
    run and read just after.  Checks: direct streams == a ``cuda`` shadow
    session fed the same chunks (tenant 0's also == ``numpy``; the ``ops``
    stream == a fused one); coalesced streams decode == the one-shot
    decode of their traces, miss blocks (std) or bases exact; every answer
    == its slice of the full ``cuda`` and ``numpy`` decodes bitwise; K1 ==
    whole-block direct ``cuda`` feeds + coalescer flushes, K3 == the
    ``ops`` stream's block steps, K2 == ANG_delta ``cuda`` dispatches; the
    noisy tenant sees a typed 429 and the scrape counts it; both p99 SLOs
    hold; the port's load generator reports ok.  Returns the launches by
    kernel."""
    import os
    import tempfile

    from repro_torch import api, obs
    from repro_torch.core import IdealemCodec
    from repro_torch.core.session import IdealemSession
    from repro_torch.core.stream import _walk_all, decode_stream
    from repro_torch.kernels import dict_match as k3
    from repro_torch.kernels import encode_step as k1
    from repro_torch.kernels import seq_cumsum as k2
    from repro_torch.launch.loadgen import run_noisy_tenant
    from repro_torch.serve import FrontendClient, StreamCoalescer
    from repro_torch.serve.tenancy import Tenant
    from repro_torch.store import pack
    reg = obs.registry()
    names = list(CONFIGS)
    per = 1 + FRONTEND_COALESCED
    n_rows = FRONTEND_TENANTS * per
    traffic = {c: make_traffic(c, range(i * n_rows, (i + 1) * n_rows),
                               FRONTEND_SAMPLES)
               for i, c in enumerate(names)}
    fleet = frontend_fleet()
    rng = np.random.default_rng(19)
    reqs = {t: [(f"{c}:{k}", c, i, j) for c in names
                for k, (i, j) in enumerate(block_ranges(
                    rng, FRONTEND_SAMPLES // CONFIGS[c]["block_size"],
                    FRONTEND_DECODES, FRONTEND_DECODE_BLOCKS))]
            for t in fleet}
    # the read service's stage histograms start empty, as in a fresh
    # server process: the control loop steers on this phase's traffic
    for fam in reg.families():
        if fam.name == "repro_serve_stage_seconds":
            for child in fam.children.values():
                child.reset()

    async def tenant_run(fe, t):
        t0 = time.perf_counter()
        ing = await frontend_ingest(fe.host, fe.port, t, fleet[t], traffic)
        t1 = time.perf_counter()
        direct = {c: b"".join(ing["segs"][f"{c}-d"]) for c in names}
        answers = await frontend_reads(
            fe.host, fe.port, t, {c: pack(b) for c, b in direct.items()},
            reqs[t])
        return ing, direct, answers, (t0, t1, time.perf_counter())

    async def serve():
        fe = await frontend_server(dev).start()
        noisy = {"tenants": []}
        try:
            out = await asyncio.gather(
                *(tenant_run(fe, t) for t in fleet),
                run_noisy_tenant(fe.host, fe.port, noisy))
            async with FrontendClient(fe.host, fe.port, "probe") as c:
                scrape, control = await c.metrics(), await c.control()
            depths = {t.id: t._decomp._pipe.depth
                      for t in fe.tenants.tenants.values()
                      if t._decomp is not None}
        finally:
            await fe.close()
        return out[:-1], noisy["tenants"][0], scrape, control, depths

    f0 = reg.get_value("repro_encode_flushes_total")
    adj0 = {k: reg.get_value("repro_control_adjustments_total", {"knob": k})
            for k in ("max_batch_blocks", "max_age_s", "pipeline_depth")}
    rep0 = reg.get_value("repro_control_reprobes_total")
    torch.cuda.synchronize()
    k1.launches = k2.launches = k3.launches = 0
    with reconstruct_units() as units:
        t_start = time.perf_counter()
        runs, noisy, scrape, control, depths = asyncio.run(serve())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_start
    launches = {"encode_step": k1.launches, "seq_cumsum": k2.launches,
                "dict_match": k3.launches}
    flushes = int(reg.get_value("repro_encode_flushes_total") - f0)
    adjust = {k: int(reg.get_value("repro_control_adjustments_total",
                                   {"knob": k}) - v)
              for k, v in adj0.items()}
    reprobes = int(reg.get_value("repro_control_reprobes_total") - rep0)

    # ---------------------------------------------------- launch counts
    whole = 0
    for t, (ing, _, _, _) in enumerate(runs):
        for sid, before, n in ing["direct_feeds"]:
            if t == 0 and sid == "MAG-d":
                continue  # the ops stream launches K3, not K1
            B = CONFIGS[sid.split("-")[0]]["block_size"]
            whole += (before + n) // B > before // B
    ops_steps = FRONTEND_SAMPLES // CONFIGS["MAG"]["block_size"]
    delta_units = sum(b == "cuda" and mode == 2 for b, _, mode in units)
    check(launches["encode_step"] == whole + flushes,
          f"frontend: K1 launches {launches['encode_step']} == whole-block "
          f"direct cuda feeds {whole} + coalescer flushes {flushes}")
    check(launches["dict_match"] == ops_steps,
          f"frontend: K3 launches {launches['dict_match']} == the ops "
          f"stream's block steps {ops_steps}")
    check(launches["seq_cumsum"] == delta_units and delta_units > 0,
          f"frontend: K2 launches {launches['seq_cumsum']} == ANG_delta "
          f"cuda dispatches {delta_units}")
    check(all(b == "cuda" for b, _, _ in units),
          f"frontend: every decode dispatch on cuda "
          f"({sorted({b for b, _, _ in units})})")

    # ------------------------------------------------------ admission
    parsed = obs.parse_prometheus(scrape)
    rejections = sum(v for (name, _), v in parsed.items()
                     if name == "repro_frontend_rejections_total")
    check(noisy["rejections_seen"] >= 1 and rejections > 0,
          f"frontend: the noisy tenant saw {noisy['rejections_seen']} typed "
          f"429s, /metrics counts {rejections}")
    slos = obs.evaluate_slos([
        obs.SloSpec("repro_frontend_request_seconds", 0.99, limit,
                    {"route": route})
        for route, limit in FRONTEND_SLOS.items()], parsed=parsed)
    for res in slos:
        check(res.ok and res.value is not None, f"frontend: {res.describe()}")
    routes = sorted({dict(items).get("route") for (name, items), _
                     in parsed.items()
                     if name == "repro_frontend_request_seconds_count"})
    latency = {r: {f"p{int(q * 100)}": obs.quantile_from_parsed(
        parsed, "repro_frontend_request_seconds", q, {"route": r})
        for q in (0.5, 0.99)} for r in routes}

    # ------------------------------------------------- bytes and answers
    for t, (ing, direct, answers, _) in enumerate(runs):
        for sid, cfg_name, cfg, coalesce, row in fleet[t]:
            if coalesce:
                continue
            kw = dict(CONFIGS[cfg_name])
            arms = ("cuda", "numpy") if t == 0 else ("cuda",)
            for backend in arms:
                sess = IdealemCodec(backend=backend, device=dev,
                                    **kw).session()
                want = b"".join([sess.feed(ch) for ch in ing["chunks"][sid]]
                                + [sess.finish()])
                check(direct[cfg_name] == want,
                      f"frontend tenant {t} {sid}"
                      f"{' (ops)' if cfg.matcher else ''}: wire bytes == a "
                      f"{backend} shadow session fed the same chunks")
        for cfg_name in names:
            blob = direct[cfg_name]
            y = decode_stream(blob, device=dev)
            y_np = decode_stream(blob, backend="numpy")
            check(y.tobytes() == y_np.tobytes(),
                  f"frontend tenant {t} {cfg_name}: cuda decode == numpy")
            B = CONFIGS[cfg_name]["block_size"]
            for rid, store_id, i, j in reqs[t]:
                if store_id == cfg_name:
                    check(answers[rid].tobytes()
                          == y[i * B:j * B].tobytes(),
                          f"frontend tenant {t} {rid}: answer == the full "
                          f"cuda and numpy decodes' slice")
    # coalesced streams: == the one-shot decode of each trace (one
    # single-feed batched session a configuration: the same decisions)
    ratio = {}
    for cfg_name in names:
        kw = CONFIGS[cfg_name]
        B = kw["block_size"]
        codec = IdealemCodec(device=dev, **kw)
        x = traffic[cfg_name]
        sess = codec.session(channels=n_rows, emit_segments=False)
        sess.feed(x)
        oneshot = sess.finish()
        wire_bytes = 0
        for t, (ing, _, _, _) in enumerate(runs):
            for sid, c, _, coalesce, row in fleet[t]:
                if c != cfg_name:
                    continue
                blob = b"".join(ing["segs"][sid])
                wire_bytes += len(blob)
                if not coalesce:
                    continue
                y = decode_stream(blob, device=dev)
                want = decode_stream(oneshot[row], device=dev)
                check(y.tobytes() == want.tobytes(),
                      f"frontend tenant {t} {sid}: decode == the one-shot "
                      "decode of its trace")
                nb = FRONTEND_SAMPLES // B
                yb = y[:nb * B].reshape(nb, B)
                xb = x[row, :nb * B].reshape(nb, B)
                if kw["mode"] == "std":
                    miss = ~_walk_all(memoryview(blob))[1]
                    exact = np.array_equal(yb[miss], xb[miss])
                else:
                    exact = np.array_equal(yb[:, 0], xb[:, 0])
                check(exact and np.array_equal(y[nb * B:], x[row, nb * B:]),
                      f"frontend tenant {t} {sid}: miss blocks (std) or "
                      "bases and tail exact")
        ratio[cfg_name] = x.nbytes / wire_bytes

    # ------------------------------------------------------------ report
    feeds = sum(ing["requests"] for ing, _, _, _ in runs)
    lines = sum(ing["lines"] for ing, _, _, _ in runs)
    t0 = min(tm[0] for *_, tm in runs)
    ingest_s = max(tm[1] for *_, tm in runs) - t0
    read_s = max(tm[2] for *_, tm in runs) - min(tm[1] for *_, tm in runs)
    decodes = sum(len(r) for r in reqs.values())
    nbytes = sum(x.nbytes for x in traffic.values())
    res = {"tenants": len(runs), "streams": sum(map(len, fleet.values())),
           "samples_per_stream": FRONTEND_SAMPLES,
           "feed_requests": feeds, "feed_lines": lines,
           "feed_requests_per_s": feeds / ingest_s,
           "feed_MBps_in": nbytes / ingest_s / 1e6, "ingest_s": ingest_s,
           "decode_requests": decodes, "decode_requests_per_s":
               decodes / read_s, "decode_s": read_s, "wall_s": wall,
           "ratio": ratio, "latency_s_by_route": latency,
           "launches": launches, "coalescer_flushes": flushes,
           "whole_block_direct_feeds": whole,
           "ang_delta_cuda_dispatches": delta_units,
           "decode_dispatches": len(units),
           "noisy": noisy, "rejections_total": rejections,
           "slos": {r.spec.describe(): r.value for r in slos},
           "control": control, "control_adjustments": adjust,
           "control_reprobes": reprobes,
           "decode_pipeline_depth_by_tenant": depths}
    say(f"[frontend] {json.dumps(res)} [{card}]")
    say(f"[frontend] checks passed: {res['streams']} streams; direct == "
        "cuda shadows (tenant 0 also numpy; ops == fused); coalesced == "
        f"one-shot decodes; {decodes} answers == full cuda and numpy "
        f"decodes; K1 {launches['encode_step']} == {whole} + {flushes}, K3 "
        f"{launches['dict_match']} == {ops_steps} steps, K2 "
        f"{launches['seq_cumsum']} == {delta_units} dispatches; noisy 429s "
        f"seen and counted; p99 SLOs held")

    # one ingest window again, on a fresh server, under the profiler
    async def ingest_window():
        fe = await frontend_server(dev).start()
        try:
            await asyncio.gather(*(frontend_ingest(
                fe.host, fe.port, t, fleet[t], traffic,
                max_requests=FRONTEND_PROFILE_ROUNDS * len(fleet[t]))
                for t in fleet))
        finally:
            await fe.close()

    route = {"route": "POST /v1/feed"}
    with host_seconds(feed=(Tenant, "feed"),
                      direct_feed=(IdealemSession, "feed"),
                      coalescer_submit=(StreamCoalescer, "submit"),
                      parse=(api.CompressRequest, "from_json"),
                      answer=(api.FeedResult, "to_json"),
                      prepare=(IdealemSession, "prepare"),
                      commit=(IdealemSession, "commit")) as host:
        s0 = histogram_sum("repro_frontend_request_seconds", route)
        f0 = histogram_sum("repro_encode_flush_seconds")
        out = device_profile(torch, lambda: asyncio.run(ingest_window()),
                             names=("encode_scan", "dict_match", "HtoD",
                                    "DtoH", "Sort"))
        handlers_s = histogram_sum("repro_frontend_request_seconds",
                                   route) - s0
        flush_s = histogram_sum("repro_encode_flush_seconds") - f0
    runs_ = out["runs"]
    out.update({f"host_{k}_s": v / runs_ for k, v in host.items()},
               host_feed_handlers_s=handlers_s / runs_,
               host_coalescer_flushes_s=flush_s / runs_,
               requests_per_tenant=FRONTEND_PROFILE_ROUNDS
               * len(fleet[0]))
    say(f"[profile] frontend ingest, the first {out['requests_per_tenant']}"
        f" feed requests of {FRONTEND_TENANTS} tenants on a fresh server: "
        f"{json.dumps(out)} [{card}]")

    # the port's load generator at its acceptance profile, its own process
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "loadgen.json")
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (str(ROOT / "src"), os.environ.get("PYTHONPATH"))
            if p))
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.loadgen",
             "--tenants", str(FRONTEND_TENANTS), "--device", dev.type,
             "--json", path], env=env, capture_output=True, text=True,
            timeout=600)
        check(proc.returncode == 0 and os.path.exists(path),
              f"frontend: loadgen exited {proc.returncode}: "
              f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
        with open(path) as fh:
            lg = json.load(fh)
    check(lg["ok"], f"frontend: loadgen report {lg['problems']}")
    say(f"[frontend] loadgen --tenants {FRONTEND_TENANTS} --device "
        f"{dev.type}: ok, {lg['byte_diffs']} byte diffs, "
        f"{lg['decode_diffs']} decode diffs, {lg['rejections_seen']} typed "
        f"rejections, wall {lg['wall_s']} s, slos {json.dumps(lg['slos'])} "
        f"[{card}]")
    return launches


def time_k3(torch, dev, C, D, n, sorted_rows=False):
    """K3 at an encoder step shape: C candidates against D full rows, in
    random order or (as the ops path passes the dictionary) sorted."""
    from repro_torch.kernels import dict_match as k3
    from repro_torch.kernels import ref
    rng = np.random.default_rng(n)
    xs = torch.sort(torch.from_numpy(rng.normal(size=(C, n))).to(
        dev, torch.float32), dim=-1).values
    rows = torch.from_numpy(rng.normal(size=(C, D, n))).to(dev, torch.float32)
    if sorted_rows:
        rows = torch.sort(rows, dim=-1).values
    lo, hi = rows.amin(-1), rows.amax(-1)
    args = (xs, rows, lo, hi, 0.5)
    ms = cuda_ms(lambda: k3.dict_match_cuda(*args), reps=50, queued=True)
    ks, mm = k3.dict_match_cuda(*args)
    plain_ms = cuda_ms(lambda: ref.dict_match_ref(*args), reps=3)
    ks_p, mm_p = ref.dict_match_ref(*args)
    err = max(float((ks - ks_p).abs().max()),
              float((mm != mm_p).sum()))
    nbytes = 4 * (C * n + C * D * n + 2 * C * D + C * D) + C * D
    # the least work per row: sorting it (n log2 n compares; none for a
    # sorted row) and merging it with the sorted candidate (2 n)
    sort_ops = 0.0 if sorted_rows else n * np.log2(max(n, 2))
    ops = int(round(C * D * (sort_ops + 2 * n)))
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / PEAK_COMPARES * 1e3
    return {
        "ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
        "shape": {"C": C, "D": D, "n": n, "rows": "sorted" if sorted_rows
                  else "random"},
        "plan": k3.plan(C, D, n), "bytes": nbytes, "ops": ops,
    }


def k1_work(torch, xs, is_hit, D, rel_tol, raw=None, bound=None,
            cumulative=False, nf=None):
    """(valid rows, gate-passing rows, rows that reach the KS) summed over
    a scan from an empty dictionary: each step's dictionary is replayed
    from the decisions.  With ``bound``, a gate-passing row reaches the KS
    only if its raw row is within the bound (replayed from ``raw``).  With
    per-lane widths ``nf`` (C,) (the chan operand's), the gate reads each
    block's point nf - 1 and the KS rows come back per lane, (C,)."""
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
    top = xs[..., -1] if nf is None else torch.gather(
        xs, 2, (nf - 1)[:, None, None].expand(C, nb, 1))[..., 0]
    dmin = torch.gather(xs[..., 0], 1, idx).reshape(C, nb, D)
    dmax = torch.gather(top, 1, idx).reshape(C, nb, D)
    r = torch.tensor(float(np.float32(rel_tol)), dtype=torch.float32,
                     device=dev)
    t = (dmax - dmin) * r
    xmin, xmax = xs[..., :1], top[..., None]
    gate = valid & (xmin >= dmin - t) & (xmin <= dmin + t) \
        & (xmax >= dmax - t) & (xmax <= dmax + t)
    if nf is not None:
        return int(valid.sum()), int(gate.sum()), gate.sum((1, 2))
    ks_rows = int(gate.sum())
    if bound is not None:
        ks_rows = 0
        for lo in range(0, nb, 64):  # (C, 64, D, n) at a time
            hi = min(nb, lo + 64)
            rows = torch.gather(raw, 1, idx.reshape(C, nb, D)[:, lo:hi]
                                .reshape(C, -1, 1).expand(-1, -1, n))
            diff = raw[:, lo:hi, None, :] - rows.reshape(C, hi - lo, D, n)
            if cumulative:
                diff = torch.cumsum(diff, dim=-1)
            ok = (diff.abs() <= bound).all(-1)
            ks_rows += int((gate[:, lo:hi] & ok).sum())
    return int(valid.sum()), int(gate.sum()), ks_rows


def time_k1(torch, dev, codec, pay, error_bound=None):
    """K1 on one feed ``pay`` (C, nb, n) from an empty dictionary, with
    ``codec``'s D, d_crit, rel_tol and mode (the error gate is cumulative
    in delta mode) and, if given, ``error_bound``."""
    from repro_torch.core.encoder import init_state
    from repro_torch.kernels import encode_step as k1
    C, nb, n = pay.shape
    D = codec.num_dict
    eb = error_bound is not None
    raw = torch.as_tensor(pay, dtype=torch.float32, device=dev)
    xs = torch.sort(raw, dim=-1).values
    valid = torch.ones((C, nb), dtype=torch.bool, device=dev)
    st = init_state(D, n, channels=C, device=dev, raw=eb)
    kw = dict(d_crit=codec.d_crit, rel_tol=codec.rel_tol)
    if eb:
        kw.update(raw=raw, error_bound=error_bound,
                  error_cumulative=codec.mode == "delta")
    ms = cuda_ms(lambda: k1.encode_scan(xs, valid, st, **kw), reps=5,
                 queued=True)
    got, gst = k1.encode_scan(xs, valid, st, **kw)
    (want, wst), plain_ms = cuda_ms_once(
        lambda: k1.encode_scan_torch(xs, valid, st, **kw))
    err = max(float((a.double() - b.double()).abs().max())
              for a, b in zip((*got, *gst), (*want, *wst)) if a.numel())
    rows, gated, ks_rows = k1_work(
        torch, xs, got[0], D, codec.rel_tol, raw, error_bound,
        eb and kw["error_cumulative"])
    nbytes = (xs.numel() * 4 + valid.numel()
              + 2 * C * (D * n * 4 + D * 9 + 4) + C * nb * 6)
    ops = rows * K1_GATE_OPS + ks_rows * K1_KS_OPS_PER_SAMPLE * n
    if eb:  # the raw candidates in, the raw rows in and out; the error gate
        nbytes += raw.numel() * 4 + 2 * C * D * n * 4
        ops += gated * K1_EB_OPS_PER_SAMPLE * n
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / PEAK_OPS["f32"] * 1e3
    return {
        "ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
        "us_per_block_step": ms / nb * 1e3,
        "shape": {"C": C, "nb": nb, "n": n, "D": D},
        "valid_rows": rows, "gated_rows": gated, "ks_rows": ks_rows,
        "bytes": nbytes, "ops": ops,
        "misses": int((~got[0]).sum()), "overwrites": int(got[2].sum()),
    }


def time_k1_mixed(torch, dev, pay, nf, d_crit, codec):
    """K1 with its chan operand on one mixed feed ``pay`` (C, nb, n) whose
    lane c holds ``nf[c]`` points and +inf pads (mixed_first_feed), from an
    empty dictionary, with per-lane ``d_crit``."""
    from repro_torch.core.encoder import chan_params, init_state
    from repro_torch.kernels import encode_step as k1
    C, nb, n = pay.shape
    D = codec.num_dict
    xs = torch.sort(torch.from_numpy(pay).to(dev), dim=-1).values
    valid = torch.ones((C, nb), dtype=torch.bool, device=dev)
    st = init_state(D, n, channels=C, device=dev)
    chan = chan_params(nf, d_crit, np.zeros(C, bool), np.zeros(C, bool),
                       dev).block()
    kw = dict(d_crit=0.0, rel_tol=codec.rel_tol, chan=chan)
    ms = cuda_ms(lambda: k1.encode_scan(xs, valid, st, **kw), reps=5,
                 queued=True)
    got, gst = k1.encode_scan(xs, valid, st, **kw)
    (want, wst), plain_ms = cuda_ms_once(
        lambda: k1.encode_scan_torch(xs, valid, st, **kw))
    err = max(float((a.double() - b.double()).abs().max())
              for a, b in zip((*got, *gst), (*want, *wst)) if a.numel())
    nft = torch.from_numpy(nf).to(dev)
    rows, gated, ks_lane = k1_work(torch, xs, got[0], D, codec.rel_tol,
                                   nf=nft)
    nbytes = (xs.numel() * 4 + valid.numel() + chan.numel() * 4
              + 2 * C * (D * n * 4 + D * 9 + 4) + C * nb * 6)
    ops = rows * K1_GATE_OPS + int((ks_lane * nft).sum()) \
        * K1_KS_OPS_PER_SAMPLE
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / PEAK_OPS["f32"] * 1e3
    return {
        "ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
        "us_per_block_step": ms / nb * 1e3,
        "shape": {"C": C, "nb": nb, "n": n, "D": D,
                  "widths": {str(w): int((nf == w).sum())
                             for w in np.unique(nf)}},
        "valid_rows": rows, "gated_rows": gated,
        "ks_rows": int(ks_lane.sum()), "bytes": nbytes, "ops": ops,
        "misses": int((~got[0]).sum()), "overwrites": int(got[2].sum()),
    }


def time_k2(torch, dev, rows, width, dtype=np.float64, xt=None):
    """K2 on random rows of the given shape, or on the operand ``xt`` a
    path handed it; held bitwise against its plain version and
    ``np.cumsum``."""
    from repro_torch.kernels import seq_cumsum as k2
    if xt is None:
        rng = np.random.default_rng(11)
        x = rng.normal(0, 0.05, (rows, width)).astype(dtype)
        x[:, 0] = -0.0
        xt = torch.from_numpy(x).to(dev)
    rows, width = xt.shape
    dtype = xt[:0].cpu().numpy().dtype
    ms = cuda_ms(lambda: k2.seq_cumsum(xt), reps=20, queued=True)
    got = k2.seq_cumsum(xt)
    plain_ms = cuda_ms(lambda: k2.seq_cumsum_torch(xt), reps=3)
    want = k2.seq_cumsum_torch(xt)
    library_ms = cuda_ms(lambda: torch.cumsum(xt, dim=1), reps=20,
                         queued=True)
    nbytes = 2 * xt.numel() * xt.element_size()
    ops = rows * (width - 1)  # f16 adds in f32
    rate = PEAK_OPS["f64" if dtype == np.float64 else "f32"]
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / rate * 1e3
    bits = got.cpu().numpy().tobytes()
    bitwise = (bits == want.cpu().numpy().tobytes()
               and bits == np.cumsum(xt.cpu().numpy(), axis=1).tobytes())
    return {
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "max_abs_err": float((got.double() - want.double()).abs().max()),
        "bitwise_plain_and_np_cumsum": bitwise,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "shape": {"R": rows, "P": width, "dtype": np.dtype(dtype).name},
    }


def k4_case(torch, dev, B, H, Hkv, hd, C, dtype, seed):
    """K4 operands: a query scaled by hd**-0.5 (``decode_attention``'s
    contract); rows masked with ``decode_attention``'s own ring formula at
    several positions, plain, windowed and wrapped; the last row with no
    valid position (its output must be the mean of V)."""
    from repro_torch.models.attention import ring_valid
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.normal(size=(B, H, hd)) * hd ** -0.5).to(
        dev, torch.float32)
    k = torch.from_numpy(rng.normal(size=(B, C, Hkv, hd))).to(dev, dtype)
    v = torch.from_numpy(rng.normal(size=(B, C, Hkv, hd))).to(dev, dtype)
    windows = [None, 3, C // 2 + 1, None]
    valid = torch.stack([
        ring_valid(int(pos), C, windows[b % 4], dev)
        for b, pos in enumerate(rng.integers(0, 3 * C, B))])
    valid[-1] = False
    return q, k, v, valid


def phase_k4(torch, dev):
    from repro_torch.kernels import flash_decode as k4
    shapes = [(2, 8, 2, 16, 1024), (1, 4, 4, 32, 512), (3, 16, 8, 64, 2048),
              (2, 6, 6, 64, 512)]           # tests/test_flash_decode_kernel.py
    shapes += [(B, Hkv * G, Hkv, hd, C) for G in (1, 4, 16)
               for hd in (64, 128) for B, Hkv, C in ((3, 8, 700), (4, 2, 33))]
    shapes += [(2, 4, 4, 64, 1), (8, 32, 8, 128, 2048)]
    # split along C: a ragged last split (fewer tiles, a ragged last tile),
    # G = 6 in head groups, and C = 32,768 at B = 1
    shapes += [(2, 8, 2, 64, 64 * 37 + 9), (3, 48, 8, 128, 1000),
               (1, 32, 8, 128, 32768)]
    worst = 0.0
    n = 0
    splits_seen, ragged = {}, 0
    for i, shape in enumerate(shapes):
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            q, k, v, valid = k4_case(torch, dev, *shape, dtype, seed=i)
            B, H, Hkv, hd, C = shape
            splits = k4._splits(dev, dtype, B, C, Hkv, H // Hkv, hd)
            tiles = -(-C // 64)
            tps = -(-tiles // splits)
            splits_seen[str(shape)] = splits
            ragged += splits > 1 and (tiles % tps or C % 64)
            got = k4.flash_decode(q, k, v, valid)
            torch.cuda.synchronize()
            err = float((got - k4.flash_decode_torch(q, k, v, valid))
                        .abs().max())
            G = shape[1] // shape[2]
            mean_v = v[-1].float().mean(0).repeat_interleave(G, dim=0)
            err_mean = float((got[-1] - mean_v).abs().max())
            if B == 1:  # its one row is all masked: also every position valid
                full = torch.ones_like(valid)
                err = max(err, float((k4.flash_decode(q, k, v, full)
                                      - k4.flash_decode_torch(q, k, v, full))
                                     .abs().max()))
            check(err <= K4_TOL and err_mean <= K4_TOL,
                  f"K4 {shape} {dtype}: {err} / all-masked row {err_mean} "
                  f"<= {K4_TOL}")
            worst = max(worst, err, err_mean)
            n += 1
    check(ragged > 0 and splits_seen[str(shapes[-1])] > 1,
          f"K4 cases split C with a ragged last split ({splits_seen})")
    say(f"[K4] {n} cases within {K4_TOL} of the plain version on the card "
        f"(largest difference {worst}; JAX test shapes, C in "
        f"1/33/700/1000/2048/2377/32768, G in 1/4/6/16, hd in 64/128, "
        f"f32/bf16/f16 caches, ring and window masks, an all-masked row == "
        f"mean of V); splits {json.dumps(splits_seen)}")


def tree_bytes(tree):
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def phase_serve(torch, dev, card):
    """granite-3-8b at full width through ``ServeEngine.generate``."""
    import repro_torch.models.attention as attn
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_decode as k4
    from repro_torch.models import lm
    from repro_torch.serve import ServeEngine, prefill_step
    cfg = get_config(SERVE_ARCH)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = cfg.param_count()
    check(n_params == 8_170_848_256, f"{cfg.name} parameters {n_params}")
    weight_bytes = tree_bytes(params)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT)).astype(np.int32)
    engine = ServeEngine(cfg, params, max_seq=SERVE_MAX_SEQ, device=dev)
    engine.generate(prompts[:, :4], 2)  # warm-up: cuBLAS handles, kernels
    torch.cuda.synchronize()

    # the main path, with K4's last operands kept (the last layer of the
    # last step: nothing writes its cache after that launch)
    seen = {}
    real = attn.flash_decode

    def keep(*args):
        seen["args"] = args
        return real(*args)

    torch.cuda.reset_peak_memory_stats()
    attn.flash_decode = keep
    try:
        k4.launches = 0
        t0 = time.perf_counter()
        out = engine.generate(prompts, SERVE_GEN)
        total_s = time.perf_counter() - t0
        launches = k4.launches
    finally:
        attn.flash_decode = real
    peak = torch.cuda.max_memory_allocated()
    want = cfg.num_layers * (SERVE_PROMPT + SERVE_GEN)
    check(launches == want, f"serve: K4 launches {launches} == {want}")
    check(out.shape == (SERVE_BATCH, SERVE_GEN) and out.min() >= 0
          and out.max() < cfg.vocab_size, f"serve: tokens {out.shape}")
    q, kc, vc, valid = seen.pop("args")
    got = k4.flash_decode(q, kc, vc, valid)
    late_err = float((got - k4.flash_decode_torch(q, kc, vc, valid))
                     .abs().max())
    check(late_err <= K4_TOL, f"serve: K4 == plain on the last layer's "
          f"operands at position {SERVE_PROMPT + SERVE_GEN - 1} ({late_err})")
    del q, kc, vc, valid, got

    prefill_s, decode_s = engine.stats["prefill_s"], engine.stats["decode_s"]

    # teacher-forced: the K4 core against the plain core, step by step
    forced = torch.from_numpy(prompts[:, :SERVE_FORCED]).to(dev).long()
    logits, caches = {}, {}
    for backend in ("cuda", "torch"):
        cache = lm.init_cache(cfg, SERVE_BATCH, SERVE_MAX_SEQ, device=dev)
        steps = []
        for t in range(SERVE_FORCED):
            lg, cache = lm.decode_step(params, cache, forced[:, t:t + 1], cfg,
                                       backend=backend)
            steps.append(lg[:, 0])
        logits[backend] = torch.stack(steps, dim=1)
        caches[backend] = cache
    diff = float((logits["cuda"] - logits["torch"]).abs().max())
    agree = float((logits["cuda"].argmax(-1) == logits["torch"].argmax(-1))
                  .float().mean())
    scale = float(logits["torch"].abs().max())
    check(bool(torch.isfinite(logits["cuda"]).all()), "serve: finite logits")
    check(diff <= SERVE_LOGIT_TOL,
          f"serve: backend=cuda logits within {SERVE_LOGIT_TOL} of "
          f"backend=torch over {SERVE_FORCED} teacher-forced steps ({diff})")
    # the forward (prefill_step) at the last forced position, held to the
    # reference's decode-vs-forward contract (tests/test_serve_and_data.py)
    fwd = prefill_step(params, forced, cfg)[:, 0]
    dec = logits["cuda"][:, -1]
    fwd_diff = float((fwd - dec).abs().max())
    fwd_agree = float((fwd.argmax(-1) == dec.argmax(-1)).float().mean())
    check(bool(torch.isfinite(fwd).all()) and bool(torch.all(
        (fwd - dec).abs() <= 0.75 + 0.1 * dec.abs())),
        f"serve: prefill_step logits within atol 0.75 / rtol 0.1 of the "
        f"decode path's ({fwd_diff})")
    del caches["torch"], logits, fwd, dec

    # 16 decode steps under the profiler, from the forced cache
    cache = caches.pop("cuda")
    tok = forced[:, -1:]

    def steps():
        c = cache
        for _ in range(SERVE_PROFILED):
            _, c = lm.decode_step(params, c, tok, cfg)
    prof = device_profile(torch, steps, names=("flash_decode_split",
                                              "flash_decode_combine"))
    # the same steps unprofiled: the host's seconds to issue them, and to
    # their end on the card; issue close to wall means the host sets the
    # pace (the card drains its queue as soon as the host stops)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps()
    issue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    res = {
        "arch": cfg.name, "params": n_params, "weight_GB": weight_bytes / 1e9,
        "init_s": init_s, "peak_GB": peak / 1e9,
        "batch": SERVE_BATCH, "prompt": SERVE_PROMPT, "generated": SERVE_GEN,
        "max_seq": SERVE_MAX_SEQ, "total_s": total_s, "prefill_s": prefill_s,
        "decode_s": decode_s,
        "prefill_tok_s": SERVE_BATCH * SERVE_PROMPT / prefill_s,
        "decode_tok_s": SERVE_BATCH * SERVE_GEN / decode_s,
        "decode_step_ms": decode_s / SERVE_GEN * 1e3,
        "k4_launches": launches, "k4_late_step_err": late_err,
        "forced_logit_max_diff": diff, "forced_logit_max_abs": scale,
        "forced_greedy_agreement": agree,
        "prefill_step_logit_max_diff": fwd_diff,
        "prefill_step_greedy_agreement": fwd_agree,
        "device_ops_per_step": prof["device_events"] / SERVE_PROFILED,
        "step_issue_ms": issue_s / SERVE_PROFILED * 1e3,
        "step_wall_ms": window_s / SERVE_PROFILED * 1e3,
    }
    say(f"[serve] {json.dumps(res)} [{card}]")
    say(f"[profile] serve {SERVE_PROFILED} decode steps "
        f"(B={SERVE_BATCH}, position {SERVE_FORCED}): {json.dumps(prof)} "
        f"[{card}]")
    return launches


def phase_families(torch, dev, card):
    """The other decode families at published widths through
    ``ServeEngine.generate``, one at a time (each model is freed before
    the next is built).  Returns K4's launches on their main path."""
    import repro_torch.models.attention as attn
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_decode as k4
    from repro_torch.launch.serve import memory_len
    from repro_torch.models import lm
    from repro_torch.models.layers import unembed
    from repro_torch.serve import ServeEngine
    total = 0
    for arch, depth, n_want, cmp_dtype in FAMILIES:
        t_start = time.perf_counter()
        full = get_config(arch)
        n_params = full.param_count()
        check(n_params == n_want, f"{arch} parameters {n_params} == {n_want}")
        t_count = time.perf_counter()
        cfg = full if depth is None else full.replace(num_layers=depth)
        M = memory_len(cfg)
        attn_layers = sum(k in lm.SELF_ATTN_KINDS
                          for k in lm.layer_kinds(cfg))
        gen = torch.Generator(device=dev)
        params = lm.init_params(cfg, gen.manual_seed(0), dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t_count
        weight_bytes = tree_bytes(params)
        prompts = np.random.default_rng(0).integers(
            0, cfg.vocab_size, (FAMILY_BATCH, FAMILY_PROMPT)).astype(np.int32)
        engine = ServeEngine(cfg, params, max_seq=FAMILY_MAX_SEQ,
                             memory_len=M, device=dev)
        engine.generate(prompts[:, :1], 1)  # warm-up: cuBLAS handles, K4
        torch.cuda.synchronize()

        # the main path, with K4's last operands kept (the last
        # self-attention layer of the last step)
        seen = {}
        real = attn.flash_decode

        def keep(*args):
            seen["args"] = args
            return real(*args)

        torch.cuda.reset_peak_memory_stats()
        attn.flash_decode = keep
        try:
            k4.launches = 0
            out = engine.generate(prompts, FAMILY_GEN)
            launches = k4.launches
        finally:
            attn.flash_decode = real
        peak = torch.cuda.max_memory_allocated()
        want = attn_layers * (FAMILY_PROMPT + FAMILY_GEN)
        check(launches == want, f"{arch}: K4 launches {launches} == {want} "
              f"({attn_layers} self-attention layers a step)")
        check(out.shape == (FAMILY_BATCH, FAMILY_GEN) and out.min() >= 0
              and out.max() < cfg.vocab_size, f"{arch}: tokens {out.shape}")
        total += launches
        late_err = None
        if attn_layers:
            q, kc, vc, valid = seen.pop("args")
            got = k4.flash_decode(q, kc, vc, valid)
            late_err = float((got - k4.flash_decode_torch(q, kc, vc, valid))
                             .abs().max())
            check(late_err <= K4_TOL, f"{arch}: K4 == plain on the last "
                  f"self-attention layer's operands ({late_err})")
            del q, kc, vc, valid, got
        seen.clear()
        prefill_s = engine.stats["prefill_s"]
        decode_s = engine.stats["decode_s"]
        t_gen = time.perf_counter()

        forced = torch.from_numpy(prompts[:, :FAMILY_FORCED]).to(dev).long()
        mem = (None if not M else torch.zeros(
            (FAMILY_BATCH, M, cfg.d_model), dtype=cfg.dtype, device=dev))

        def teacher_forced(c, p, backend):
            cache = lm.init_cache(c, FAMILY_BATCH, FAMILY_MAX_SEQ, M,
                                  device=dev)
            steps = []
            for t in range(FAMILY_FORCED):
                lg, cache = lm.decode_step(p, cache, forced[:, t:t + 1], c,
                                           backend=backend)
                steps.append(lg[:, 0])
            return torch.stack(steps, dim=1), cache

        def compare(c, p):
            """backend=cuda against backend=torch over the forced steps;
            the cuda logits."""
            lg = {b: teacher_forced(c, p, b)[0] for b in ("torch", "cuda")}
            diff = float((lg["cuda"] - lg["torch"]).abs().max())
            agree = float((lg["cuda"].argmax(-1) == lg["torch"].argmax(-1))
                          .float().mean())
            check(bool(torch.isfinite(lg["cuda"]).all()),
                  f"{arch}: finite logits")
            check(diff <= SERVE_LOGIT_TOL,
                  f"{arch}: backend=cuda logits within {SERVE_LOGIT_TOL} of "
                  f"backend=torch over {FAMILY_FORCED} teacher-forced steps "
                  f"in {c.dtype} ({diff})")
            return lg["cuda"], diff, agree

        # the bfloat16 decode from which the profiled steps start
        dec_logits, cache = teacher_forced(cfg, params, "cuda")
        check(bool(torch.isfinite(dec_logits).all()),
              f"{arch}: finite {cfg.dtype} logits")
        if cmp_dtype == "bfloat16":
            dec_logits, diff, agree = compare(cfg, params)
        fwd = {}
        if cfg.family not in ("ssm", "hybrid"):
            # the reference's bfloat16 contract at the last forced
            # position.  A decode step routes one token a row, so no
            # expert's capacity drops a copy; a MoE's forward runs at the
            # capacity that drops none either (C = S), else its capacity
            # drops (the reference's training semantics) would be the
            # difference
            fcfg = cfg if cfg.family != "moe" else cfg.replace(
                capacity_factor=cfg.num_experts / cfg.experts_per_token)
            x, _ = lm.forward_hidden(params, forced, fcfg, mem)
            f, d = unembed(params["embed"], x[:, -1:], cfg)[:, 0], \
                dec_logits[:, -1]
            check(bool(torch.isfinite(f).all()) and bool(torch.all(
                (f - d).abs() <= 0.75 + 0.1 * d.abs())),
                f"{arch}: forward logits within atol 0.75 / rtol 0.1 of the "
                f"decode path's ({float((f - d).abs().max())})")
            fwd = {"contract": "bfloat16 atol 0.75 / rtol 0.1",
                   "capacity_factor": fcfg.capacity_factor,
                   "max_diff": float((f - d).abs().max()),
                   "greedy_agreement": float((f.argmax(-1) == d.argmax(-1))
                                             .float().mean())}
            del x, f, d
        enc = None
        if cfg.family == "audio":  # the encoder over stubbed frames
            frames = torch.randn((FAMILY_BATCH, M, cfg.d_model), device=dev,
                                 generator=gen.manual_seed(1))
            h = lm.encode_frames(params, frames, cfg)
            check(h.shape == frames.shape and bool(torch.isfinite(h).all()),
                  f"{arch}: encode_frames {tuple(h.shape)} finite")
            enc = list(h.shape)
            del frames, h
        del dec_logits, mem
        t_forced = time.perf_counter()

        # FAMILY_PROFILED decode steps under the profiler, from the forced
        # cache, then the same steps unprofiled (host issue vs wall)
        tok = forced[:, -1:]

        def steps():
            c = cache
            for _ in range(FAMILY_PROFILED):
                _, c = lm.decode_step(params, c, tok, cfg)
        prof = device_profile(torch, steps, names=(
            "flash_decode_split", "flash_decode_combine"), cpu=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps()
        issue_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
        banded = None
        if arch == BANDED_ARCH:
            banded = banded_check(torch, dev, card, cfg, params)
        del params, engine, cache, steps
        torch.cuda.empty_cache()
        t_prof = time.perf_counter()

        if cmp_dtype == "float32":
            # compared in float32 (FAMILIES says why), from the same seed;
            # the recurrent families also hold the reference's recurrent
            # contract (tests/test_serve_and_data.py) there
            c32 = cfg.replace(dtype=torch.float32)
            p32 = lm.init_params(c32, gen.manual_seed(0), dev)
            dec32, diff, agree = compare(c32, p32)
            if cfg.family in ("ssm", "hybrid"):
                x, _ = lm.forward_hidden(p32, forced, c32)
                f = unembed(p32["embed"], x, c32)
                a = float((f.argmax(-1) == dec32.argmax(-1)).float().mean())
                check(a > 0.9, f"{arch}: float32 forward vs decode argmax "
                      f"agreement {a} > 0.9")
                fwd = {"contract": "float32 argmax agreement > 0.9",
                       "max_diff": float((f - dec32).abs().max()),
                       "greedy_agreement": a}
                del x, f
            del p32, dec32
            torch.cuda.empty_cache()
        res = {
            "arch": arch, "family": cfg.family, "params_full": n_params,
            "layers_run": cfg.num_layers, "layers_full": full.num_layers,
            "self_attention_layers": attn_layers, "memory_len": M,
            "weight_GB": weight_bytes / 1e9, "peak_GB": peak / 1e9,
            "batch": FAMILY_BATCH, "prompt": FAMILY_PROMPT,
            "generated": FAMILY_GEN, "max_seq": FAMILY_MAX_SEQ,
            "prefill_s": prefill_s, "decode_s": decode_s,
            "prefill_tok_s": FAMILY_BATCH * FAMILY_PROMPT / prefill_s,
            "decode_tok_s": FAMILY_BATCH * FAMILY_GEN / decode_s,
            "decode_step_ms": decode_s / FAMILY_GEN * 1e3,
            "k4_launches": launches, "k4_late_step_err": late_err,
            "forced_compared_in": cmp_dtype,
            "forced_logit_max_diff": diff,
            "forced_greedy_agreement": agree, "forward": fwd or None,
            "encoder_out": enc,
            "device_ops_per_step": prof["device_events"] / FAMILY_PROFILED,
            "step_issue_ms": issue_s / FAMILY_PROFILED * 1e3,
            "step_wall_ms": window_s / FAMILY_PROFILED * 1e3,
            "phase_s": {"param_count": t_count - t_start, "init": init_s,
                        "generate": t_gen - t_count - init_s,
                        "forced_and_forward": t_forced - t_gen,
                        "profile_and_banded": t_prof - t_forced,
                        "float32": time.perf_counter() - t_prof},
        }
        if banded is not None:
            say(f"[banded] {json.dumps(banded)} [{card}]")
        say(f"[families] {json.dumps(res)} [{card}]")
        say(f"[profile] {arch} {FAMILY_PROFILED} decode steps "
            f"(B={FAMILY_BATCH}, position {FAMILY_FORCED}): "
            f"{json.dumps(prof)} [{card}]")
    return total


def banded_check(torch, dev, card, cfg, params):
    """The banded prefill on a model's weights (``BANDED_ARCH``): one local
    layer's q, k, v (its projections and RoPE over seeded hidden states of
    ``BANDED_S`` positions) through ``_flash_banded`` and the unbanded
    chunk loop, equal within ``BANDED_TOL`` and timed; then the forward of
    the whole model at ``BANDED_FORWARD_S`` tokens, every local layer on
    the banded path."""
    from repro_torch.models import attention as attn
    from repro_torch.models import lm
    from repro_torch.serve import prefill_step
    kinds = lm.layer_kinds(cfg)
    p = params["layers"][kinds.index("attn_local")]["attn"]
    S, window, chunk = BANDED_S, cfg.local_window, cfg.attn_chunk
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    check(S % chunk == 0 and S // chunk > window // chunk + 1,
          f"[banded] S={S} takes the banded path at window {window}, "
          f"chunk {chunk}")
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn((1, S, cfg.d_model), device=dev, generator=g).to(
        cfg.dtype)
    pos = torch.arange(S, dtype=torch.int32, device=dev)
    q = attn.rope((x @ p["wq"]).reshape(1, S, h, hd), pos, cfg.rope_theta)
    k = attn.rope((x @ p["wk"]).reshape(1, S, kvh, hd), pos, cfg.rope_theta)
    v = (x @ p["wv"]).reshape(1, S, kvh, hd)
    k, v = attn._repeat_kv(k, h), attn._repeat_kv(v, h)
    del x

    def banded():
        return attn._flash_banded(q, k, v, pos, window=window, chunk=chunk)

    def chunks():
        return attn._flash_chunks(q, k, v, pos, pos, causal=True,
                                  window=window, chunk=chunk)

    got, want = banded(), chunks()
    check(torch.equal(attn._flash(q, k, v, pos, pos, causal=True,
                                  window=window, chunk=chunk), got),
          "[banded] _flash dispatches to _flash_banded")
    err = float((got.float() - want.float()).abs().max())
    check(bool(torch.isfinite(got).all()) and err <= BANDED_TOL,
          f"[banded] _flash_banded within {BANDED_TOL} of the unbanded "
          f"chunk loop ({err})")
    del got, want
    nq = S // chunk
    res = {"S": S, "window": window, "chunk": chunk, "heads": h, "hd": hd,
           "dtype": str(cfg.dtype).split(".")[-1], "max_abs_err": err,
           "tolerance": BANDED_TOL,
           "chunk_pairs": {"banded": nq * (window // chunk + 1),
                           "unbanded": nq * nq},
           "banded_ms": cuda_ms(banded, reps=5),
           "unbanded_ms": cuda_ms(chunks, reps=3)}
    res["speedup"] = res["unbanded_ms"] / res["banded_ms"]
    del q, k, v
    torch.cuda.empty_cache()

    calls = []
    real = attn._flash_banded

    def count(*args, **kw):
        calls.append(kw["window"])
        return real(*args, **kw)

    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, BANDED_FORWARD_S))).to(dev)
    attn._flash_banded = count
    try:
        with torch.no_grad():
            prefill_step(params, toks[:, :chunk], cfg)  # warm-up
            torch.cuda.synchronize()
            calls.clear()
            t0 = time.perf_counter()
            logits = prefill_step(params, toks, cfg)
            torch.cuda.synchronize()
            fwd_s = time.perf_counter() - t0
    finally:
        attn._flash_banded = real
    local = kinds.count("attn_local")
    check(calls == [window] * local,
          f"[banded] forward: {len(calls)} banded layers == {local}")
    check(logits.shape == (1, 1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"[banded] forward logits {tuple(logits.shape)} finite")
    res["forward"] = {"S": BANDED_FORWARD_S, "layers": len(kinds),
                      "banded_layers": local, "seconds": fwd_s,
                      "tokens_per_s": BANDED_FORWARD_S / fwd_s}
    return res


def phase_train(torch, dev, card):
    """The trainer at ``TRAIN_ARCH``'s published widths (21.): returns
    K1's launches on its main path (the fault-tolerant run's gradient
    compression)."""
    import shutil
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.core.encoder import init_state
    from repro_torch.kernels import encode_step as k1
    from repro_torch.launch import train as launcher
    from repro_torch.models.layers import full_float32
    from repro_torch.optim import gradcomp
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.tree import tree_leaves, tree_map
    full = get_config(TRAIN_ARCH)
    n_params = full.param_count()
    check(n_params == TRAIN_PARAMS, f"{TRAIN_ARCH} parameters {n_params}")

    # (a) full depth, plain trainer steps on float32 masters
    t_start = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(full, torch.Generator(device=dev).manual_seed(0),
                             dev)
    state_gb = (tree_bytes(state.params) + tree_bytes(state.opt)) / 1e9
    step = make_train_step(full, lr=TRAIN_LR, microbatches=TRAIN_MICRO)
    batches = launcher.build_batches(full, TRAIN_STEPS + 1, TRAIN_BATCH,
                                     TRAIN_SEQ)
    steps = []
    for b in batches[:TRAIN_STEPS]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, b)
        loss, gn = float(m["loss"]), float(m["grad_norm"])
        torch.cuda.synchronize()
        steps.append({"loss": loss, "grad_norm": gn,
                      "ms": (time.perf_counter() - t0) * 1e3})
        check(np.isfinite(loss) and np.isfinite(gn),
              f"[train] full depth: finite loss {loss}, grad_norm {gn}")
    prof = device_profile(torch, lambda: step(state, batches[-1]), cpu=False)
    peak = torch.cuda.max_memory_allocated()
    del state, step, m
    torch.cuda.empty_cache()
    t_full = time.perf_counter()

    # (b) the SMOKE config's first step on the card and on the CPU
    cfg = get_config(TRAIN_ARCH, smoke=True).replace(dtype=torch.float32)
    host = init_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    step = make_train_step(cfg, lr=TRAIN_LR, microbatches=TRAIN_MICRO)
    b = launcher.build_batches(cfg, 1, TRAIN_BATCH, TRAIN_SEQ)[0]
    with full_float32():
        on_card, m_card = step(tree_map(lambda t: t.to(dev), host), b)
    on_host, m_host = step(host, b)

    def rel(key):
        return abs(float(m_card[key]) - float(m_host[key])) \
            / abs(float(m_host[key]))

    def leaf_rel(card_tree, host_tree):
        """Each leaf's largest difference relative to its largest
        magnitude, the largest over the leaves."""
        return max(
            float((a.cpu() - b).abs().max()) / max(float(b.abs().max()),
                                                   1e-30)
            for a, b in zip(tree_leaves(card_tree), tree_leaves(host_tree)))

    loss_rel, gnorm_rel = rel("loss"), rel("grad_norm")
    # after one step mu = (1 - b1) * the clipped gradient, leaf by leaf: it
    # holds the backward to its values; the parameters move by about
    # lr * sign(gradient) and hold it only to its signs
    grad_rel = leaf_rel(on_card.opt.mu, on_host.opt.mu)
    param_rel = leaf_rel(on_card.params, on_host.params)
    check(max(loss_rel, gnorm_rel, grad_rel, param_rel) <= TRAIN_REL_TOL,
          f"[train] card vs CPU step: loss {loss_rel}, grad_norm "
          f"{gnorm_rel}, gradients (mu) {grad_rel}, parameters {param_rel} "
          f"within {TRAIN_REL_TOL} (relative)")
    del on_card, on_host, host
    t_parity = time.perf_counter()

    # (c) the launcher's fault-tolerant run with --gradcomp, depth cut
    cut = full.replace(num_layers=TRAIN_FT_LAYERS)
    reckoned = 16 * cut.param_count()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    compress = {"seconds": [], "metrics": []}
    real_compress, real_config = gradcomp._compress_flat, launcher.get_config

    def timed(flat, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_compress(flat, **kw)
        torch.cuda.synchronize()
        compress["seconds"].append(time.perf_counter() - t0)
        compress["metrics"].append({k: float(v) for k, v in out[1].items()})
        if "flat" not in compress:  # the first compress's prefix
            nb = TRAIN_PREFIX_BLOCKS
            compress.update(flat=flat[:nb * kw["block"]].clone(), kw=kw,
                            blocks=flat.numel() // kw["block"],
                            decisions=tuple(d[:nb].clone() for d in out[2]))
        return out

    gradcomp._compress_flat = timed
    launcher.get_config = lambda arch, smoke=False: cut
    try:
        k1.launches = 0
        trainer = launcher.main([
            "--arch", TRAIN_ARCH, "--steps", str(TRAIN_FT_STEPS),
            "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
            "--microbatches", str(TRAIN_MICRO), "--lr", str(TRAIN_LR),
            "--ckpt-every", str(TRAIN_FT_EVERY), "--gradcomp",
            "--inject-crash", str(TRAIN_FT_CRASH), "--ckpt-dir", tmp,
            "--device", str(dev)])
        launches = k1.launches
        ckpt_dir = Path(tmp) / f"step_{TRAIN_FT_EVERY:08d}"
        on_disk = sum(f.stat().st_size for f in ckpt_dir.iterdir())
    finally:
        gradcomp._compress_flat, launcher.get_config = (real_compress,
                                                         real_config)
        shutil.rmtree(tmp, ignore_errors=True)
    losses = [e for e in trainer.log if "loss" in e]
    events = [e for e in trainer.log if "event" in e]
    check(events == [{"step": TRAIN_FT_CRASH, "event": "restore",
                      "resumed_from": TRAIN_FT_EVERY,
                      "cause": f"node failure at step {TRAIN_FT_CRASH}"}],
          f"[train] fault-tolerant run: restore from step "
          f"{TRAIN_FT_EVERY} ({events})")
    check(losses[-1]["step"] == TRAIN_FT_STEPS - 1
          and int(trainer.state.opt.step) == TRAIN_FT_STEPS
          and all(np.isfinite(e["loss"]) for e in losses),
          f"[train] fault-tolerant run ends at step {TRAIN_FT_STEPS} with "
          f"finite losses")
    check(launches == len(losses) == len(compress["seconds"]),
          f"[train] K1 launches {launches} == train steps run "
          f"{len(losses)} (one compress each)")
    # K1's first decisions against the plain scan on the card
    flat, kw = compress["flat"], compress["kw"]
    xs = torch.sort(flat.reshape(1, TRAIN_PREFIX_BLOCKS, kw["block"]),
                    dim=-1).values
    (ph, ps, _), _ = k1.encode_scan_torch(
        xs, torch.ones((1, TRAIN_PREFIX_BLOCKS), dtype=torch.bool,
                       device=dev),
        init_state(kw["num_dict"], kw["block"], channels=1, device=dev),
        d_crit=kw["d_crit"], rel_tol=kw["rel_tol"])
    h, sl = compress["decisions"]
    check(torch.equal(h, ph[0]) and torch.equal(sl, ps[0]),
          f"[train] K1 == plain scan on the first {TRAIN_PREFIX_BLOCKS} "
          f"blocks of the flattened gradient")
    del trainer
    torch.cuda.empty_cache()
    res = {
        "arch": TRAIN_ARCH, "params": n_params,
        "full_depth": {"layers": full.num_layers, "batch": TRAIN_BATCH,
                       "seq": TRAIN_SEQ, "microbatches": TRAIN_MICRO,
                       "lr": TRAIN_LR, "state_GB": state_gb,
                       "peak_GB": peak / 1e9, "steps": steps,
                       "device_ops_per_step": prof["device_events"],
                       "profiled_step_wall_s": prof["wall_s"],
                       "busy_share": prof["busy_share"]},
        "card_vs_cpu": {"config": "SMOKE float32, TF32 off",
                        "loss_rel_err": loss_rel,
                        "grad_norm_rel_err": gnorm_rel,
                        "grad_rel_err": grad_rel,
                        "param_rel_err": param_rel,
                        "tolerance": TRAIN_REL_TOL},
        "fault_tolerant": {
            "layers": TRAIN_FT_LAYERS, "steps": TRAIN_FT_STEPS,
            "ckpt_every": TRAIN_FT_EVERY, "crash_at": TRAIN_FT_CRASH,
            "losses": [e["loss"] for e in losses], "events": events,
            "ckpt_bytes_reckoned": reckoned, "ckpt_bytes_on_disk": on_disk,
            "k1_launches": launches,
            "gradcomp": {"blocks": compress["blocks"],
                         "hit_rate": [m["hit_rate"]
                                      for m in compress["metrics"]],
                         "wire_ratio": [m["wire_ratio"]
                                        for m in compress["metrics"]],
                         "seconds": compress["seconds"]},
            "k1_prefix_blocks": TRAIN_PREFIX_BLOCKS},
        "phase_s": {"full_depth": t_full - t_start,
                    "card_vs_cpu": t_parity - t_full,
                    "fault_tolerant": time.perf_counter() - t_parity},
    }
    say(f"[train] {json.dumps(res)} [{card}]")
    say(f"[profile] train step {TRAIN_ARCH} full depth (B={TRAIN_BATCH}, "
        f"S={TRAIN_SEQ}): {json.dumps(prof)} [{card}]")
    return launches


def time_k4(torch, dev, B, C, Hkv=8, G=4, hd=128):
    """K4 at a serve shape with every cache position valid (a full ring),
    against its bound, its plain version and one PyTorch call
    (``scaled_dot_product_attention``, timed only)."""
    from repro_torch.kernels import flash_decode as k4
    from repro_torch.models.attention import ring_valid
    import torch.nn.functional as F
    rng = np.random.default_rng(C)
    H = Hkv * G
    q = torch.from_numpy(rng.normal(size=(B, H, hd)) * hd ** -0.5).to(
        dev, torch.float32)
    k = torch.randn((B, C, Hkv, hd), device=dev, dtype=torch.bfloat16)
    v = torch.randn((B, C, Hkv, hd), device=dev, dtype=torch.bfloat16)
    valid = ring_valid(C + 7, C, None, dev).expand(B, C)
    check(bool(valid.all()), "K4 timing: every position valid")
    args = (q, k, v, valid)
    ms = cuda_ms(lambda: k4.flash_decode(*args), reps=20, queued=True)
    got = k4.flash_decode(*args)
    plain_ms = cuda_ms(lambda: k4.flash_decode_torch(*args), reps=5)
    err = float((got - k4.flash_decode_torch(*args)).abs().max())
    # the library call on the same values: (B, H, 1, hd) queries against
    # (B, Hkv, C, hd) views of the cache, the mask broadcast over heads
    qb = q.to(torch.bfloat16)[:, :, None, :]
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    mask = valid[:, None, None, :]
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qb, kt, vt, attn_mask=mask, scale=1.0, enable_gqa=True), reps=20,
        queued=True)
    nbytes = (2 * k.numel() * k.element_size() + q.numel() * 4
              + valid.numel() + B * H * hd * 4)
    ops = 4 * B * H * C * hd  # q.k and p.v, an FMA counted as two
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / PEAK_OPS["f32"] * 1e3
    return {
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "max_abs_err": err, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "splits": k4._splits(q.device, k.dtype, B, C, Hkv, G, hd),
        "shape": {"B": B, "C": C, "Hkv": Hkv, "G": G, "hd": hd,
                  "cache": "bfloat16"},
        "bytes": nbytes, "ops": ops,
    }


def phase_dryrun(torch, dev, card):
    """The dry run (22.): (a) its cells in subprocesses, (b) its cost
    counter on a meta trace against the same step on the card.  Returns
    K4's launches on the card's decode step."""
    import tempfile
    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="dryrun-") as tmp:
        launches = _dryrun_in(torch, dev, card, Path(tmp), t_start)
    say(f"[dryrun] phase {time.perf_counter() - t_start:.1f} s")
    return launches


def _dryrun_in(torch, dev, card, tmp, t_start):
    """:func:`phase_dryrun` with its records and logs under ``tmp``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_decode as k4
    from repro_torch.launch import train as launcher
    from repro_torch.launch.hlo_cost import CostCounter
    from repro_torch.models import lm
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.tree import tree_leaves

    def tensors(tree):
        return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]

    # (a) every cell in its own process, all at once; no card
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    runs = []
    try:
        for smoke, cells in ((True, DRYRUN_SMOKE), (False, DRYRUN_FULL)):
            for arch, shape, mesh in cells:
                out = tmp / "records"
                log = tmp / f"{len(runs)}.log"
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape, "--mesh", mesh,
                       "--out", str(out)] + (["--smoke"] if smoke else [])
                with open(log, "w") as f:
                    runs.append((arch, shape, mesh, smoke, out, log,
                                 subprocess.Popen(cmd, env=env, cwd=ROOT,
                                                  stdout=f,
                                                  stderr=subprocess.STDOUT)))

        # (b) the counter on a meta trace and on the card: the decode
        cfg = get_config(SERVE_ARCH)
        B, C = SERVE_BATCH, SERVE_MAX_SEQ
        params = lm.init_params(cfg, device="meta")
        cache = lm.init_cache(cfg, B, C, device="meta")
        arg_bytes = sum(t.numel() * t.element_size()
                        for t in tensors((params, cache)))
        n_args = len(tensors((params, cache)))
        tokens = torch.zeros((B, 1), dtype=torch.int64, device="meta")
        t0 = time.perf_counter()
        with CostCounter("meta") as meta:
            lm.decode_step(params, cache, tokens, cfg, backend="cuda")
        meta_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        m0 = torch.cuda.memory_allocated()
        params = lm.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), dev)
        cache = lm.init_cache(cfg, B, C, device=dev)
        torch.cuda.synchronize()
        grown = torch.cuda.memory_allocated() - m0
        check(0 <= grown - arg_bytes <= ALLOC_ROUND * n_args,
              f"[dryrun] decode arguments: {arg_bytes} B reckoned on meta, "
              f"the card's allocation grew {grown} B ({n_args} tensors)")
        tokens = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (B, 1))).to(dev)
        k4.launches = 0
        with CostCounter("cuda") as real:
            logits, cache = lm.decode_step(params, cache, tokens, cfg,
                                           backend="cuda")
            torch.cuda.synchronize()
        launches = k4.launches
        n_attn = sum(k in lm.SELF_ATTN_KINDS for k in lm.layer_kinds(cfg))
        check(launches == n_attn == 40,
              f"[dryrun] K4 launches {launches} on the decode step")
        check(bool(torch.isfinite(logits).all()), "[dryrun] decode logits")
        check(real.flops == meta.flops and real.bytes == meta.bytes,
              f"[dryrun] decode: card {real.flops} FLOPs {real.bytes} B, "
              f"meta {meta.flops} FLOPs {meta.bytes} B")
        say(f"[dryrun] {cfg.name} decode B={B} C={C} bf16: FLOPs "
            f"{real.flops:.0f} (meta {meta.flops:.0f}), bytes "
            f"{real.bytes:.0f} (meta {meta.bytes:.0f}); arguments "
            f"{arg_bytes} B reckoned, the card's allocation grew {grown} "
            f"B; K4 {launches} launches; meta trace {meta_s:.3f} s; {card}")
        del params, cache, logits
        torch.cuda.empty_cache()

        # the train step: granite-moe at published widths, 2 layers
        tcfg = get_config(TRAIN_ARCH).replace(num_layers=DRYRUN_TRAIN_LAYERS)
        step = make_train_step(tcfg, lr=TRAIN_LR, microbatches=TRAIN_MICRO)
        shape = (TRAIN_BATCH, TRAIN_SEQ)
        mbatch = {k: torch.zeros(shape, dtype=torch.int64, device="meta")
                  for k in ("tokens", "labels")}
        mstate = init_train_state(tcfg, device="meta")
        with CostCounter("meta") as meta:
            step(mstate, mbatch)
        state = init_train_state(
            tcfg, torch.Generator(device=dev).manual_seed(0), dev)
        batch = {k: torch.as_tensor(v).long().to(dev) for k, v in
                 launcher.build_batches(tcfg, 1, *shape)[0].items()}
        torch.cuda.synchronize()
        with CostCounter("cuda") as real:
            state, m = step(state, batch)
            loss = float(m["loss"])
        check(np.isfinite(loss), f"[dryrun] train loss {loss}")
        check(real.flops == meta.flops and real.bytes == meta.bytes,
              f"[dryrun] train: card {real.flops} FLOPs {real.bytes} B, "
              f"meta {meta.flops} FLOPs {meta.bytes} B")
        say(f"[dryrun] {TRAIN_ARCH} train step {DRYRUN_TRAIN_LAYERS} of "
            f"{get_config(TRAIN_ARCH).num_layers} layers, {shape[0]} x "
            f"{shape[1]}, {TRAIN_MICRO} microbatches: FLOPs "
            f"{real.flops:.0f} (meta {meta.flops:.0f}), bytes "
            f"{real.bytes:.0f} (meta {meta.bytes:.0f}); loss {loss}; {card}")
        del state, m, batch
        torch.cuda.empty_cache()

        # (a) the cells' records
        for arch, shape, mesh, smoke, out, log, proc in runs:
            left = DRYRUN_TIMEOUT - (time.perf_counter() - t_start)
            rc = proc.wait(timeout=max(left, 1))
            text = log.read_text()
            check(rc == 0, f"[dryrun] {arch} {shape} {mesh}: exit {rc}: "
                  f"{text[-2000:]}")
            tag = f"{arch.replace('-', '_').replace('.', '_')}_{shape}_{mesh}"
            rec = json.loads((out / f"{tag}.json").read_text())
            chips = 512 if mesh == "multi" else 256
            check(rec["status"] == "ok" and rec["flops_per_chip"] > 0
                  and rec["bytes_per_chip"] > 0 and rec["chips"] == chips,
                  f"[dryrun] {tag}: {rec}")
            wire = ", ".join(
                f"{k} {d['count']} x {d['wire_bytes']:.0f} B"
                for k, d in sorted(rec["collectives"].items()))
            say(f"[dryrun] {tag} {'SMOKE' if smoke else 'FULL'} on "
                f"{rec['mesh']}: FLOPs/chip {rec['flops_per_chip']:.0f}, "
                f"bytes/chip {rec['bytes_per_chip']:.0f}, wire/chip "
                f"{rec['collective_wire_bytes_per_chip']:.0f} B ({wire}); "
                f"arguments {rec['memory_analysis']['argument_size_in_bytes']}"
                f" B; replication {rec['replication']}; trace "
                f"{rec['trace_s']:.2f} s")

        # (c) the records counted again from their op logs
        out = tmp / "records"
        before = {p.name: json.loads(p.read_text())
                  for p in out.glob("*.json")}
        ra = subprocess.run([sys.executable, "-m",
                             "repro_torch.launch.reanalyze", str(out)],
                            env=env, cwd=ROOT, capture_output=True,
                            text=True, timeout=DRYRUN_TIMEOUT)
        check(ra.returncode == 0, f"[dryrun] reanalyze: {ra.stderr[-2000:]}")
        check(len(before) == len(runs)
              and ra.stdout.count("reanalyzed") == len(runs),
              f"[dryrun] reanalyze: {len(before)} records, {ra.stdout}")
        for name, rec in before.items():
            again = json.loads((out / name).read_text())
            differ = {k: (v, again.get(k)) for k, v in rec.items()
                      if again.get(k) != v}
            check(not differ, f"[dryrun] reanalyze {name}: {differ}")
        say(f"[dryrun] reanalyze: {len(before)} records counted again from "
            f"their op logs, every field equal")
    finally:
        for run in runs:
            if run[-1].poll() is None:
                run[-1].kill()
                run[-1].wait()
    return launches


def phase_examples(card):
    """The user entry points (23.), each in its own process on the card,
    all at once: every one exits 0 with its verdict in its output and
    launches the kernels it must.  Returns their launches by kernel."""
    t_start = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = []
    try:
        for name, argv, _, _ in EXAMPLES:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", EXAMPLE_RUNNER] + argv, env=env,
                cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        total = {"encode_step": 0, "seq_cumsum": 0, "dict_match": 0,
                 "flash_decode": 0}
        for (name, _, needs, verdict), proc in zip(EXAMPLES, procs):
            left = EXAMPLES_TIMEOUT - (time.perf_counter() - t_start)
            out, _ = proc.communicate(timeout=max(left, 1))
            # a printed check that failed (wire bytes, round trip) reads
            # ": False"
            check(proc.returncode == 0 and verdict in out
                  and ": False" not in out,
                  f"[examples] {name}: exit {proc.returncode}, "
                  f"{verdict!r} {'in' if verdict in out else 'not in'} its "
                  f"output: {out[-3000:]}")
            line = [ln for ln in out.splitlines()
                    if ln.startswith("LAUNCHES ")][-1]
            counts = json.loads(line[len("LAUNCHES "):])
            for k in needs:
                check(counts[k] > 0, f"[examples] {name}: {k} not launched")
            for k, n in counts.items():
                total[k] += n
            lines = [ln for ln in out.splitlines()
                     if not ln.startswith("LAUNCHES ")]
            say(f"[examples] {name}: {lines[-1].strip()}; launches "
                f"{json.dumps(counts)}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    say(f"[examples] phase {time.perf_counter() - t_start:.1f} s, launches "
        f"{json.dumps(total)}; {card}")
    return total


def phase_timing(torch, dev, card, first_chunks, k2_reads):
    """Each kernel at its main-path shapes (22.): returns the timings that
    the kernels JSON line reports, by kernel.  ``k2_reads`` holds K2's
    operands on the store's ANG_delta reads."""
    from repro_torch.core.decode import _pow2
    k1_main = time_k1(torch, dev, *first_chunks["MAG"])
    k1_mixed = time_k1_mixed(torch, dev, *first_chunks["adaptive"])
    k1_ang = time_k1(torch, dev, *first_chunks["ANG_delta"])
    ang_codec = first_chunks["ANG_delta"][0]
    k1_ang_eb = time_k1(torch, dev, *first_chunks["ANG_delta"],
                        error_bound=BOUNDS["ANG_delta"]["error_bound_rel"]
                        * (ang_codec.value_range[1]
                           - ang_codec.value_range[0]))
    mag_codec, mag_pay = first_chunks["MAG"]
    k1_turn = time_k1(torch, dev, mag_codec,
                      turnover(*mag_pay.shape, seed=5))
    nb_ang = SAMPLES // CONFIGS["ANG_delta"]["block_size"]
    P_ang = CONFIGS["ANG_delta"]["block_size"] - 1
    k2_main = time_k2(torch, dev, _pow2(nb_ang), P_ang)
    k2_f32 = time_k2(torch, dev, _pow2(nb_ang), P_ang, np.float32)
    k2_f16 = time_k2(torch, dev, _pow2(nb_ang), P_ang, np.float16)
    k2_range = time_k2(torch, dev, 0, 0, xt=k2_reads["decode_ranges"])
    k2_channels = time_k2(torch, dev, 0, 0, xt=k2_reads["decode_channels"])
    D = mag_codec.num_dict
    n_mag, n_ang = mag_pay.shape[-1], ang_codec.block_size - 1
    # the ops path passes the dictionary's rows, which are sorted
    k3_mag = time_k3(torch, dev, CHANNELS, D, n_mag, sorted_rows=True)
    k3_mag_rnd = time_k3(torch, dev, CHANNELS, D, n_mag)
    k3_ang = time_k3(torch, dev, CHANNELS, D, n_ang, sorted_rows=True)
    k3_ang_rnd = time_k3(torch, dev, CHANNELS, D, n_ang)
    k3_floor = time_k3(torch, dev, 1, 1, 32, sorted_rows=True)
    k4_serve = time_k4(torch, dev, SERVE_BATCH, SERVE_MAX_SEQ)
    k4_32k = time_k4(torch, dev, SERVE_BATCH, 32768)
    for name, t in (("K1 MAG", k1_main), ("K1 mixed", k1_mixed),
                    ("K1 ANG", k1_ang),
                    ("K1 ANG_delta error bound", k1_ang_eb),
                    ("K1 turnover", k1_turn), ("K2 ANG_delta f64", k2_main),
                    ("K2 ANG_delta shape f32", k2_f32),
                    ("K2 ANG_delta shape f16", k2_f16),
                    (f"K2 store read, {STORE_BATCH} requests", k2_range),
                    ("K2 store read, decode_channels", k2_channels),
                    ("K3 MAG step, sorted rows", k3_mag),
                    ("K3 MAG step, random rows", k3_mag_rnd),
                    ("K3 ANG step, sorted rows", k3_ang),
                    ("K3 ANG step, random rows", k3_ang_rnd),
                    ("K3 launch floor (C=1, D=1, n=32)", k3_floor),
                    ("K4 serve", k4_serve), ("K4 decode_32k", k4_32k)):
        say(f"[timing] {name} {json.dumps(t)} [{card}]")
        tol = K4_TOL if name.startswith("K4") else 0.0
        check(t["max_abs_err"] <= tol,
              f"{name}: kernel == plain version at the timed shape "
              f"(max_abs_err {t['max_abs_err']}, tolerance {tol})")
    for t in (k2_main, k2_f32, k2_f16, k2_range, k2_channels):
        check(t["bitwise_plain_and_np_cumsum"],
              f"K2 {t['shape']}: bitwise == plain version and np.cumsum")
    check(k1_turn["overwrites"] > 0,
          f"turnover traffic turns the dictionary over "
          f"({k1_turn['overwrites']} overwrites)")
    return {"encode_step": k1_main, "seq_cumsum": k2_main,
            "dict_match": k3_mag, "flash_decode": k4_serve}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "tests"))
    import repro_torch  # noqa: F401  (fails outside a checkout)

    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    say(f"[device] {kind} x{torch.cuda.device_count()}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}; {card}")

    phase_build()
    phase_k1(torch, dev)
    phase_k2(torch, dev)
    phase_k3(torch, dev)
    phase_golden(dev)
    launches, first_chunks, main_streams = phase_main(torch, dev, card)
    mag = unbounded(torch, dev, "MAG")
    launches["dict_match"] = phase_ops(torch, dev, card, mag[0])
    n1, n2 = phase_bound(torch, dev, card, {"MAG": mag})
    del mag
    launches["encode_step"] += int(n1)
    launches["seq_cumsum"] += int(n2)
    (n1, n2), k2_reads, archives = phase_store(torch, dev, card)
    launches["encode_step"] += n1
    launches["seq_cumsum"] += n2
    phase_auto(torch, dev, card, first_chunks)
    n1, first_chunks["adaptive"], adaptive_streams = phase_adaptive(
        torch, dev, card)
    launches["encode_step"] += n1
    launches["encode_step"] += phase_coalesce(torch, dev, card)
    launches["encode_step"] += phase_coalesce_adaptive(torch, dev, card)
    for name, n in phase_shard(torch, dev, card, main_streams,
                               adaptive_streams).items():
        launches[name] += n
    del main_streams, adaptive_streams
    launches["seq_cumsum"] += phase_service(torch, dev, card, archives)
    del archives
    for name, n in phase_frontend(torch, dev, card).items():
        launches[name] += n
    phase_k4(torch, dev)
    launches["flash_decode"] = phase_serve(torch, dev, card)
    launches["flash_decode"] += phase_families(torch, dev, card)
    launches["encode_step"] += phase_train(torch, dev, card)
    launches["flash_decode"] += phase_dryrun(torch, dev, card)
    for name, n in phase_examples(card).items():
        launches[name] += n
    timed = phase_timing(torch, dev, card, first_chunks, k2_reads)

    def entry(name, source, replaces):
        t = timed[name]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"]}

    kernels = {"kernels": [
        entry("encode_step", "src/repro_torch/csrc/encode_step.cu",
              "src/repro/kernels/encode_step.py:306"),
        entry("seq_cumsum", "src/repro_torch/csrc/seq_cumsum.cu",
              "src/repro/kernels/seq_cumsum.py:58"),
        entry("dict_match", "src/repro_torch/csrc/dict_match.cu",
              "src/repro/kernels/dict_match.py:100"),
        entry("flash_decode", "src/repro_torch/csrc/flash_decode.cu",
              "src/repro/kernels/flash_decode.py:76"),
    ]}
    say(f"[done] {time.perf_counter() - T_START:.1f} s")
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
