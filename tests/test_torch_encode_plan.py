"""Encode plans and the shard check of the PyTorch port, on the CPU.

``make_encode_plan`` applies the reference package's rules (channel
groups, padding, block quantum, errors) to a list of ``torch.device``s in
which a device may repeat; the port's ``shard_check.run_check`` is the
reference's byte-identity self-check on 2 and 4 CPU shards.  Tolerance:
none (shapes, summaries and bytes equal).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import shard_check as jax_shard_check  # noqa: E402
from repro.launch.encode_plan import make_encode_plan as jax_make_plan  # noqa: E402
from repro_torch.core import encoder as tenc  # noqa: E402
from repro_torch.launch import shard_check  # noqa: E402
from repro_torch.launch.encode_plan import (make_encode_plan,  # noqa: E402
                                            pad_channels, shard_state)

CPU = torch.device("cpu")


def test_encode_plan_shapes():
    plan = make_encode_plan(5, block_size=32, devices=["cpu"] * 2)
    assert plan.channels == 5
    assert plan.padded_channels % plan.num_devices == 0
    assert plan.shard_channels * plan.num_devices == plan.padded_channels
    assert plan.block_quantum >= 1
    padded = pad_channels(plan, np.ones((5, 4)))
    assert padded.shape == (plan.padded_channels, 4)
    assert not padded[5:].any()
    with pytest.raises(ValueError):
        make_encode_plan(0, devices=["cpu"])


@pytest.mark.parametrize("channels,devices,dict_shards,want", [
    # (padded, shard_channels, grid shape)
    (5, 1, 1, (5, 5, (1, 1))),
    (5, 2, 1, (6, 3, (2, 1))),
    (5, 4, 1, (8, 2, (4, 1))),
    (3, 8, 1, (3, 1, (3, 1))),       # never more groups than channels
    (64, 4, 1, (64, 16, (4, 1))),
    (5, 4, 2, (6, 3, (2, 2))),
    (1, 4, 4, (1, 1, (1, 4))),
    (2, 5, 2, (2, 1, (2, 2))),       # a fifth device is left out
    (64, 4, 4, (64, 64, (1, 4))),
])
def test_plan_rules_are_the_reference(channels, devices, dict_shards, want):
    """The reference's rules on a device list with repeats: groups =
    min(devices // dict_shards, channels), channels padded to a multiple,
    the reference's block quantum."""
    plan = make_encode_plan(channels, block_size=32, devices=[CPU] * devices,
                            dict_shards=dict_shards)
    assert (plan.padded_channels, plan.shard_channels,
            (len(plan.grid), len(plan.grid[0]))) == want
    assert all(d == CPU for row in plan.grid for d in row)
    assert plan.num_devices == len(plan.grid) == len(plan.devices)
    quantum = max(1, (1 << 20) // (plan.shard_channels * 32 * 4))
    assert plan.block_quantum == quantum
    assert plan.summary()["dict_shards"] == dict_shards


def test_single_device_plan_equals_the_reference_plan():
    """The reference's plan at its default float32 itemsize (the port's
    device scans decide in float32, so its quantum counts 4 bytes)."""
    for channels in (1, 5, 64):
        for bs in (32, 112):
            want = jax_make_plan(channels, block_size=bs, itemsize=4)
            got = make_encode_plan(channels, block_size=bs, devices=["cpu"])
            assert got.summary() == want.summary()


def test_plan_errors_and_placement_helpers():
    with pytest.raises(ValueError, match="dict_shards must be >= 1"):
        make_encode_plan(2, devices=["cpu"], dict_shards=0)
    with pytest.raises(ValueError, match="needs at least that many"):
        make_encode_plan(2, devices=["cpu"] * 2, dict_shards=4)
    plan = make_encode_plan(5, devices=["cpu"] * 4, dict_shards=2)
    assert [plan.channel_slice(g) for g in range(2)] == [slice(0, 3),
                                                         slice(3, 6)]
    # D=255 over 2 shards: 128 rows each, the last one a pad row
    assert [plan.dict_rows(255, s) for s in range(2)] == [slice(0, 128),
                                                          slice(128, 256)]
    assert plan.device(1, 1) == CPU
    with pytest.raises(ValueError, match="dict_shards=1"):
        plan.validate_adaptive()
    chan = make_encode_plan(5, devices=["cpu"] * 4)
    assert chan.validate_adaptive() is chan


def test_default_devices_are_the_cards():
    if torch.cuda.is_available():
        plan = make_encode_plan(8)
        assert plan.num_devices == min(8, torch.cuda.device_count())
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        make_encode_plan(8)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_encode_plan(8, devices=["cuda:0"])


@pytest.mark.parametrize("dict_shards", [1, 2])
def test_shard_state_splits_and_joins_the_carry(dict_shards):
    """``shard_state`` places a padded carry on the grid (the dictionary
    rows padded with invalid rows when split); ``join_state`` gives it
    back; error-bound rows pass through, empty or not."""
    plan = make_encode_plan(3, devices=["cpu"] * 4, dict_shards=dict_shards)
    rng = np.random.default_rng(0)
    for raw in (False, True):
        st = tenc.init_state(5, 4, channels=plan.padded_channels,
                             device="cpu", raw=raw)
        st = tenc.DictState(
            sorted_blocks=torch.as_tensor(rng.normal(
                size=st.sorted_blocks.shape), dtype=torch.float32),
            dmin=torch.randn(st.dmin.shape), dmax=torch.randn(st.dmax.shape),
            valid=torch.as_tensor(rng.random(st.valid.shape) > 0.5),
            count=torch.arange(plan.padded_channels, dtype=torch.int32),
            raw_blocks=torch.randn(st.raw_blocks.shape))
        sh = shard_state(plan, st)
        rows = -(-5 // dict_shards)
        assert [s.sorted_blocks.shape[1] for s in sh.grid[0]] == \
            [rows] * dict_shards
        assert sh.grid[0][-1].raw_blocks.shape[1] == (rows if raw else 0)
        if dict_shards == 2:
            assert not sh.grid[0][-1].valid[:, -1].any()  # the pad row
        back = tenc.join_state(sh)
        for a, b in zip(st, back):
            assert torch.equal(a, b)
        # the split is a copy: writing a shard leaves the source alone
        sh.grid[0][0].valid.fill_(True)
        assert torch.equal(st.valid, back.valid)
    with pytest.raises(ValueError, match="plan expects"):
        shard_state(plan, tenc.init_state(5, 4, channels=7, device="cpu"))


def test_shard_devices_places_round_robin():
    assert shard_check.shard_devices(3, "cpu") == [CPU] * 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            shard_check.shard_devices(2)
    assert shard_check.CASES == jax_shard_check.CASES


@pytest.mark.parametrize("devices", [2, 4])
def test_shard_check_on_cpu_shards(devices):
    """The reference's self-check, case for case, on CPU shards with the
    plain tensor scan: sharded and D-sharded sessions == the session
    without a plan, coalesced ragged streams == one-shot encodes."""
    rec = shard_check.run_check(
        backend="torch", devices=shard_check.shard_devices(devices, "cpu"))
    assert rec["status"] == "ok", rec
    assert rec["devices"] == devices
    assert len(rec["cases"]) == 6  # every mode x D regime
