"""Encode plans: how a batched (C, nb, n) encode spreads over devices.

The batched encoder treats channels as independent; this module decides
how a scale-out encode maps them onto devices:

  * a grid of devices, (channel groups, dictionary shards): never more
    channel groups than channels (a group with no channel is wasted);
    with ``dict_shards > 1`` each group's dictionary rows are split over
    that many devices as well;
  * channel padding: C rounded up to a multiple of the channel groups,
    the pad channels masked out of the scan with the encoder's block
    validity mask;
  * block quantum: the suggested per-feed block count that keeps every
    shard's scan long enough to amortize its dispatch (counted in float32,
    the payload type the device scans decide in).

One process drives every shard (the reference package's plans are
single-controller too: one ``shard_map`` over its local devices).  A device
may be listed more than once: ``["cpu"] * 4`` puts four shards on the host
and ``["cuda:0"] * 4`` four shards on one card.  That is this package's
counterpart of the reference's forced host device count
(``--xla_force_host_platform_device_count``).

Plans are plain data: the codec core takes the plan's device grid and
padded tensors, so ``repro_torch.core`` imports nothing from here.  The
grid's shape says which split is which, so a plan names no axes (the
reference's ``axis_name``/``dict_axis`` name the axes of its ``Mesh``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.encoder import split_state, state_partition
from ..device import resolve_device

__all__ = ["EncodePlan", "make_encode_plan", "shard_state", "pad_channels"]

# Per-shard bytes of block payload a single feed step should carry before
# dispatch overhead stops dominating (the reference package's figure), and
# the bytes of a payload value: the device scans decide in float32.
_QUANTUM_BYTES = 1 << 20
_ITEMSIZE = 4


class EncodePlan(NamedTuple):
    """Placement of one batched encode configuration.

    ``grid[g][s]`` is the device of channel group ``g``'s dictionary shard
    ``s``.  ``dict_shards > 1`` selects dictionary (D-axis) sharding:
    within each channel group the dictionary rows are split over
    ``dict_shards`` devices and each block step's best match is reduced
    across them, so one fat channel can use several devices.  The default
    keeps one shard a group (channel sharding only).
    """

    grid: Tuple[Tuple[torch.device, ...], ...]
    channels: int          # logical channel count C
    padded_channels: int   # C rounded up to a multiple of the groups
    shard_channels: int    # channels a group holds
    block_quantum: int     # suggested blocks per channel per feed step
    dict_shards: int = 1   # devices sharing each channel's dictionary rows

    @property
    def num_devices(self) -> int:
        """Channel groups (the reference's mesh size on its channel
        axis)."""
        return len(self.grid)

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        """Each channel group's first device: the channel-sharded scans'
        devices."""
        return tuple(row[0] for row in self.grid)

    def device(self, group: int, shard: int = 0) -> torch.device:
        return self.grid[group][shard]

    def channel_slice(self, group: int) -> slice:
        """The padded channels channel group ``group`` holds."""
        return state_partition(self.grid, self.padded_channels,
                               1).channel_slice(group)

    def dict_rows(self, num_dict: int, shard: int) -> slice:
        """The rows of the dictionary, padded to a multiple of the grid's
        dictionary shards, that shard ``shard`` holds (rows at
        ``num_dict`` and past it are pad rows)."""
        return state_partition(self.grid, self.padded_channels,
                               num_dict).row_slice(shard)

    def validate_adaptive(self) -> "EncodePlan":
        """Check the plan can drive adaptive (mixed-mode) sessions.

        The batched mixed scan shards the channel axis only: a lane's
        dictionary rows stay on one device for the in-place resets a
        selector switch performs.  Returns ``self``."""
        if self.dict_shards > 1:
            raise ValueError(
                "adaptive sessions shard channels only; build the plan "
                "with dict_shards=1")
        return self

    def summary(self) -> dict:
        return {
            "devices": self.num_devices,
            "channels": self.channels,
            "padded_channels": self.padded_channels,
            "shard_channels": self.shard_channels,
            "block_quantum": self.block_quantum,
            "dict_shards": self.dict_shards,
        }


def _visible_devices():
    """Every CUDA card; raises as ``resolve_device`` does without one."""
    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_encode_plan(
    channels: int,
    *,
    block_size: int = 32,
    devices: Optional[Sequence] = None,
    dict_shards: int = 1,
) -> EncodePlan:
    """Pick the device grid, channel padding and per-shard batch quantum.

    ``devices`` defaults to every visible CUDA card (raising when there is
    none); pass a list to pin the encode to given devices, a device listed
    as often as it should hold shards.

    ``dict_shards > 1`` asks for D-axis sharding: the device list is
    reshaped into a (channel groups, dict_shards) grid, so a plan can
    choose channel sharding (the default), D-sharding (``channels=1``),
    or both.
    """
    if channels < 1:
        raise ValueError("channels must be >= 1")
    if dict_shards < 1:
        raise ValueError("dict_shards must be >= 1")
    devs = (_visible_devices() if devices is None
            else [resolve_device(d) for d in devices])
    if dict_shards > 1:
        if len(devs) < dict_shards:
            raise ValueError(
                f"dict_shards={dict_shards} needs at least that many "
                f"devices, have {len(devs)}")
        nd = max(1, min(len(devs) // dict_shards, channels))
    else:
        nd = max(1, min(len(devs), channels))
    grid = tuple(tuple(devs[g * dict_shards:(g + 1) * dict_shards])
                 for g in range(nd))
    padded = -(-channels // nd) * nd
    shard_channels = padded // nd
    quantum = max(1, _QUANTUM_BYTES
                  // (shard_channels * block_size * _ITEMSIZE))
    return EncodePlan(
        grid=grid,
        channels=channels,
        padded_channels=padded,
        shard_channels=shard_channels,
        block_quantum=quantum,
        dict_shards=dict_shards,
    )


def pad_channels(plan: EncodePlan, arr: np.ndarray) -> np.ndarray:
    """Pad the leading channel axis of a host array up to the plan's padded
    channel count (pad rows are masked out of the scan by the caller)."""
    pad = plan.padded_channels - arr.shape[0]
    if pad == 0:
        return arr
    width = [(0, pad)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, width)


def shard_state(plan: EncodePlan, state):
    """Split a batched ``DictState`` with a (padded) leading channel axis
    over the plan's grid: each shard's channels and dictionary rows on its
    device (the carry then stays there across resumable encode calls)."""
    if state.count.shape[0] != plan.padded_channels:
        raise ValueError(
            f"state carries {state.count.shape[0]} channels, plan expects "
            f"{plan.padded_channels} (padded)")
    return split_state(state, plan.grid)
