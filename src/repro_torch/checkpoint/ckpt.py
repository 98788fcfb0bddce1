"""Checkpoints: a manifest and one file a leaf, an atomic rename as the
commit point, an asynchronous save, and optional IDEALEM or zstd payload
compression.  The counterpart of ``repro/checkpoint/ckpt.py``, with its
on-disk format.

Layout:  <dir>/step_<N>.tmp/ -> (atomic rename) -> <dir>/step_<N>/
           manifest.json      step, tree structure, each leaf's shape,
                              dtype and codec
           leaf_<i>.bin       raw | zstd | idealem-compressed payload

A half-written checkpoint is never picked up by :func:`latest_step`,
because the rename is the commit point: the crash-consistency contract of
the fault-tolerant trainer (``repro_torch.runtime``).

Leaves are taken in ``jax.tree`` order (``repro_torch.tree``) and copied
to the host before the write.  A bfloat16 leaf, which numpy has no dtype
for, is written as its raw 2-byte words under the dtype name
``"bfloat16"``, as the reference's ``ml_dtypes`` arrays are.  ``zstandard``
is imported only where a zstd leaf is written or read.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ..core import IdealemCodec
from ..tree import tree_leaves, tree_unflatten

__all__ = ["save", "async_save", "latest_step", "restore"]

_CODEC_NONE, _CODEC_ZSTD, _CODEC_IDEALEM = "none", "zstd", "idealem"
_BF16 = "bfloat16"


def _codec() -> IdealemCodec:
    return IdealemCodec(mode="std", block_size=64, num_dict=255, alpha=0.05,
                        rel_tol=0.3, backend="numpy",
                        decode_backend="numpy", device="cpu")


def _zstd():
    import zstandard
    return zstandard


def _host(x, copy: bool) -> Tuple[np.ndarray, str]:
    """A leaf as a host array and its dtype name; ``copy``: never a view
    of the leaf's memory (a device leaf is always copied)."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        t = t.cpu() if t.device.type != "cpu" else t.clone() if copy else t
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), _BF16
        x = t.numpy()
    arr = np.array(x, copy=copy) if copy else np.asarray(x)
    return arr, str(arr.dtype)


def _flatten(tree, copy: bool = False) -> List[Tuple[np.ndarray, str]]:
    return [_host(x, copy) for x in tree_leaves(tree)]


def _structure(tree) -> str:
    """The tree's shape as text, ``*`` for a leaf (the manifest's
    ``treedef``; restore takes the structure from its ``like``)."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        name = type(tree).__name__ if hasattr(tree, "_fields") else ""
        return name + "[" + ", ".join(_structure(v) for v in tree) + "]"
    return "*"


def _encode_leaf(arr: np.ndarray, codec: str) -> Tuple[bytes, str]:
    raw = arr.tobytes()
    if codec == _CODEC_ZSTD:
        return _zstd().ZstdCompressor(level=3).compress(raw), _CODEC_ZSTD
    if codec == _CODEC_IDEALEM and arr.dtype in (np.float32, np.float64) \
            and arr.size >= 4096:
        blob = _codec().encode(arr.reshape(-1).astype(np.float64))
        if len(blob) < len(raw):
            return blob, _CODEC_IDEALEM
        return _zstd().ZstdCompressor(level=3).compress(raw), _CODEC_ZSTD
    return raw, _CODEC_NONE


def _decode_leaf(data: bytes, codec: str, shape, dtype: str) -> np.ndarray:
    np_dtype = np.int16 if dtype == _BF16 else np.dtype(dtype)
    if codec == _CODEC_ZSTD:
        data = _zstd().ZstdDecompressor().decompress(data)
    if codec == _CODEC_IDEALEM:
        return _codec().decode(data).astype(np_dtype).reshape(shape)
    return np.frombuffer(data, dtype=np_dtype).reshape(shape).copy()


def _write(path: str, step: int, leaves, structure: str,
           codec: str) -> str:
    final = os.path.join(path, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "treedef": structure, "leaves": []}
    for i, (arr, dtype) in enumerate(leaves):
        blob, used = _encode_leaf(arr, codec)
        with open(os.path.join(tmp, f"leaf_{i}.bin"), "wb") as f:
            f.write(blob)
        manifest["leaves"].append(
            {"shape": list(arr.shape), "dtype": dtype, "codec": used})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # commit point
    return final


def save(path: str, step: int, tree: Any, codec: str = _CODEC_NONE) -> str:
    """Write a checkpoint of ``tree`` atomically; returns its directory."""
    return _write(path, step, _flatten(tree), _structure(tree), codec)


def async_save(path: str, step: int, tree: Any,
               codec: str = _CODEC_NONE) -> threading.Thread:
    """Copy the leaves to the host now, write them on a background thread
    (returned, started)."""
    leaves = _flatten(tree, copy=True)  # the snapshot is taken here
    t = threading.Thread(target=_write,
                         args=(path, step, leaves, _structure(tree), codec))
    t.start()
    return t


def latest_step(path: str) -> Optional[int]:
    """The newest committed step under ``path`` (``.tmp`` directories are
    not committed), or None."""
    if not os.path.isdir(path):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(path)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def restore(path: str, step: int, like: Any) -> Any:
    """The checkpoint of ``step`` in the structure of ``like``: a leaf that
    is a tensor there comes back as a tensor of the saved dtype on that
    leaf's device, any other as a numpy array.  Raises ``ValueError`` when
    the leaf count or a shape differs."""
    d = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    like_leaves = tree_leaves(like)
    if len(like_leaves) != len(manifest["leaves"]):
        raise ValueError(f"tree structure mismatch: {len(like_leaves)} "
                         f"leaves, {len(manifest['leaves'])} saved")
    out = []
    for i, (ref, meta) in enumerate(zip(like_leaves, manifest["leaves"])):
        with open(os.path.join(d, f"leaf_{i}.bin"), "rb") as f:
            data = f.read()
        arr = _decode_leaf(data, meta["codec"], meta["shape"], meta["dtype"])
        if tuple(arr.shape) != tuple(np.shape(ref)):
            raise ValueError(f"leaf {i}: {arr.shape} vs {np.shape(ref)}")
        if isinstance(ref, torch.Tensor):
            t = torch.from_numpy(arr)
            if meta["dtype"] == _BF16:
                t = t.view(torch.bfloat16)
            arr = t.to(ref.device)
        out.append(arr)
    return tree_unflatten(like, out)
