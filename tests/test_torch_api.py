"""The wire API, the error hierarchy, the quality measures and the package
facade of the PyTorch port vs the JAX reference, on the CPU.

Error codes, HTTP statuses and payloads are a wire contract: equal to the
reference's letter for letter, and readable across the two packages in
both directions.  ``CodecConfig`` equals the reference's on every knob but
the backend names.  Tolerance: none (values equal).
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import golden_signal  # noqa: E402
from repro import api as jax_api  # noqa: E402
from repro import errors as jax_errors  # noqa: E402
from repro.core import metrics as jax_metrics  # noqa: E402
from repro_torch import api, errors  # noqa: E402
from repro_torch.core import IdealemCodec  # noqa: E402
from repro_torch.core import metrics  # noqa: E402
from repro_torch.errors import (ERROR_CODES, AdmissionError, ApiError,  # noqa: E402
                                ReproError, StreamFormatError,
                                error_from_payload, error_payload)

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
BACKEND_KNOBS = ("backend", "decode_backend")


# ------------------------------------------------------------ wire types
def _wire_objects(mod):
    return [
        mod.CompressRequest("s0", np.arange(7, dtype=np.float64)),
        mod.CompressRequest("s1", np.arange(4, dtype=np.float16)),
        mod.FeedResult("s", b"\x00\xff", blocks=3, hits=2, bytes_in=96,
                       bytes_out=5, final=True),
        mod.DecodeRangeRequest("st", 2, 9, channel=1, request_id="r1"),
        mod.RangeResult("r1", np.linspace(0, 1, 9)),
    ]


def _fields(obj):
    return {k: (v.tobytes(), v.dtype.str) if isinstance(v, np.ndarray)
            else v for k, v in vars(obj).items()}


@pytest.mark.parametrize("i", range(5))
def test_wire_types_round_trip_across_packages(i):
    port, ref = _wire_objects(api)[i], _wire_objects(jax_api)[i]
    assert port.to_json() == ref.to_json()
    cls, ref_cls = type(port), type(ref)
    assert _fields(cls.from_json(port.to_json())) == _fields(port)
    assert _fields(cls.from_json(ref.to_json())) == \
        _fields(ref_cls.from_json(port.to_json()))


@pytest.mark.parametrize("doc", [
    None, [], {"stream_id": "s"},
    {"stream_id": 3, "samples": {"dtype": "<f8", "b64": ""}},
    {"stream_id": "s", "samples": {"dtype": "<f8", "b64": "!!"}},
    {"stream_id": "s", "samples": {"dtype": "<f8", "b64": "AAAA"}},
    {"stream_id": "s", "samples": {"dtype": "<f8", "b64": ""}, "x": 1},
])
def test_wire_types_reject_malformed(doc):
    with pytest.raises(ApiError):
        api.CompressRequest.from_json(doc)
    with pytest.raises(jax_errors.ApiError):
        jax_api.CompressRequest.from_json(doc)


def test_wire_type_validation():
    for bad in (lambda: api.CompressRequest("s", np.zeros((2, 2))),
                lambda: api.DecodeRangeRequest("st", 5, 5),
                lambda: api.DecodeRangeRequest("st", -1, 4)):
        with pytest.raises(ApiError):
            bad()


# ------------------------------------------------------------ codec config
CONFIGS = [
    dict(),
    dict(mode="delta", num_dict=7),
    dict(mode="residual", block_size=16, num_dict=31, alpha=0.05,
         rel_tol=0.5, value_range=(0.0, 360.0)),
    dict(mode="std", use_minmax=False, max_count=9, decode_seed=3,
         error_bound=0.25, matcher="fused"),
    dict(adaptive=True, use_ks=False),
]


@pytest.mark.parametrize("kw", CONFIGS)
def test_codec_config_equals_reference_but_backends(kw):
    cfg = api.CodecConfig(backend="numpy", **kw)
    ref = jax_api.CodecConfig(backend="numpy", decode_backend="numpy", **kw)
    assert api.CodecConfig.from_json(cfg.to_json()) == cfg
    strip = {k: v for k, v in cfg.kwargs().items() if k not in BACKEND_KNOBS}
    assert strip == {k: v for k, v in ref.kwargs().items()
                     if k not in BACKEND_KNOBS}
    # a reference document without backend names reads the same knobs
    doc = {k: v for k, v in ref.to_json().items() if k not in BACKEND_KNOBS}
    assert api.CodecConfig.from_json(doc) == api.CodecConfig(**kw)
    assert api.CodecConfig().backend == api.CodecConfig().decode_backend \
        == "cuda"


@pytest.mark.parametrize("doc", [
    {"backend": "jax"}, {"backend": "pallas"}, {"decode_backend": "jax"},
    {"decode_backend": "pallas"}])
def test_codec_config_rejects_reference_backend_names(doc):
    with pytest.raises(ApiError, match="numpy', 'torch', 'cuda'") as e:
        api.CodecConfig.from_json(doc)
    assert str(e.value).count("CodecConfig") == 1


def test_codec_config_validation_and_hash():
    assert api.CodecConfig.from_json(None) == api.CodecConfig()
    for bad in ({"no_such_knob": 1}, {"value_range": [1.0]}, "cfg",
                {"block_size": 16, "device": "cpu"}):
        with pytest.raises(ApiError):
            api.CodecConfig.from_json(bad)
    a = api.CodecConfig(mode="std", value_range=(0, 1))
    b = api.CodecConfig(mode="std", value_range=(0.0, 1.0))
    assert a == b and hash(a) == hash(b)


@pytest.mark.parametrize("backend", ["numpy", "torch", "cuda"])
def test_from_config_encodes_the_same_bytes(backend):
    cfg = api.CodecConfig(mode="residual", block_size=16, num_dict=31,
                          alpha=0.05, rel_tol=0.5, backend=backend,
                          value_range=(0.0, 360.0))
    codec = IdealemCodec.from_config(cfg, device="cpu")
    assert codec.config == cfg
    assert IdealemCodec.from_config(cfg.to_json(), device="cpu").config \
        == cfg
    x = golden_signal("residual_D32_vr")
    blob = codec.encode(x)
    assert blob == IdealemCodec(device="cpu", **cfg.kwargs()).encode(x)
    assert IdealemCodec.from_config(codec.config,
                                    device="cpu").encode(x) == blob


def test_config_carries_the_resolved_error_bound():
    codec = IdealemCodec(mode="std", block_size=16, backend="numpy",
                         device="cpu", value_range=(0.0, 8.0),
                         error_bound_rel=0.125)
    assert codec.config.error_bound == 1.0
    again = IdealemCodec.from_config(codec.config, device="cpu")
    assert again.config == codec.config
    assert again.error_bound == codec.error_bound


# ------------------------------------------------------------ errors
def test_error_codes_and_statuses_equal_reference():
    assert set(ERROR_CODES) == set(jax_errors.ERROR_CODES)
    for code, cls in ERROR_CODES.items():
        ref = jax_errors.ERROR_CODES[code]
        assert cls.__name__ == ref.__name__
        assert (cls.code, cls.http_status) == (ref.code, ref.http_status)
        assert issubclass(cls, ReproError)
        assert [b.__name__ for b in cls.__mro__] == \
            [b.__name__ for b in ref.__mro__]
    assert sorted(errors.__all__) == sorted(jax_errors.__all__)


def test_typed_errors_are_one_object_across_the_port():
    from repro_torch.core.stream import StreamFormatError as via_stream
    from repro_torch.core.tuning import AutotuneCacheError as via_tuning
    from repro_torch.store import ContainerFormatError as via_store
    assert via_stream is StreamFormatError
    assert via_tuning is errors.AutotuneCacheError
    assert via_store is errors.ContainerFormatError
    for cls in (StreamFormatError, errors.ContainerFormatError,
                errors.KernelShapeError, errors.AutotuneCacheError, ApiError):
        assert issubclass(cls, ValueError)
    assert issubclass(errors.NotFoundError, KeyError)
    assert str(errors.NotFoundError("no store 's'")) == "no store 's'"


def _instances(mod):
    return [
        mod.ReproError("boom"),
        mod.StreamFormatError("bad tag", offset=17),
        mod.ContainerFormatError("index CRC mismatch"),
        mod.AutotuneCacheError("stale"),
        mod.KernelShapeError("n=7"),
        mod.ApiError("missing field"),
        mod.NotFoundError("no stream 'x'"),
        mod.AdmissionError("later", retry_after_s=2),
        mod.QuotaExceededError("too many streams"),
        mod.RateLimitedError("slow down", retry_after_s=1.5),
        mod.OverloadedError("drain", retry_after_s=0.25),
        KeyError("plain"),
    ]


@pytest.mark.parametrize("i", range(12))
def test_error_payloads_cross_read(i):
    """A port payload read by the reference, and the other way round, gives
    the same class name, message and ``retry_after_s``; an untyped
    exception travels as the root ``internal`` code."""
    port, ref = _instances(errors)[i], _instances(jax_errors)[i]
    assert error_payload(port) == jax_errors.error_payload(ref)
    for made, back in (
            (port, jax_errors.error_from_payload(error_payload(port))),
            (ref, error_from_payload(jax_errors.error_payload(ref)))):
        typed = hasattr(made, "code")
        assert type(back).__name__ == (type(made).__name__ if typed
                                       else "ReproError")
        assert str(back) == str(made)
        assert getattr(back, "retry_after_s", None) == \
            getattr(made, "retry_after_s", None)


def test_unknown_codes_fall_back_to_the_root():
    odd = error_from_payload({"error": {"code": "???", "message": "m"}})
    assert type(odd) is ReproError and str(odd) == "m"
    assert isinstance(error_from_payload(
        {"code": "rate_limited", "message": "m"}), AdmissionError)


# ------------------------------------------------------------ quality
@pytest.mark.parametrize("name", ["std_D32", "delta_D1_vr", "std_D8_f16"])
def test_quality_measures_equal_reference(name):
    x = golden_signal(name)
    y = x[::-1].copy()
    assert metrics.quality_measures(x) == jax_metrics.quality_measures(x)
    assert metrics.spectral_band_error(x, y) == \
        jax_metrics.spectral_band_error(x, y)
    np.testing.assert_array_equal(metrics.peaks(x), jax_metrics.peaks(x))
    assert metrics.quality_measures(np.zeros(0))["m1_num_peaks"] == 0.0


# ------------------------------------------------------------ imports
def test_wire_modules_load_without_torch():
    code = ("import sys, repro_torch, repro_torch.api, repro_torch.errors, "
            "repro_torch.obs\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'repro')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_facade_exports_curated_names():
    import repro_torch
    for name in ("CodecConfig", "CompressRequest", "FeedResult",
                 "DecodeRangeRequest", "RangeResult", "IdealemCodec",
                 "IdealemSession", "ReproError", "QuotaExceededError",
                 "ContainerFormatError", "Container", "ContainerWriter",
                 "pack", "decode_range", "decode_ranges", "decode_channels",
                 "DictState", "decode_stream", "api", "errors", "store",
                 "obs"):
        assert name in repro_torch.__all__
        assert getattr(repro_torch, name) is not None
    assert repro_torch.ReproError is ReproError
    assert repro_torch.api is api
    assert sorted(dir(repro_torch)) == sorted(set(dir(repro_torch)))
    with pytest.raises(AttributeError):
        repro_torch.no_such_symbol
