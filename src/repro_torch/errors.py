"""Typed failures of the PyTorch port, under one root.

The port keeps its own copy of the reference package's error hierarchy so it
imports nothing from it.  ``ReproError`` is the root; the typed format and
kernel errors keep ``ValueError`` in their bases, so ``except ValueError``
call sites work unchanged.

Every class carries the protocol mapping a serving front end speaks on the
wire, equal to the reference's letter for letter (it is a wire contract):

* ``code``        -- stable machine-readable error code (snake_case);
* ``http_status`` -- the HTTP status the front end answers with.

``error_payload`` builds the JSON error body; ``ERROR_CODES`` maps codes
back to classes so wire clients can re-raise typed errors.

Stdlib only: importing this module loads no ``torch``.
"""
from __future__ import annotations

from typing import Dict, Optional, Type

__all__ = [
    "ReproError",
    "StreamFormatError",
    "ContainerFormatError",
    "AutotuneCacheError",
    "KernelShapeError",
    "ApiError",
    "AdmissionError",
    "QuotaExceededError",
    "RateLimitedError",
    "OverloadedError",
    "NotFoundError",
    "ERROR_CODES",
    "error_payload",
    "error_from_payload",
]


class ReproError(Exception):
    """Root of every typed failure.  Unknown or unexpected exceptions map
    to the root's ``internal``/500."""

    code: str = "internal"
    http_status: int = 500


class StreamFormatError(ReproError, ValueError):
    """Malformed/truncated IDEALEM stream.  ``offset`` is the byte position
    at which parsing failed (raw ``struct.error``/``IndexError`` from the
    walk are never surfaced to callers)."""

    code = "stream_format"
    http_status = 400

    def __init__(self, message: str, offset: int = 0):
        super().__init__(f"{message} (at byte {offset})")
        self.offset = offset


class ContainerFormatError(ReproError, ValueError):
    """Malformed container: bad magic/version/CRC or inconsistent index."""

    code = "container_format"
    http_status = 400


class AutotuneCacheError(ReproError, ValueError):
    """A persisted autotune cache failed validation (corrupt JSON, wrong
    structure, or a stale ``version`` field)."""

    code = "autotune_cache"
    http_status = 500


class KernelShapeError(ReproError, ValueError):
    """An operand's device, dtype, shape or layout violates a kernel's
    contract.  Raised by the kernel wrappers before any launch, with the
    offending dimensions in the message."""

    code = "kernel_shape"
    http_status = 500


class ApiError(ReproError, ValueError):
    """A request payload failed validation (bad JSON, missing field,
    wrong type) before reaching any service."""

    code = "bad_request"
    http_status = 400


class NotFoundError(ReproError, KeyError):
    """A named resource (stream, store, tenant, route) does not exist."""

    code = "not_found"
    http_status = 404

    def __str__(self) -> str:  # KeyError would repr() the message
        return self.args[0] if self.args else ""


class AdmissionError(ReproError):
    """Base of the typed admission-control rejections (429/503).
    ``retry_after_s``, when known, becomes the protocol's ``retry_after_s``
    field and the ``Retry-After`` header."""

    code = "admission"
    http_status = 429

    def __init__(self, message: str,
                 retry_after_s: Optional[float] = None):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class QuotaExceededError(AdmissionError):
    """A per-tenant quota (streams, stores, staged blocks) is exhausted:
    retrying without closing something is futile."""

    code = "quota_exceeded"
    http_status = 429


class RateLimitedError(AdmissionError):
    """The tenant's bytes/s token bucket is empty; ``retry_after_s`` says
    when enough tokens will have refilled."""

    code = "rate_limited"
    http_status = 429


class OverloadedError(AdmissionError):
    """Global backpressure: the server's staged work exceeds its flush
    pipeline's budget -- a server-health condition, hence 503."""

    code = "overloaded"
    http_status = 503


ERROR_CODES: Dict[str, Type[ReproError]] = {
    cls.code: cls
    for cls in (ReproError, StreamFormatError, ContainerFormatError,
                AutotuneCacheError, KernelShapeError, ApiError,
                NotFoundError, AdmissionError, QuotaExceededError,
                RateLimitedError, OverloadedError)
}


def error_payload(exc: BaseException) -> dict:
    """The protocol error body for an exception: ``{"error": {"code",
    "message", ...}}``.  Non-``ReproError`` exceptions map to the root
    ``internal`` code (the message still travels, the type does not)."""
    code = exc.code if isinstance(exc, ReproError) else ReproError.code
    body = {"code": code, "message": str(exc)}
    retry = getattr(exc, "retry_after_s", None)
    if retry is not None:
        body["retry_after_s"] = float(retry)
    return {"error": body}


def error_from_payload(doc: dict) -> ReproError:
    """Re-raise-able typed error from a protocol error body (the client
    half of :func:`error_payload`); unknown codes become ``ReproError``."""
    body = doc.get("error", doc)
    cls = ERROR_CODES.get(body.get("code", ""), ReproError)
    msg = body.get("message", "")
    if issubclass(cls, AdmissionError):
        return cls(msg, retry_after_s=body.get("retry_after_s"))
    if issubclass(cls, StreamFormatError):
        # the message already carries its "(at byte N)" suffix: build the
        # instance without __init__ so the suffix is not added twice
        err = ReproError.__new__(cls)
        Exception.__init__(err, msg)
        err.offset = 0
        return err
    return cls(msg)
