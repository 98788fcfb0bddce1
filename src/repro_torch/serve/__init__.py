"""Serving of the port: the LM decode engine (``serve.engine``), the
compression services (``serve.compress``) and their stage pipeline
(``serve.pipeline``)."""
from .engine import FlushPolicy, ServeEngine, prefill_step, serve_step
from .compress import (CompressionService, DecompressionService,
                       StreamCoalescer)
from .pipeline import (StageFuture, StagePipeline, SyncExecutor,
                       ThreadStageExecutor)

__all__ = ["FlushPolicy", "ServeEngine", "prefill_step", "serve_step",
           "CompressionService", "DecompressionService", "StreamCoalescer",
           "StageFuture", "StagePipeline", "SyncExecutor",
           "ThreadStageExecutor"]
