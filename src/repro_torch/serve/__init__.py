"""Serving of the port: the LM decode engine (``serve.engine``), the
compression services (``serve.compress``) and their stage pipeline
(``serve.pipeline``), tenancy and admission (``serve.tenancy``), the
control loop (``serve.control``) and the asyncio network front end
(``serve.frontend``)."""
from .engine import FlushPolicy, ServeEngine, prefill_step, serve_step
from .compress import (CompressionService, DecompressionService,
                       StreamCoalescer)
from .pipeline import (StageFuture, StagePipeline, SyncExecutor,
                       ThreadStageExecutor)
from .tenancy import (Tenant, TenantQuota, TenantRegistry, TenantStream,
                      TokenBucket)
from .control import ControlConfig, ControlDecision, ControlLoop
from .frontend import FrontendClient, ServeFrontend

__all__ = ["FlushPolicy", "ServeEngine", "prefill_step", "serve_step",
           "CompressionService", "DecompressionService", "StreamCoalescer",
           "StageFuture", "StagePipeline", "SyncExecutor",
           "ThreadStageExecutor",
           "Tenant", "TenantQuota", "TenantRegistry", "TenantStream",
           "TokenBucket",
           "ControlConfig", "ControlDecision", "ControlLoop",
           "FrontendClient", "ServeFrontend"]
