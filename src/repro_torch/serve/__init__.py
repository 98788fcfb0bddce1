"""Serving of the port: the LM decode engine (``serve.engine``)."""
from .engine import ServeEngine, prefill_step, serve_step

__all__ = ["ServeEngine", "prefill_step", "serve_step"]
