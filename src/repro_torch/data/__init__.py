"""Synthetic telemetry for the paper's traffic (``synthetic``) and the
compressed ingestion path (``pipeline``)."""
