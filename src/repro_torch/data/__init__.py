"""Synthetic telemetry for the paper's traffic (``synthetic``)."""
