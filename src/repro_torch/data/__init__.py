"""Synthetic data (``synthetic``: the paper's telemetry, EEG-like noise,
token streams) and the host pipeline (``pipeline``: a prefetching loader,
the compressed ingestion path)."""
