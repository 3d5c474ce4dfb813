"""Deterministic synthetic token stream and its background prefetcher.
Counterpart of ``repro.data``."""

from .pipeline import DataPipeline, SyntheticLMSource  # noqa: F401
