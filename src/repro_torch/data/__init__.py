"""Data substrate: synthetic pipelines, host sharding, prefetch."""

from .pipeline import FastSynthetic, Prefetcher, SyntheticLM, host_slice, make_batches

__all__ = ["FastSynthetic", "Prefetcher", "SyntheticLM", "host_slice", "make_batches"]
