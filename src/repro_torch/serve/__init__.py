"""Serving the transformer family: ``step`` (prefill and decode entry
points) and ``engine`` (fixed-slot continuous batching)."""
