"""Readers of the per-layer metrics, one a metric (loaded by name)."""
