"""Device entry points (reference core/workflow.py:35-326)."""

from .engine import render_batch

__all__ = ["render_batch"]
