"""Device entry points (reference core/workflow.py:35-326)."""

from .engine import render_batch, render_loss_and_grads

__all__ = ["render_batch", "render_loss_and_grads"]
