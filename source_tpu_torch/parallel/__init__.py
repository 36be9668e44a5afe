"""Device entry points (reference core/workflow.py:35-326)."""

from .engine import RenderEngine, SerialEngine, render_batch, render_loss_and_grads

__all__ = ["render_batch", "render_loss_and_grads", "RenderEngine",
           "SerialEngine"]
