"""Differentiable rollout factories over the XLA engines (``diff``)."""
