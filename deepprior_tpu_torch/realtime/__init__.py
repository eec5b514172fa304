"""Realtime serving: the fused estimator and its micro-batching server."""
