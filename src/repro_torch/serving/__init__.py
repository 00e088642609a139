"""Serving of the port: iteration-level continuous batching."""
