"""Serving observability: metrics, latency sketches, events, request traces."""
