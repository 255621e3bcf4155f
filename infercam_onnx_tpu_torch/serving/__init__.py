"""Serving tier: TCP ingest, router, micro-batched worker, HTTP MJPEG."""
