"""Serving engine, micro-batcher and HTTP service."""
