"""Exact MIPS retrieval index."""
